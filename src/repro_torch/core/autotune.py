"""Plan policy and the one memoized plan-lookup path.

The port's counterpart of ``repro.core.autotune``, reduced to what the
serving path runs: ``PlanPolicy``, ``PlanRequest``, ``resolve`` and the
observability ``counters``.  The reference's measured crossover table
holds winners timed for its own backends, so the port does not read it;
the only policy here is ``modelled`` (the mapper's ranking, every plan
stamped ``pallas``).  A table measured on the H100 is later work; until
it exists the reference's ``cached``/``measured`` modes are refused when
a ``PlanPolicy`` is made.
"""

from __future__ import annotations

import dataclasses
import functools

from .mapper import ExecutionPlan, Target

MODES = ("modelled",)


@dataclasses.dataclass(frozen=True)
class PlanPolicy:
    """How ``best_plan`` picks a backend.  Only ``modelled`` exists in the
    port; the other reference modes name a table this device does not
    have yet."""

    mode: str = "modelled"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"PlanPolicy.mode must be one of {MODES} in the port (no "
                f"crossover table is measured on this device), got "
                f"{self.mode!r}")


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One shape-keyed planning request: ``kind`` names a registered
    KernelSpec, ``shape`` holds that spec's builder arguments."""

    kind: str
    shape: tuple
    dtype: str
    target: Target
    policy: PlanPolicy = PlanPolicy()


_COUNTERS = {"hits": 0, "misses": 0, "measure_calls": 0, "table_errors": 0}


def counters() -> dict[str, int]:
    """Crossover-table traffic, kept for parity with the reference
    surface.  The modelled policy never reads a table, so every counter
    stays 0 in the port."""
    return dict(_COUNTERS)


@functools.lru_cache(maxsize=4096)
def resolve(req: PlanRequest) -> ExecutionPlan | None:
    """Best *feasible* plan for a request, or None (the caller falls
    back).  Memoized per request; the None outcome of an infeasible shape
    is cached too, so it never re-runs the mapper search.  A plan kind the
    port has not ported (``NotImplementedError`` from ``best_plan``)
    raises rather than reading as infeasible."""
    if any(d <= 0 for d in req.shape):
        return None
    from repro_torch.kernels import registry  # late: kernels import core
    from .mapper import best_plan

    try:
        rec = registry.get(req.kind).builder(*req.shape, req.dtype)
    except (registry.UnregisteredRecurrenceError, TypeError):
        return None
    try:
        plan = best_plan(rec, req.target, policy=req.policy)
    except NotImplementedError:
        raise
    except RuntimeError:
        return None
    return plan if plan.feasible else None
