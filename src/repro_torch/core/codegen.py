"""ExecutionPlan -> executable (paper §IV back half) — the port's copy of
``repro.core.codegen`` for one card.

The reference's four backends:

  'xla'      — the recurrence's plain PyTorch version (``kernels/ref.py``
               by way of the registry).
  'pallas'   — the plan through ``kernels/runtime.execute_plan``: the
               hand-written Hopper kernel at the compiled tile the plan
               maps onto (the plain version when the operands lie on the
               CPU).
  'systolic' — the chip-level schedule on ``mesh`` (a
               ``parallel.mesh.Mesh`` named by the plan target's axes):
               Cannon rings, the complex two-plane ring, width-k halo
               exchange, 1-D chains and the mttkrp ring
               (``kernels/systolic.py``), each member's compute on the
               hand kernels.
  'allgather'— the all-gather / broadcast baseline the systolic
               schedules are measured against, on the same mesh.

The chip-level backends dispatch through the spec's
``systolic_lowering`` / ``allgather_lowering`` hooks; a spec without
the hook raises ``NotImplementedError``.  A ``FusedPlan`` lowers through
``fusion.lower_fused`` and a ``HierarchicalPlan`` through
``hierarchy.lower_hierarchical`` (the outer split composed by the
caller, each group on this module's lowering of the inner plan; the chip
backends give each group a device block of its own, so ``mesh`` is
ignored there).  An unregistered recurrence raises
``registry.UnregisteredRecurrenceError`` from any backend.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from .mapper import ExecutionPlan


def lower_plan(plan: ExecutionPlan, backend: str = "xla",
               mesh=None) -> Callable:
    """The executable of ``plan`` on ``backend`` (module docstring)."""
    from . import fusion, hierarchy
    from repro_torch.kernels import registry, runtime

    if isinstance(plan, hierarchy.HierarchicalPlan):
        return hierarchy.lower_hierarchical(plan, backend=backend)
    if isinstance(plan, fusion.FusedPlan):
        return fusion.lower_fused(plan, backend=backend, mesh=mesh)
    spec = registry.get(plan.recurrence.name)
    if backend == "xla":
        return spec.ref
    if backend == "pallas":
        if plan.backend != "pallas":
            plan = dataclasses.replace(plan, backend="pallas")
        return functools.partial(runtime.execute_plan, plan)
    if backend in ("systolic", "allgather"):
        if mesh is None:
            raise ValueError(f"the {backend} backend needs a mesh (pass "
                             "mesh=)")
        hook = (spec.systolic_lowering if backend == "systolic"
                else spec.allgather_lowering)
        if hook is None:
            raise NotImplementedError(
                f"{backend} backend: recurrence {spec.name!r} registers no "
                f"{backend} lowering hook (supports_systolic="
                f"{spec.supports_systolic})")
        return hook(plan, mesh)
    raise ValueError(f"unknown backend {backend}")
