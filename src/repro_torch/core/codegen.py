"""ExecutionPlan -> executable (paper §IV back half) — the port's copy of
``repro.core.codegen`` for one card.

Two backends of the reference run here:

  'xla'     — the recurrence's plain PyTorch version (``kernels/ref.py``
              by way of the registry).
  'pallas'  — the plan through ``kernels/runtime.execute_plan``: the
              hand-written Hopper kernel at the compiled tile the plan
              maps onto (the plain version when the operands lie on the
              CPU).

A ``FusedPlan`` lowers through ``fusion.lower_fused``.  The chip-level
schedules (``systolic``, ``allgather``) are the multi-device work of
ROADMAP A12 and raise ``NotImplementedError``; so do hierarchical
targets, already at planning (``mapper.best_plan``).  An
unregistered recurrence raises ``registry.UnregisteredRecurrenceError``
from either backend.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from .mapper import ExecutionPlan


def lower_plan(plan: ExecutionPlan, backend: str = "xla") -> Callable:
    """The executable of ``plan`` on ``backend`` (module docstring)."""
    from . import fusion
    from repro_torch.kernels import registry, runtime

    if isinstance(plan, fusion.FusedPlan):
        return fusion.lower_fused(plan, backend=backend)
    if backend in ("systolic", "allgather"):
        raise NotImplementedError(
            f"the {backend} backend is multi-device work the port has not "
            "done yet (ROADMAP A12)")
    spec = registry.get(plan.recurrence.name)
    if backend == "xla":
        return spec.ref
    if backend == "pallas":
        if plan.backend != "pallas":
            plan = dataclasses.replace(plan, backend="pallas")
        return functools.partial(runtime.execute_plan, plan)
    raise ValueError(f"unknown backend {backend}")
