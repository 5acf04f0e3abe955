"""The port's copy of the WideSA planner (reference: ``repro.core``).

    recurrence.py  — uniform-recurrence IR + the mm / bmm builders
    spacetime.py   — space-time transformation (space/time loop selection)
    partition.py   — array partition + latency hiding + multiple threading
    plio.py        — mapped graph, congestion model, Algorithm 1
    mapper.py      — search + cost model -> ExecutionPlan
    autotune.py    — PlanPolicy / PlanRequest / memoized resolve

The code is pure Python and copied rather than imported, so the port never
loads JAX; the tests hold its plans equal to the reference planner's.
"""

from .autotune import PlanPolicy, PlanRequest, resolve
from .mapper import ExecutionPlan, Target, best_plan, map_recurrence
from .recurrence import batched_matmul, matmul

__all__ = [
    "PlanPolicy", "PlanRequest", "resolve",
    "ExecutionPlan", "Target", "best_plan", "map_recurrence",
    "batched_matmul", "matmul",
]
