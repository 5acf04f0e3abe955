"""The port's copy of the WideSA planner (reference: ``repro.core``).

    recurrence.py  — uniform-recurrence IR + every builder of the reference
                     (mm, bmm, fir, conv2d, fft2d_stage, the jacobi2d
                     stencils, mttkrp) and the paper's Table II sizes
    spacetime.py   — space-time transformation (space/time loop selection)
    partition.py   — array partition + latency hiding + multiple threading
    plio.py        — mapped graph, congestion model, Algorithm 1
    mapper.py      — search + cost model -> ExecutionPlan
    autotune.py    — PlanPolicy / PlanRequest / memoized resolve
    fusion.py      — producer->consumer chains (mm+mm, fft2d stage pairs,
                     conv2d / stencil halo chains)
    codegen.py     — ExecutionPlan -> executable (xla / pallas backends)

The code is pure Python and copied rather than imported, so the port never
loads JAX; the tests hold its plans equal to the reference planner's.
"""

from .autotune import PlanPolicy, PlanRequest, resolve
from .codegen import lower_plan
from .mapper import (AIE_TARGET, ExecutionPlan, Target, best_plan,
                     map_recurrence, predict_bounds)
from .partition import Partition, partition_schedule
from .plio import (MappedGraph, assign_plios, build_mapped_graph, congestion,
                   is_feasible, naive_assignment)
from .recurrence import (PAPER_BENCHMARKS, Access, Dependence,
                         UniformRecurrence, batched_matmul, conv2d,
                         fft2d_stage, fir, jacobi2d, jacobi2d_9pt,
                         jacobi2d_multisweep, matmul, mttkrp)
from .spacetime import SystolicSchedule, enumerate_schedules

__all__ = [
    "PlanPolicy", "PlanRequest", "resolve", "lower_plan",
    "AIE_TARGET", "ExecutionPlan", "Target", "best_plan", "map_recurrence",
    "predict_bounds",
    "Partition", "partition_schedule",
    "MappedGraph", "assign_plios", "build_mapped_graph", "congestion",
    "is_feasible", "naive_assignment",
    "PAPER_BENCHMARKS", "Access", "Dependence", "UniformRecurrence",
    "batched_matmul", "conv2d", "fft2d_stage", "fir", "jacobi2d",
    "jacobi2d_9pt", "jacobi2d_multisweep", "matmul", "mttkrp",
    "SystolicSchedule", "enumerate_schedules",
]
