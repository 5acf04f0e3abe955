"""End-to-end WideSA mapper (paper §III + §IV front half) — the port's
copy of ``repro.core.mapper``, with the same search and ranking.

    recurrence --enumerate--> schedules --partition--> tilings
               --graph/PLIO--> feasibility + congestion
               --rank--> ExecutionPlan

The ExecutionPlan is the contract with codegen: it pins the space/time
mapping, the chip-array fold, the Pallas block shapes, the PLIO/axis
assignment and the predicted roofline of the mapping.  Plans are
deterministic for a given (recurrence, target) — the framework memoizes
them in an LRU cache keyed on (recurrence, target, ports_per_edge);
see ``plan_cache_info``/``plan_cache_clear``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math

from . import partition as part
from .partition import Partition, partition_schedule, DTYPE_BYTES, PACKING
from .plio import (AxisAssignment, assign_collective_axes, assign_plios,
                   build_mapped_graph, congestion)
from .recurrence import UniformRecurrence
from .spacetime import SystolicSchedule, enumerate_schedules


@dataclasses.dataclass(frozen=True)
class Target:
    """Physical target description.

    ``mesh_shape``/``mesh_axes``: chip-level array (e.g. (16,16), (data,model)).
    ``rc``: routing capacity per column boundary (paper's RC) — for the AIE
    geometry this is NoC streams; for TPU it is modelled link budget.
    ``peak_macs``: per-PE int8 MACs/cycle (packing ladder scales other dtypes).
    ``freq_ghz``: PE clock.

    Three-level memory hierarchy (paper Fig. 6: throughput binds on PLIO
    count and PL-buffer size):
      ``local_bytes``      per-PE scratch (AIE local mem / TPU VMEM); if the
                           whole problem is PE-resident the edge is unbound;
      ``pl_buffer_bytes``  staging buffer behind the array edge (PL BRAM /
                           pooled HBM); fits -> ``edge_gbps`` (PLIO) binds;
      otherwise the DRAM boundary ``dram_gbps`` binds as well.
    """

    name: str = "tpu_v5e_pod"
    mesh_shape: tuple[int, ...] = (16, 16)
    mesh_axes: tuple[str, ...] = ("data", "model")
    rc: int = 8
    ports_per_col: int = 2
    peak_macs: int = 128 * 128 * 8  # int8 MACs/cycle (394 TOPS @1.5 GHz)
    freq_ghz: float = 1.5
    local_bytes: int = 16 * 2**20            # VMEM working set per chip
    pl_buffer_bytes: int = 256 * 16 * 2**30  # pooled HBM of a 16x16 pod
    edge_gbps: float = 819.0 * 256           # aggregate HBM bandwidth
    dram_gbps: float = 819.0 * 256
    packing: str = "tpu"

    @property
    def n_pes(self) -> int:
        return int(math.prod(self.mesh_shape))


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Everything the kernel runtime needs, plus the model-predicted
    performance.

    ``backend``/``provenance`` record the backend decision: the mapper
    emits ``("pallas", "modelled")``, which the port's runtime executes on
    its hand-written Hopper kernel; an ``"xla"`` stamp runs the plain
    PyTorch reference instead (``kernels/runtime.execute_plan``).
    """

    recurrence: UniformRecurrence
    schedule: SystolicSchedule
    partition: Partition
    plio_assignment: dict
    congestion_west: tuple[int, ...]
    congestion_east: tuple[int, ...]
    axis_assignment: AxisAssignment
    target: Target
    predicted_tops: float
    predicted_utilization: float
    feasible: bool
    backend: str = "pallas"
    provenance: str = "modelled"

    def describe(self) -> str:
        return (
            f"[{self.recurrence.name}/{self.recurrence.dtype}] "
            f"{self.schedule.describe()} | {self.partition.describe()} | "
            f"pred={self.predicted_tops:.2f}TOPS util={self.predicted_utilization:.1%} "
            f"feasible={self.feasible} maxCong=({max(self.congestion_west)},"
            f"{max(self.congestion_east)}) backend={self.backend}"
            f"[{self.provenance}]"
        )


def _total_operand_bytes(rec: UniformRecurrence) -> int:
    total = 0
    for a in rec.accesses:
        size = DTYPE_BYTES.get(rec.dtype, 4)
        for l, _ in a.index:
            if l is not None:
                size *= rec.extent(l)
        total += size
    return total


def _predict_tops(
    rec: UniformRecurrence, p: Partition, target: Target
) -> float:
    """Roofline-style throughput prediction used for ranking.

    compute: PEs * macs/cycle * packing * 2 ops/mac * freq, scaled by array
    utilization.  Memory: three-level hierarchy (Target docstring) — the
    binding edge depends on where the working set is resident.  This is an
    upper bound by construction, in the target's own units (the default
    target models a TPU pod, as in the reference planner).
    """
    ladder = part.PACKING_TPU if target.packing == "tpu" else PACKING
    packing = ladder.get(rec.dtype, 1.0)
    comp_tops = (
        target.n_pes * target.peak_macs * packing * 2 * target.freq_ghz / 1e3
    ) * p.utilization

    total_bytes = _total_operand_bytes(rec)
    if total_bytes <= target.n_pes * target.local_bytes:
        mem_tops = float("inf")  # PE-resident: edge never crossed steadily
    elif p.edge_bytes_per_op > 0:
        mem_tops = (target.edge_gbps / p.edge_bytes_per_op) / 1e3
    else:
        mem_tops = float("inf")
    return min(comp_tops, mem_tops)


def map_recurrence(
    rec: UniformRecurrence,
    target: Target = Target(),
    top_k: int = 5,
    ports_per_edge: int = 4,
) -> list[ExecutionPlan]:
    """Run the full WideSA pipeline and return ranked feasible plans.

    Results are memoized: the search is deterministic for a given
    (recurrence, target) and both are frozen/hashable, so repeat mappings
    (model layers re-planning the same matmul, benchmark loops, serving)
    hit the LRU cache instead of re-running schedule enumeration + PLIO
    assignment.  Plans contain mutable dicts (partition.block,
    plio_assignment, axis loads), so each call returns deep copies — a
    caller tweaking a plan can never corrupt the cache for everyone else.
    """
    # top_k only slices the ranked result, so it stays OUT of the cache key
    # — different top_k values share one search.
    ranked = _map_recurrence_cached(rec, target, ports_per_edge)
    return copy.deepcopy(list(ranked[:top_k]))


@functools.lru_cache(maxsize=256)
def _map_recurrence_cached(
    rec: UniformRecurrence,
    target: Target,
    ports_per_edge: int,
) -> tuple[ExecutionPlan, ...]:
    plans: list[ExecutionPlan] = []
    for sched in enumerate_schedules(rec):
        parts = partition_schedule(
            rec, sched, target.mesh_shape,
            local_bytes=target.local_bytes)
        for p in parts[:3]:  # top tilings per schedule
            # Algorithm 1 with escalating packet-switch sharing (paper
            # Fig. 4): if port slots run out OR congestion exceeds RC,
            # merge more streams per PLIO and retry before giving up.
            phys = (tuple(target.mesh_shape[:2])
                    if len(target.mesh_shape) >= 2
                    else (1, target.mesh_shape[0]))
            graph = assignment = None
            feasible = False
            west = east = [0]
            for ppc_mult in (1, 4, 16, 64):
                # >1 over-subscribes physical PLIO channels per column —
                # such assignments are kept as a fallback but marked
                # infeasible (the paper would reject the design)
                for ppe in (ports_per_edge, 2 * ports_per_edge,
                            4 * ports_per_edge, 16 * ports_per_edge):
                    graph = build_mapped_graph(
                        rec, sched, p.array_tiles,
                        ports_per_edge=ppe, phys_shape=phys)
                    try:
                        assignment = assign_plios(
                            graph,
                            ports_per_col=target.ports_per_col * ppc_mult)
                    except RuntimeError:
                        continue
                    west, east = congestion(graph, assignment)
                    feasible = (max(west) <= target.rc
                                and max(east) <= target.rc
                                and ppc_mult == 1)
                    if feasible:
                        break
                if assignment is not None:
                    break
            if assignment is None:
                continue
            axes = assign_collective_axes(
                rec,
                sched,
                target.mesh_axes,
                target.mesh_shape,
                DTYPE_BYTES.get(rec.dtype, 4),
            )
            tops = _predict_tops(rec, p, target)
            plans.append(
                ExecutionPlan(
                    recurrence=rec,
                    schedule=sched,
                    partition=p,
                    plio_assignment=assignment,
                    congestion_west=tuple(west),
                    congestion_east=tuple(east),
                    axis_assignment=axes,
                    target=target,
                    predicted_tops=tops,
                    predicted_utilization=p.utilization,
                    feasible=feasible,
                )
            )
    plans.sort(
        key=lambda pl: (
            -int(pl.feasible),
            # utilization first (the paper's objective), but rounded so that
            # fold-waste noise in the 3rd decimal doesn't override the
            # throughput model; ties resolve to the faster (higher-reuse,
            # typically 2-D) design.
            -round(pl.predicted_utilization, 2),
            -pl.predicted_tops,
            -pl.schedule.ndim,
        )
    )
    return tuple(plans)


#: Introspection over the plan cache (functools.lru_cache CacheInfo).
plan_cache_info = _map_recurrence_cached.cache_info
plan_cache_clear = _map_recurrence_cached.cache_clear


def best_plan(rec: UniformRecurrence, target: Target = Target(),
              policy=None) -> ExecutionPlan:
    """The single planning entrypoint: the modelled mapping, stamped
    ``("pallas", "modelled")`` — the port runs a ``pallas`` stamp on its
    hand-written Hopper kernel.

    ``policy`` is a ``core.autotune.PlanPolicy`` (or None); its only
    mode in the port is modelled.  Fused chains and
    hierarchical targets (the reference's ``fusion``/``hierarchy``
    planners) are not ported yet and raise ``NotImplementedError``.
    """
    if hasattr(rec, "stages"):
        raise NotImplementedError(
            "fused recurrence chains are not planned by the port yet")
    if getattr(target, "outer_shape", None) is not None:
        raise NotImplementedError(
            "hierarchical targets are not planned by the port yet")
    # top_k=1: a cache hit copies one plan, not the default five
    plans = map_recurrence(rec, target, top_k=1)
    if not plans:
        raise RuntimeError(f"no feasible mapping for {rec.name}")
    return plans[0]
