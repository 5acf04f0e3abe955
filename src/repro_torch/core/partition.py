"""Array partition, latency hiding, multiple threading (paper §III-B2..4)
— the port's copy of ``repro.core.partition``, unchanged so plans match.

Chooses the paper's tiling-factor hierarchy for a given systolic schedule and
physical target:

  (N1, M1, [K1])  array partition   — fold the logical space array onto the
                                      physical array (chip mesh axes here);
  (N0, M0, K0)    kernel scope      — per-PE tile = Pallas block shapes,
                                      constrained to fit VMEM and align with
                                      the MXU (128 lanes x 8 sublanes);
  (N2, M2)        latency hiding    — accumulator sub-tiles kept live in the
                                      fp32/int32 VMEM scratch so the carried
                                      accumulation never stalls the MXU;
  K2              multiple threading— split a dependence-free (reduction)
                                      time loop across a mesh axis, combined
                                      with a reduce at the end.

The cost model mirrors the paper's goals: maximize array utilization first
(the title!), then minimize edge (PLIO-analogue) traffic per computed point.
"""

from __future__ import annotations

import dataclasses
import math

from .recurrence import UniformRecurrence
from .spacetime import SystolicSchedule

# --- TPU target constants (v5e; see DESIGN.md §7) -------------------------
MXU_LANES = 128          # systolic array edge
SUBLANES = 8             # second-minor tiling for fp32
VMEM_BYTES = 16 * 2**20  # usable VMEM budget for kernel working set
DTYPE_BYTES = {
    "float32": 4, "bfloat16": 2, "int8": 1, "int16": 2, "int32": 4,
    "cfloat": 8, "cint16": 4,
}
# Real-equivalent MACs/cycle relative to the int8 rate (paper §II-A1: one
# AIE does 128 int8 MACs/cycle; 32 int16, 8 int32/fp32; 8 cint16 complex
# MACs = 32 real MACs, 2 cfloat complex MACs = 8 real MACs).  TOPS are
# counted in real ops throughout (1 complex MAC = 8 real ops).
PACKING = {"int8": 1.0, "int16": 0.25, "int32": 0.0625, "float32": 0.0625,
           "bfloat16": 0.5, "cfloat": 0.0625, "cint16": 0.25}
# TPU-specific packing (MXU ladder: bf16 native, fp32 1/4 rate, int8 2x;
# complex lowered to real-plane matmuls at the matching real rate)
PACKING_TPU = {"int8": 1.0, "bfloat16": 0.5, "float32": 0.125,
               "int16": 0.5, "int32": 0.125, "cfloat": 0.125,
               "cint16": 0.5}


def _divisors_near(n: int, target: int) -> list[int]:
    """Divisors of n ordered by closeness to target (utilization-first)."""
    divs = [d for d in range(1, n + 1) if n % d == 0]
    return sorted(divs, key=lambda d: (abs(d - target), -d))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Partition:
    """A fully tiled mapping of one systolic schedule onto the target."""

    schedule: SystolicSchedule
    # chip level
    array_tiles: tuple[int, ...]      # (N1, M1): physical array shape used
    thread_factor: int                # K2 across a mesh axis (1 = off)
    # kernel level (per-chip Pallas blocks)
    block: dict[str, int]             # loop -> block extent (N0/M0/K0)
    acc_tile: tuple[int, int]         # (N2, M2) accumulator sub-tile
    # scores
    utilization: float                # fraction of physical PEs busy
    edge_bytes_per_op: float          # array-edge traffic per scalar op
    vmem_bytes: int

    def describe(self) -> str:
        return (
            f"array={self.array_tiles} K2={self.thread_factor} "
            f"block={self.block} acc={self.acc_tile} "
            f"util={self.utilization:.3f} edge_B/op={self.edge_bytes_per_op:.4f} "
            f"vmem={self.vmem_bytes/2**20:.2f}MiB"
        )


def _kernel_blocks(
    rec: UniformRecurrence,
    sched: SystolicSchedule,
    per_pe_extents: dict[str, int],
    dtype_bytes: int,
    local_bytes: int = VMEM_BYTES,
) -> tuple[dict[str, int], tuple[int, int], int] | None:
    """Pick per-PE Pallas block shapes (N0,M0,K0) + latency-hiding (N2,M2).

    Alignment: the two minor dims of every MXU operand want multiples of
    (SUBLANES, MXU_LANES).  VMEM: in-blocks are double-buffered by the
    Mosaic pipeline (2x), the accumulator scratch is single.
    """
    space = sched.space_loops
    time = sched.time_loops
    blocks: dict[str, int] = {}
    # space loops tile to MXU-aligned blocks; time loops to reduction strips
    for loop in rec.loops:
        ext = per_pe_extents[loop]
        if loop in space:
            tgt = MXU_LANES if ext >= MXU_LANES else ext
        else:
            tgt = min(ext, 512)  # reduction strip; refined below by VMEM
        blk = min(ext, tgt)
        # round to hardware-friendly sizes when possible, falling back to
        # the divisor of ext nearest the target (keeps grids exact)
        for cand in (blk, MXU_LANES, 256, 64, 32, SUBLANES):
            if cand <= ext and ext % cand == 0:
                blk = cand
                break
        else:
            blk = _divisors_near(ext, blk)[0]
        blocks[loop] = blk

    # shrink reduction blocks until the working set fits VMEM
    def working_set() -> int:
        total = 0
        for acc in rec.accesses:
            size = dtype_bytes
            for l, _ in acc.index:
                if l is not None:
                    size *= blocks[l]
            mult = 2 if acc.kind == "read" else 1  # double-buffered inputs
            if acc.kind == "accum":
                size = size // dtype_bytes * 4  # fp32/int32 scratch
            total += size * mult
        return total

    guard = 0
    while working_set() > local_bytes and guard < 256:
        guard += 1
        # halve the largest shrinkable block (prefer time loops)
        cands = sorted(
            (l for l in rec.loops if blocks[l] > 1),
            key=lambda l: (l in sched.space_loops, -blocks[l]),
        )
        if not cands:
            return None
        l = cands[0]
        ext = per_pe_extents[l]
        smaller = [d for d in _divisors_near(ext, blocks[l] // 2) if d < blocks[l]]
        if not smaller:
            blocks[l] = 1
        else:
            blocks[l] = smaller[0]
    if working_set() > local_bytes:
        return None

    # latency hiding (N2, M2): accumulator sub-tile = the MXU-aligned face
    # of the space-loop blocks (point loops sunk innermost).
    s0 = blocks[space[0]] if space else 1
    s1 = blocks[space[1]] if len(space) > 1 else 1
    acc = (min(s0, MXU_LANES), min(s1, MXU_LANES))
    return blocks, acc, working_set()


def partition_schedule(
    rec: UniformRecurrence,
    sched: SystolicSchedule,
    mesh_shape: tuple[int, ...],
    allow_threading: bool = True,
    local_bytes: int = VMEM_BYTES,
) -> list[Partition]:
    """Fold one systolic schedule onto a physical mesh (paper §III-B2..4).

    ``mesh_shape``: the physical array available, e.g. (16, 16) chips.
    Returns candidate Partitions ranked by (utilization desc, edge traffic
    asc) — the paper's objective ordering.
    """
    dtype_bytes = DTYPE_BYTES.get(rec.dtype, 4)
    space = sched.space_loops
    total_pes = int(math.prod(mesh_shape))
    out: list[Partition] = []

    # pad mesh shape to schedule ndim
    if len(space) == 1:
        mesh_opts = [(int(math.prod(mesh_shape)),)]  # flatten to 1-D ring
        if len(mesh_shape) == 2:
            mesh_opts += [(mesh_shape[0],), (mesh_shape[1],)]
    else:
        mesh_opts = [tuple(mesh_shape)]
        if len(mesh_shape) == 2:
            mesh_opts.append((mesh_shape[1], mesh_shape[0]))

    thread_opts = [1]
    if allow_threading:
        red = [l for l in sched.time_loops if l in rec.reduction_loops]
        if red:
            max_red = max(rec.extent(l) for l in red)
            thread_opts += [k for k in (2, 4, 8) if k <= max_red]

    for mshape in mesh_opts:
        for k2 in thread_opts:
            # threading consumes PEs from the last mesh axis
            eff = list(mshape)
            if k2 > 1:
                if eff[-1] % k2 != 0:
                    continue
                eff[-1] //= k2
            # array partition: logical space extents fold onto eff array
            tiles = []
            util = 1.0
            per_pe: dict[str, int] = {}
            for ax, loop in enumerate(space):
                ext = rec.extent(loop)
                phys = eff[ax] if ax < len(eff) else 1
                if ext < phys:
                    # not enough logical width: idle PEs, utilization drops
                    util *= ext / phys
                    tiles.append(ext)
                    per_pe[loop] = 1
                else:
                    tiles.append(phys)
                    n1 = _ceil_div(ext, phys)
                    util *= ext / (n1 * phys)
                    per_pe[loop] = n1
            for loop in sched.time_loops:
                ext = rec.extent(loop)
                if k2 > 1 and loop in rec.reduction_loops:
                    ext = _ceil_div(ext, k2)
                per_pe[loop] = ext

            kb = _kernel_blocks(rec, sched, per_pe, dtype_bytes,
                                local_bytes)
            if kb is None:
                continue
            blocks, acc, vmem = kb

            # array utilization is measured against the FULL physical array
            # (the paper's headline metric): fold waste x idle PEs.
            used_pes = int(math.prod(tiles)) * k2
            util *= used_pes / total_pes

            # edge traffic per op (PLIO-analogue): bytes entering/leaving the
            # array edge per scalar op. Inputs stream once per reuse tile;
            # outputs once per point of the output space.
            edge_bytes = 0.0
            for a in rec.accesses:
                size = dtype_bytes
                for l, _ in a.index:
                    if l is not None:
                        size *= rec.extent(l)
                missing = [l for l in rec.loops if l not in a.loops_used()]
                if a.kind == "read":
                    # read operands re-enter the array edge once per outer
                    # tile of each missing loop (macro-tile streaming model;
                    # spatial reuse along space loops is already folded into
                    # per_pe) — the systolic neighbour chain forwards within
                    # a pass for free.
                    reuse = 1
                    for l in missing:
                        reuse *= _ceil_div(per_pe[l], max(blocks[l], 1))
                    edge_bytes += size * max(reuse, 1)
                else:
                    # accumulated outputs stay resident in the PE across the
                    # reduction (latency-hiding scratch) and drain exactly
                    # once; non-reduction missing loops would force partial
                    # drains (they do not occur in the paper's benchmarks).
                    reuse = 1
                    for l in missing:
                        if l not in rec.reduction_loops:
                            reuse *= _ceil_div(per_pe[l], max(blocks[l], 1))
                    edge_bytes += size * max(reuse, 1)
            edge_per_op = edge_bytes / max(rec.total_ops, 1)

            out.append(
                Partition(
                    schedule=sched,
                    array_tiles=tuple(tiles),
                    thread_factor=k2,
                    block=blocks,
                    acc_tile=acc,
                    utilization=util,
                    edge_bytes_per_op=edge_per_op,
                    vmem_bytes=vmem,
                )
            )
    out.sort(key=lambda p: (-p.utilization, p.edge_bytes_per_op))
    return out
