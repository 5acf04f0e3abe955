"""Hierarchical two-level plans: outer (dp, tp) mesh x inner systolic chip
(the port of ``repro.core.hierarchy``).

The mapper plans one chip-level mesh; this module composes a Megatron-
style outer data/tensor-parallel mesh above it, so one
``best_plan(rec, HierarchicalTarget(...), policy=...)`` call optimizes
both levels:

  * the **outer partition** splits the recurrence across ``dp * tp``
    groups: column/row-parallel GEMM splits for mm/bmm (concat over N or
    sum over K), a batch split for bmm, and halo-sharded overlapping row
    tiles for the single-sweep star stencils;
  * each group's **sub-recurrence** plans through the unchanged
    ``mapper.best_plan`` path against the inner target;
  * candidates rank by a **combined cost**: the outer collective's wire
    bytes (``parallel/collectives.py``) over the outer interconnect
    (``roofline.collective_time_s``), plus the inner roofline time, with
    the inner PLIO peak congestion as the tie-break.

The planning code, its constants and the cost model's parameters are the
reference's, so both packages return the same plan, split and bytes for
the same recurrence and target.

Legality failures raise ``HierarchyError`` with a machine-checkable
``reason``:

  ``unsupported``               the family has no outer split (conv,
                                fir, fft, mttkrp, fused chains)
  ``flow``                      jacobi2d_ms: the sweep loop's flow
                                dependence would need per-sweep halos
  ``outer-divisibility``        no outer split divides the extents
  ``halo-exceeds-outer-shard``  the stencil radius is wider than an
                                outer tile

Execution (``lower_hierarchical``) is a composition on one device, as the
reference's traceable backends run it: the operands are sliced per group
(views, no copies), each group runs the inner plan's lowering (``pallas``:
the hand-written Hopper kernel; ``xla``: the plain version), and the
results are joined with ``torch.cat`` or summed.  A column split hands
the kernels a B whose rows are N apart and a row split an A whose rows
are K apart (``runtime.b_pitch``, ``runtime.a_pitch``).  Row-parallel
partials are taken at the accumulator dtype and summed before the output
cast, so an integer row split is bit-exact against the flat plan.  This is
how the serving GEMMs run two-level inside the paged engine's captured
decode step.  The chip-level backends (``systolic``, ``allgather``) give
each group a disjoint block of ``R * C`` logical devices
(``parallel/mesh.py``) as an (R, C) inner mesh and run the inner plan's
chip schedule there (``kernels/systolic.py``), as the reference's
``_group_fns`` do; on one card every block is that card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from .mapper import ExecutionPlan, Target, best_plan
from .partition import DTYPE_BYTES
from .plio import congestion_scalar
from .recurrence import UniformRecurrence, stencil_star
from .roofline import collective_time_s

#: Recurrence families with a defined outer split.
SPLITTABLE = ("mm", "bmm", "jacobi2d", "jacobi2d_9pt")

#: Outer-split modes of the GEMM families (see ``plan_hierarchy``).
GEMM_SPLITS = ("column", "row")


class HierarchyError(ValueError):
    """An illegal two-level composition, with a machine-checkable reason
    (``unsupported`` | ``flow`` | ``outer-divisibility`` |
    ``halo-exceeds-outer-shard``)."""

    def __init__(self, reason: str, message: str):
        super().__init__(f"[{reason}] {message}")
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class HierarchicalTarget:
    """Two-level target: an outer (dp, tp) mesh of inner chip meshes.

    ``outer_shape=(dp, tp)``: ``dp`` splits the independent dim (M rows,
    the bmm batch, stencil row tiles), ``tp`` applies the column/row
    split.  ``inner`` is the per-group target every sub-recurrence plans
    against.  ``interconnect_gbps`` prices the outer collectives: a
    parameter of the copied cost model, the reference's value.

    ``mesh_shape``/``mesh_axes`` forward to the inner target, so the
    shared plan plumbing (autotune keys, clamping) reads one surface for
    flat and hierarchical targets.
    """

    name: str = "hier"
    outer_shape: tuple[int, int] = (1, 2)
    outer_axes: tuple[str, str] = ("dp", "tp")
    inner: Target = Target(name="planned_chip", mesh_shape=(1, 8))
    interconnect_gbps: float = 50.0

    @property
    def mesh_shape(self) -> tuple[int, ...]:
        return self.inner.mesh_shape

    @property
    def mesh_axes(self) -> tuple[str, ...]:
        return self.inner.mesh_axes

    @property
    def groups(self) -> int:
        return int(math.prod(self.outer_shape))

    @property
    def n_devices(self) -> int:
        return self.groups * int(math.prod(self.inner.mesh_shape))


#: The serving default: one dp group, 2-way tensor parallelism over the
#: facade's planned_chip geometry (the engines take any other).
SERVING_HIERARCHICAL_TARGET = HierarchicalTarget(name="hier_serving")


@dataclasses.dataclass(frozen=True)
class HierarchicalPlan:
    """An outer split and the inner plan every group executes.

    Stands in for an ``ExecutionPlan`` where the shared plumbing needs it
    (``recurrence``/``target``/``backend``/``provenance``/``feasible``).
    ``backend`` names the lowering of the groups (``pallas`` or ``xla``
    on one device).
    """

    recurrence: UniformRecurrence
    target: HierarchicalTarget
    outer_split: str                 # "column" | "row" | "batch" | "halo"
    sub_recurrence: UniformRecurrence
    inner_plan: ExecutionPlan
    outer_bytes: int                 # modelled outer collective wire bytes
    outer_us: float
    inner_us: float
    backend: str = "pallas"
    provenance: str = "modelled"

    @property
    def feasible(self) -> bool:
        return self.inner_plan.feasible

    @property
    def combined_us(self) -> float:
        return self.outer_us + self.inner_us

    @property
    def predicted_tops(self) -> float:
        if self.combined_us <= 0:
            return 0.0
        return 2.0 * self.recurrence.total_ops / (self.combined_us * 1e6)

    def describe(self) -> str:
        dp, tp = self.target.outer_shape
        return (
            f"[hier {self.recurrence.name}/{self.recurrence.dtype}] "
            f"outer {dp}x{tp} split={self.outer_split} "
            f"bytes={self.outer_bytes} cost={self.combined_us:.1f}us | "
            f"inner {self.inner_plan.describe()} | "
            f"backend={self.backend}[{self.provenance}]"
        )


# ---------------------------------------------------------------------------
# outer collective byte models
# ---------------------------------------------------------------------------

from repro_torch.parallel.collectives import (  # noqa: E402
    halo_exchange_bytes,
    ring_allgather_bytes,
    ring_allreduce_bytes,
)


# ---------------------------------------------------------------------------
# candidate enumeration + the combined cost model
# ---------------------------------------------------------------------------

def _bytes_of(dtype: str) -> int:
    return DTYPE_BYTES.get(dtype, 4)


def _acc_bytes(dtype: str) -> int:
    # the accumulator ladder (runtime.acc_dtype): int -> int32, float ->
    # float32, both 4 bytes
    return 4


def _out_bytes(dtype: str) -> int:
    # runtime.out_dtype: int -> int32 (4 bytes), float -> the same dtype
    return 4 if dtype.startswith("int") else _bytes_of(dtype)


def _builder(name: str):
    from repro_torch.kernels import registry  # late: kernels import core

    return registry.get(name).builder


def _roofline_us(total_ops: int, tops: float) -> float:
    """Inner roofline time for one group (2 ops per MAC point)."""
    if tops <= 0 or math.isinf(tops):
        return 0.0
    return 2.0 * total_ops / (tops * 1e6)


@dataclasses.dataclass(frozen=True)
class _Candidate:
    split: str
    sub: UniformRecurrence
    outer_bytes: int


def _gemm_candidates(rec: UniformRecurrence,
                     ht: HierarchicalTarget) -> list[_Candidate]:
    dp, tp = ht.outer_shape
    build = _builder(rec.name)
    out: list[_Candidate] = []
    if rec.name == "mm":
        m, n, k = rec.extents
        if m % dp:
            return out
        if n % tp == 0:  # column parallel: all-gather the N shards
            shard = (m // dp) * (n // tp) * _out_bytes(rec.dtype)
            out.append(_Candidate(
                "column", build(m // dp, n // tp, k, rec.dtype),
                dp * ring_allgather_bytes(shard, tp)))
        if k % tp == 0:  # row parallel: all-reduce the K partials
            payload = (m // dp) * n * _acc_bytes(rec.dtype)
            out.append(_Candidate(
                "row", build(m // dp, n, k // tp, rec.dtype),
                dp * ring_allreduce_bytes(payload, tp)))
        return out
    # bmm: extents (b, m, n, k), builder (b, m, n, k)
    b, m, n, k = rec.extents
    if b % dp:
        return out
    b_loc = b // dp
    if b_loc % tp == 0:  # pure batch split: no outer collective at all
        out.append(_Candidate(
            "batch", build(b_loc // tp, m, n, k, rec.dtype), 0))
    if n % tp == 0:
        shard = b_loc * m * (n // tp) * _out_bytes(rec.dtype)
        out.append(_Candidate(
            "column", build(b_loc, m, n // tp, k, rec.dtype),
            dp * ring_allgather_bytes(shard, tp)))
    if k % tp == 0:
        payload = b_loc * m * n * _acc_bytes(rec.dtype)
        out.append(_Candidate(
            "row", build(b_loc, m, n, k // tp, rec.dtype),
            dp * ring_allreduce_bytes(payload, tp)))
    return out


def _stencil_radius(rec: UniformRecurrence) -> int:
    star = stencil_star(rec)
    if star is None:
        raise HierarchyError(
            "unsupported", f"{rec.name}: no star access — not a stencil")
    return max(abs(o[0]) for o in star) if star else 0


def halo_fits(radius: int, interior: int, shards: int) -> bool:
    """Whether ``shards`` tiles of an ``interior``-point axis can take
    their halo from the adjacent tile alone at stencil ``radius``: each
    tile at least ``radius`` wide (the reference's shared predicate of
    ``kernels/systolic.halo_fits``)."""
    return shards > 0 and interior % shards == 0 \
        and radius <= interior // shards


def _stencil_candidates(rec: UniformRecurrence,
                        ht: HierarchicalTarget) -> list[_Candidate]:
    """Halo-sharded outer row tiles of the padded grid.

    The outer level linearizes (dp, tp) into G overlapping row tiles:
    group g receives padded-grid rows ``[g*h_loc, g*h_loc + h_loc + 2r)``
    — its neighbours' facing ``r`` rows ride along as the tile's own
    padding, which is exact for a single-sweep star stencil (the sweep
    reads only the input grid), so no exchange is needed at execution
    time.  The modelled wire bytes are the two ``r``-wide strips per
    internal tile boundary a multi-device deployment would stream.
    """
    g = ht.groups
    h, w = rec.extents[0], rec.extents[1]
    r = _stencil_radius(rec)
    if h % g:
        raise HierarchyError(
            "outer-divisibility",
            f"{rec.name}: interior rows {h} do not divide over "
            f"{g} outer tiles (dp x tp = {ht.outer_shape})")
    h_loc = h // g
    if not halo_fits(r, h, g):
        raise HierarchyError(
            "halo-exceeds-outer-shard",
            f"{rec.name}: stencil radius {r} exceeds the {h_loc}-row "
            f"outer tile — an outer halo can only come from the adjacent "
            "tile; use fewer outer groups or a taller grid")
    strip = r * (w + 2 * r) * _bytes_of(rec.dtype)
    sub = _builder(rec.name)(h_loc, w, rec.dtype)
    return [_Candidate("halo", sub, halo_exchange_bytes(strip, g - 1))]


def plan_hierarchy(rec: UniformRecurrence, ht: HierarchicalTarget,
                   policy=None) -> HierarchicalPlan:
    """Enumerate the legal outer splits, plan each sub-recurrence on the
    inner target, rank by the combined cost and return the winner.

    Candidates rank by ``(outer collective time + inner roofline time,
    inner PLIO peak congestion)``; the inner plans come from the
    unchanged ``mapper.best_plan`` (with ``policy`` forwarded for the
    winner, so its inner plan gets its measured backend where the
    crossover table covers the sub-shape).
    """
    if getattr(rec, "stages", None) is not None:
        raise HierarchyError(
            "unsupported",
            f"fused chain {rec.name}: chains do not compose "
            "hierarchically — plan the stages separately")
    dp, tp = ht.outer_shape
    if dp < 1 or tp < 1:
        raise HierarchyError(
            "outer-divisibility", f"outer shape {ht.outer_shape} must be "
            "positive")
    if rec.name == "jacobi2d_ms":
        raise HierarchyError(
            "flow",
            "jacobi2d_ms: the sweep loop carries a flow dependence — "
            "outer tiles would need a halo exchange per sweep, which the "
            "host-level composition cannot express")
    if rec.name not in SPLITTABLE:
        raise HierarchyError(
            "unsupported",
            f"{rec.name}: no outer split defined (supported: "
            f"{', '.join(SPLITTABLE)})")
    if rec.name in ("mm", "bmm"):
        cands = _gemm_candidates(rec, ht)
        if not cands:
            raise HierarchyError(
                "outer-divisibility",
                f"{rec.name} extents {rec.extents} admit no outer "
                f"{dp}x{tp} split (dp must divide the leading dim; tp "
                "must divide N, K, or the per-dp batch)")
    else:
        cands = _stencil_candidates(rec, ht)

    best: tuple | None = None
    for cand in cands:
        inner = best_plan(cand.sub, ht.inner)
        outer_us = collective_time_s(
            cand.outer_bytes, ht.interconnect_gbps) * 1e6
        inner_us = _roofline_us(cand.sub.total_ops, inner.predicted_tops)
        cong = congestion_scalar(inner.congestion_west,
                                 inner.congestion_east)
        rank = (outer_us + inner_us, cong)
        if best is None or rank < best[0]:
            best = (rank, cand, inner, outer_us, inner_us)
    _, cand, inner, outer_us, inner_us = best
    if policy is not None and policy.mode != "modelled":
        # the winner's inner plan re-resolves under the caller's policy
        # (the flat sub-shape key at the inner mesh)
        inner = best_plan(cand.sub, ht.inner, policy=policy)
    return HierarchicalPlan(
        recurrence=rec,
        target=ht,
        outer_split=cand.split,
        sub_recurrence=cand.sub,
        inner_plan=inner,
        outer_bytes=cand.outer_bytes,
        outer_us=outer_us,
        inner_us=inner_us,
        backend=inner.backend,
    )


# ---------------------------------------------------------------------------
# execution: the composition on one device
# ---------------------------------------------------------------------------

def hierarchical_available_backends(ht: HierarchicalTarget
                                    ) -> tuple[str, ...]:
    """Backends this process can execute for a hierarchical target: the
    compositions of the hand kernel and of the plain version always; the
    per-group chip schedules only where ``parallel.mesh`` counts
    ``dp * tp`` disjoint inner meshes of logical devices."""
    from repro_torch.parallel import mesh

    avail = ["pallas", "xla"]
    if mesh.local_device_count() >= ht.n_devices \
            and len(ht.inner.mesh_shape) >= 2:
        avail += ["systolic", "allgather"]
    return tuple(avail)


def _group_fns(plan: HierarchicalPlan, backend: str) -> list[Callable]:
    """The inner lowering of each outer group (``fn(*operands,
    out_dtype)``).  ``pallas`` / ``xla`` share one function; ``systolic``
    / ``allgather`` give group ``i`` the disjoint block of logical devices
    ``[i * R * C, (i + 1) * R * C)`` as an (R, C) inner mesh the spec's
    hooks run on, its output cast to ``out_dtype`` where one is asked
    for."""
    from .codegen import lower_plan

    g = plan.target.groups
    if backend not in ("systolic", "allgather"):
        return [lower_plan(plan.inner_plan, backend=backend)] * g
    from repro_torch.parallel import mesh as pm

    inner_t = plan.inner_plan.target
    rr, cc = inner_t.mesh_shape[:2]
    need = g * rr * cc
    devs = pm.devices()
    if len(devs) < need:
        raise RuntimeError(
            f"hierarchical {backend}: {need} devices needed for {g} groups "
            f"of {rr}x{cc} chips, host has {len(devs)}")

    def on_block(i: int) -> Callable:
        block = devs[i * rr * cc:(i + 1) * rr * cc]
        fn = lower_plan(plan.inner_plan, backend=backend, mesh=pm.make_mesh(
            (rr, cc), inner_t.mesh_axes[:2], block))

        def run(*operands, out_dtype=None):
            out = fn(*operands)
            return out if out_dtype is None else out.to(out_dtype)

        return run

    return [on_block(i) for i in range(g)]


def lower_hierarchical(plan: HierarchicalPlan, backend: str | None = None,
                       out_dtype=None) -> Callable:
    """HierarchicalPlan -> a callable with the flat operand contract of
    the underlying spec (full-size operands in, the full-size output out).

    Each group gets views of the operands (row slices of A and the grid;
    column or row slices of B, which the GEMM kernels read at B's row
    pitch) and runs the inner lowering; the outputs are joined with
    ``torch.cat``.  A row split takes each group's partial at the
    accumulator dtype (``runtime.acc_dtype``), sums them, and casts the
    sum to ``out_dtype`` (default ``runtime.out_dtype``).  Column, batch
    and halo groups flush at ``out_dtype`` themselves, as the flat plan's
    kernel does.  On the chip backends each group's schedule runs on its
    own inner mesh (``_group_fns``) and flushes at ``runtime.out_dtype``
    before the cast to ``out_dtype``.
    """
    import torch

    from repro_torch.kernels import runtime

    backend = backend or plan.backend
    fns = _group_fns(plan, backend)
    dp, tp = plan.target.outer_shape
    name = plan.recurrence.name

    def cat(parts, dim):
        return torch.cat(parts, dim=dim) if len(parts) > 1 else parts[0]

    def summed(parts, dtype):
        acc = parts[0]
        for part in parts[1:]:
            acc = acc + part
        want = out_dtype or runtime.out_dtype(dtype)
        return acc if acc.dtype == want else acc.to(want)

    if name == "mm":
        m, n, k = plan.recurrence.extents
        m_loc = m // dp
        if plan.outer_split == "column":
            n_loc = n // tp

            def run(x, w):
                return cat([cat([fns[d * tp + t](
                                    x[d * m_loc:(d + 1) * m_loc],
                                    w[:, t * n_loc:(t + 1) * n_loc],
                                    out_dtype=out_dtype)
                                 for t in range(tp)], 1)
                            for d in range(dp)], 0)
        else:  # row parallel
            k_loc = k // tp

            def run(x, w):
                acc = runtime.acc_dtype(x.dtype)
                rows = []
                for d in range(dp):
                    x_d = x[d * m_loc:(d + 1) * m_loc]
                    rows.append(summed(
                        [fns[d * tp + t](x_d[:, t * k_loc:(t + 1) * k_loc],
                            w[t * k_loc:(t + 1) * k_loc], out_dtype=acc)
                         for t in range(tp)], x.dtype))
                return cat(rows, 0)
        return run

    if name == "bmm":
        b, m, n, k = plan.recurrence.extents
        b_loc = b // dp
        if plan.outer_split == "batch":
            b_sub = b_loc // tp

            def run(a, bb):
                return cat([fns[i](a[i * b_sub:(i + 1) * b_sub],
                               bb[i * b_sub:(i + 1) * b_sub],
                               out_dtype=out_dtype)
                            for i in range(dp * tp)], 0)
        elif plan.outer_split == "column":
            n_loc = n // tp

            def run(a, bb):
                rows = []
                for d in range(dp):
                    a_d = a[d * b_loc:(d + 1) * b_loc]
                    b_d = bb[d * b_loc:(d + 1) * b_loc]
                    rows.append(cat([fns[d * tp + t](a_d,
                                        b_d[:, :, t * n_loc:(t + 1) * n_loc],
                                        out_dtype=out_dtype)
                                     for t in range(tp)], 2))
                return cat(rows, 0)
        else:  # row parallel
            k_loc = k // tp

            def run(a, bb):
                acc = runtime.acc_dtype(a.dtype)
                rows = []
                for d in range(dp):
                    a_d = a[d * b_loc:(d + 1) * b_loc]
                    b_d = bb[d * b_loc:(d + 1) * b_loc]
                    rows.append(summed(
                        [fns[d * tp + t](a_d[:, :, t * k_loc:(t + 1) * k_loc],
                            b_d[:, t * k_loc:(t + 1) * k_loc],
                            out_dtype=acc)
                         for t in range(tp)], a.dtype))
                return cat(rows, 0)
        return run

    # stencils: overlapping outer row tiles of the padded grid
    g = plan.target.groups
    h_loc = plan.recurrence.extents[0] // g
    r = _stencil_radius(plan.recurrence)

    def run(grid, weights):
        return cat([fns[i](grid[i * h_loc:i * h_loc + h_loc + 2 * r],
                       weights, out_dtype=out_dtype)
                    for i in range(g)], 0)

    return run
