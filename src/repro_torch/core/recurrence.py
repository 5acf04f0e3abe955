"""Uniform-recurrence IR (paper §II-B) — the port's copy of the parts of
``repro.core.recurrence``.

A *uniform recurrence* is a perfectly nested loop over a hyper-rectangular
iteration domain in which every dependence is a constant distance vector.
The mapping pipeline (spacetime -> partition -> plio -> mapper) consumes
this IR; the port builds every recurrence of the reference from it:

    MM       C[i,j]   += A[i,k] * B[k,j]
    BMM      C[b,i,j] += A[b,i,k] * B[b,k,j]     (the model-stack shape)
    CONV2D   O[h,w]   += I[h+p, w+q] * F[p,q]    (the audio feature stage)
    FIR      y[n]     += x[n+t] * h[t]           (the audio filter bank)
    FFT2D    Y[i,j]   += W[i,k] * X[k,j]         (one DFT stage, complex)
    Jacobi2D O[i,j]   += G[i+di_s, j+dj_s] * w[s] (5-point stencil sweep,
                         its radius-2 9-point star, and the multi-sweep
                         form whose sweep loop t carries a flow dependence)
    MTTKRP   M[i,j]   += X[i,k,l] * B[k,j] * C[l,j] (tensor decomposition)

The stencil builders carry their star in the IR: one read access per star
point, whose signed offsets give the halo width (``halo_radius``).

The dataclasses and the builders are copied field for field, so a plan
made here equals the reference planner's plan for the same request.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Access:
    """One array access of a statement.

    ``index``: for each array dimension, (loop_name, offset) — the loop index
    used plus a constant offset, or (None, const) for a broadcast dim.
    ``kind``: 'read' | 'write' | 'accum' (write with reduction semantics).
    """

    array: str
    index: tuple[tuple[str | None, int], ...]
    kind: str = "read"

    def loops_used(self) -> frozenset[str]:
        return frozenset(l for l, _ in self.index if l is not None)


@dataclasses.dataclass(frozen=True)
class Dependence:
    """A uniform dependence with a constant distance vector over the loops.

    ``kind``: 'read' (read-only reuse), 'flow' (true dependence) or
    'output' (reduction/output direction).  ``distance`` is keyed by loop
    name; loops absent have distance 0.
    """

    array: str
    kind: str
    distance: tuple[tuple[str, int], ...]

    def dist(self, loop: str) -> int:
        for l, d in self.distance:
            if l == loop:
                return d
        return 0

    def vector(self, loops: Sequence[str]) -> tuple[int, ...]:
        return tuple(self.dist(l) for l in loops)


@dataclasses.dataclass(frozen=True)
class UniformRecurrence:
    """A uniform recurrence: domain + accesses + dependences.

    ``loops``: loop names, outermost first.
    ``extents``: iteration counts per loop (same order).
    ``reduction_loops``: loops that carry an accumulation (e.g. k in MM).
    ``ops_per_point``: scalar ops per iteration-space point.
    ``dtype``: element dtype name (decides packing in the cost model).
    """

    name: str
    loops: tuple[str, ...]
    extents: tuple[int, ...]
    accesses: tuple[Access, ...]
    reduction_loops: frozenset[str]
    ops_per_point: int = 2
    dtype: str = "float32"

    def extent(self, loop: str) -> int:
        return self.extents[self.loops.index(loop)]

    @property
    def points(self) -> int:
        n = 1
        for e in self.extents:
            n *= e
        return n

    @property
    def total_ops(self) -> int:
        return self.points * self.ops_per_point

    def dependences(self) -> tuple[Dependence, ...]:
        """Derive uniform dependences from the access functions: a loop
        missing from a read access is a 'read' reuse direction (distance
        1); a loop missing from an accumulated access is an 'output'
        dependence along a reduction loop, else 'flow'.  Constant offsets
        in read accesses add 'read' dependences of that distance."""
        deps: list[Dependence] = []
        for acc in self.accesses:
            used = acc.loops_used()
            missing = [l for l in self.loops if l not in used]
            if acc.kind == "read":
                for l in missing:
                    deps.append(Dependence(acc.array, "read", ((l, 1),)))
                for dim_loop, off in acc.index:
                    if dim_loop is not None and off != 0:
                        deps.append(
                            Dependence(acc.array, "read", ((dim_loop, off),))
                        )
            elif acc.kind in ("write", "accum"):
                for l in missing:
                    kind = "output" if l in self.reduction_loops else "flow"
                    deps.append(Dependence(acc.array, kind, ((l, 1),)))
        seen: dict[tuple, Dependence] = {}
        for d in deps:
            seen[(d.array, d.kind, d.distance)] = d
        return tuple(seen.values())

    def validate(self) -> None:
        if len(self.loops) != len(self.extents):
            raise ValueError("loops/extents mismatch")
        if len(set(self.loops)) != len(self.loops):
            raise ValueError("duplicate loop names")
        for acc in self.accesses:
            for l, _ in acc.index:
                if l is not None and l not in self.loops:
                    raise ValueError(f"access {acc.array} uses unknown loop {l}")
        for l in self.reduction_loops:
            if l not in self.loops:
                raise ValueError(f"reduction loop {l} not in loops")


def matmul(n: int, m: int, k: int, dtype: str = "float32") -> UniformRecurrence:
    """C[i,j] += A[i,k] * B[k,j] over [i:n, j:m, k:k]."""
    r = UniformRecurrence(
        name="mm",
        loops=("i", "j", "k"),
        extents=(n, m, k),
        accesses=(
            Access("A", (("i", 0), ("k", 0)), "read"),
            Access("B", (("k", 0), ("j", 0)), "read"),
            Access("C", (("i", 0), ("j", 0)), "accum"),
        ),
        reduction_loops=frozenset({"k"}),
        ops_per_point=2,
        dtype=dtype,
    )
    r.validate()
    return r


def batched_matmul(
    b: int, n: int, m: int, k: int, dtype: str = "float32"
) -> UniformRecurrence:
    """C[bb,i,j] += A[bb,i,k] * B[bb,k,j] — attention heads and other
    model-stack products."""
    r = UniformRecurrence(
        name="bmm",
        loops=("b", "i", "j", "k"),
        extents=(b, n, m, k),
        accesses=(
            Access("A", (("b", 0), ("i", 0), ("k", 0)), "read"),
            Access("B", (("b", 0), ("k", 0), ("j", 0)), "read"),
            Access("C", (("b", 0), ("i", 0), ("j", 0)), "accum"),
        ),
        reduction_loops=frozenset({"k"}),
        ops_per_point=2,
        dtype=dtype,
    )
    r.validate()
    return r


def conv2d(h: int, w: int, p: int, q: int, dtype: str = "float32") -> UniformRecurrence:
    """O[hh,ww] += I[hh+pp, ww+qq] * F[pp,qq]  (paper's [h,w,p,q] sizes)."""
    r = UniformRecurrence(
        name="conv2d",
        loops=("h", "w", "p", "q"),
        extents=(h, w, p, q),
        accesses=(
            Access("I", (("h", 0), ("w", 0)), "read"),  # base point; window
            Access("F", (("p", 0), ("q", 0)), "read"),  # offsets handled in
            Access("O", (("h", 0), ("w", 0)), "accum"),  # deps via p/q reuse
        ),
        reduction_loops=frozenset({"p", "q"}),
        ops_per_point=2,
        dtype=dtype,
    )
    r.validate()
    return r


def fir(n: int, taps: int, dtype: str = "float32") -> UniformRecurrence:
    """y[nn] += x[nn+t] * h[t].  Complex taps: 1 cMAC = 8 real ops."""
    r = UniformRecurrence(
        name="fir",
        loops=("n", "t"),
        extents=(n, taps),
        accesses=(
            Access("x", (("n", 0),), "read"),
            Access("h", (("t", 0),), "read"),
            Access("y", (("n", 0),), "accum"),
        ),
        reduction_loops=frozenset({"t"}),
        ops_per_point=8 if dtype.startswith("c") else 2,
        dtype=dtype,
    )
    r.validate()
    return r


def fft2d_stage(rows: int, cols: int, dtype: str = "cfloat") -> UniformRecurrence:
    """One DFT stage of the four-step 2D FFT as an MM recurrence.

    Four-step FFT of an R x C grid:  Y = W_R @ X ; Y *= T ; Z = Y @ W_C
    Each stage is a (complex) matmul held as two real planes, so
    ops_per_point = 8 real ops (4 mul + 4 add per complex MAC).
    """
    r = UniformRecurrence(
        name="fft2d_stage",
        loops=("i", "j", "k"),
        extents=(rows, cols, rows),
        accesses=(
            Access("W", (("i", 0), ("k", 0)), "read"),
            Access("X", (("k", 0), ("j", 0)), "read"),
            Access("Y", (("i", 0), ("j", 0)), "accum"),
        ),
        reduction_loops=frozenset({"k"}),
        ops_per_point=8,
        dtype=dtype,
    )
    r.validate()
    return r


#: 5-point star offsets of the Jacobi2D stencil, indexed by the reduction
#: loop s; (di, dj) into the padded input grid (centre at (1, 1)).
JACOBI2D_OFFSETS = ((1, 1), (0, 1), (2, 1), (1, 0), (1, 2))

#: 9-point radius-2 star (centre, N1, N2, S1, S2, W1, W2, E1, E2), indexed
#: by the reduction loop s; (di, dj) into the padded grid (centre (2, 2)).
JACOBI2D_9PT_OFFSETS = (
    (2, 2),
    (1, 2), (0, 2), (3, 2), (4, 2),
    (2, 1), (2, 0), (2, 3), (2, 4),
)


def _star_accesses(
    array: str, offsets: tuple[tuple[int, int], ...], pad: int
) -> tuple[Access, ...]:
    """One read access per star point, signed offsets relative to the
    centre — the IR carries the stencil geometry the halo machinery
    consumes (``stencil_star``/``halo_radius``)."""
    return tuple(
        Access(array, (("i", di - pad), ("j", dj - pad)), "read")
        for di, dj in offsets
    )


def stencil_star(rec: UniformRecurrence) -> tuple[tuple[int, ...], ...] | None:
    """The recurrence's star: ordered signed per-point offsets, recovered
    from the access functions.

    A stencil shows up in the IR as one array read at several constant
    offsets (one access per star point, in reduction-loop order).  Returns
    the ``(offset per index dim, ...)`` tuple per point for the first such
    array, or None when no array is read at more than one offset (mm,
    conv2d's base-point window, ...).
    """
    by_array: dict[str, list[Access]] = {}
    for acc in rec.accesses:
        if acc.kind == "read":
            by_array.setdefault(acc.array, []).append(acc)
    for accs in by_array.values():
        if len(accs) > 1:
            return tuple(
                tuple(off for _, off in acc.index) for acc in accs
            )
    return None


def halo_radius(rec: UniformRecurrence, loops: Sequence[str]) -> int:
    """Width of the halo per space axis: the largest |offset| any read
    access applies to one of ``loops`` — radius 1 for the 5-point star, 2
    for the 9-point radius-2 star, from the IR access functions alone."""
    radius = 0
    for acc in rec.accesses:
        if acc.kind != "read":
            continue
        for loop, off in acc.index:
            if loop in loops:
                radius = max(radius, abs(off))
    return radius


def jacobi2d(h: int, w: int, dtype: str = "float32") -> UniformRecurrence:
    """O[i,j] += G[i+di_s, j+dj_s] * w[s] — one weighted 5-point Jacobi
    sweep over the interior of an (h+2, w+2) grid.

    The star is flattened into the reduction loop s (like conv2d's (p, q)
    window).  ``h``/``w`` are the *output* (interior) extents.  The IR
    carries one G access per star point (signed offsets, reduction order),
    so the halo width comes from the access functions (``halo_radius`` = 1
    here).
    """
    r = UniformRecurrence(
        name="jacobi2d",
        loops=("i", "j", "s"),
        extents=(h, w, len(JACOBI2D_OFFSETS)),
        accesses=(
            *_star_accesses("G", JACOBI2D_OFFSETS, pad=1),
            Access("W", (("s", 0),), "read"),
            Access("O", (("i", 0), ("j", 0)), "accum"),
        ),
        reduction_loops=frozenset({"s"}),
        ops_per_point=2,
        dtype=dtype,
    )
    r.validate()
    return r


def jacobi2d_9pt(h: int, w: int, dtype: str = "float32") -> UniformRecurrence:
    """O[i,j] += G[i+di_s, j+dj_s] * w[s] — one weighted 9-point *radius-2*
    star sweep over the interior of an (h+4, w+4) grid.

    The higher-order stencil class (star radius > 1): its distance-2 read
    dependences on the space loops are legal under the width-k refinement
    (``spacetime.candidate_space_loops``).  ``halo_radius`` recovers the 2
    from the access functions.
    """
    r = UniformRecurrence(
        name="jacobi2d_9pt",
        loops=("i", "j", "s"),
        extents=(h, w, len(JACOBI2D_9PT_OFFSETS)),
        accesses=(
            *_star_accesses("G", JACOBI2D_9PT_OFFSETS, pad=2),
            Access("W", (("s", 0),), "read"),
            Access("O", (("i", 0), ("j", 0)), "accum"),
        ),
        reduction_loops=frozenset({"s"}),
        ops_per_point=2,
        dtype=dtype,
    )
    r.validate()
    return r


def jacobi2d_multisweep(
    h: int, w: int, sweeps: int, dtype: str = "float32"
) -> UniformRecurrence:
    """Time-iterated Jacobi: ``sweeps`` weighted 5-point sweeps over the
    interior of an (h+2, w+2) grid with a fixed (Dirichlet) boundary ring.

    The sweep loop ``t`` carries a *flow* dependence: sweep ``t`` consumes
    the interior sweep ``t-1`` produced (``O`` is indexed by (i, j) but not
    ``t``, and ``t`` is not a reduction loop, so ``dependences()`` derives
    ``O: flow, distance (t, 1)``), so the mapper keeps ``t`` temporal
    (``spacetime.candidate_space_loops``) and the kernel runtime runs it
    as a host loop of single-sweep launches.

    Weights are per-sweep, ``W[t, s]``: every lowering recovers the sweep
    count from the weights operand's leading extent, so the (grid, weights)
    arity-2 operand contract is shared with single-sweep ``jacobi2d``.
    State promotes to the accumulator dtype (int -> int32) after the first
    sweep; all backends share that ladder, keeping int parity bit-exact.
    """
    r = UniformRecurrence(
        name="jacobi2d_ms",
        loops=("t", "i", "j", "s"),
        extents=(sweeps, h, w, len(JACOBI2D_OFFSETS)),
        accesses=(
            *_star_accesses("G", JACOBI2D_OFFSETS, pad=1),
            Access("W", (("t", 0), ("s", 0)), "read"),
            Access("O", (("i", 0), ("j", 0)), "accum"),
        ),
        reduction_loops=frozenset({"s"}),
        ops_per_point=2,
        dtype=dtype,
    )
    r.validate()
    return r


def mttkrp(
    i: int, j: int, k: int, l: int, dtype: str = "float32"  # noqa: E741
) -> UniformRecurrence:
    """M[i,j] += X[i,k,l] * B[k,j] * C[l,j] — matricized tensor times
    Khatri-Rao product (mode-1), the HPC tensor-decomposition hot loop.

    3 ops per point (two multiplies + one accumulate); two reduction
    loops (k, l) contract the order-3 tensor against both factor
    matrices.
    """
    r = UniformRecurrence(
        name="mttkrp",
        loops=("i", "j", "k", "l"),
        extents=(i, j, k, l),
        accesses=(
            Access("X", (("i", 0), ("k", 0), ("l", 0)), "read"),
            Access("B", (("k", 0), ("j", 0)), "read"),
            Access("C", (("l", 0), ("j", 0)), "read"),
            Access("M", (("i", 0), ("j", 0)), "accum"),
        ),
        reduction_loops=frozenset({"k", "l"}),
        ops_per_point=3,
        dtype=dtype,
    )
    r.validate()
    return r


PAPER_BENCHMARKS = {
    # Table II of the paper: benchmark -> (builder, problem sizes, dtypes)
    "mm": (
        matmul,
        {
            "float32": (8192, 8192, 8192),
            "int8": (10240, 10240, 10240),
            "int16": (9600, 9600, 9600),
            "int32": (8192, 8192, 8192),
        },
    ),
    "conv2d": (
        conv2d,
        {
            "float32": (10240, 10240, 4, 4),
            "int8": (10240, 10240, 8, 8),
            "int16": (10240, 10240, 4, 4),
            "int32": (10240, 10240, 4, 4),
        },
    ),
    "fft2d": (
        fft2d_stage,
        {
            "cfloat": (8192, 8192),
            "cint16": (8192, 8192),
        },
    ),
    "fir": (
        fir,
        {
            "float32": (1048576, 15),
            "int8": (1048576, 15),
            "int16": (1048576, 15),
            "cfloat": (1048576, 15),
        },
    ),
}
