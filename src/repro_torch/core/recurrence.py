"""Uniform-recurrence IR (paper §II-B) — the port's copy of the parts of
``repro.core.recurrence`` that the serving path plans.

A *uniform recurrence* is a perfectly nested loop over a hyper-rectangular
iteration domain in which every dependence is a constant distance vector.
The mapping pipeline (spacetime -> partition -> plio -> mapper) consumes
this IR; the port builds two recurrences from it:

    MM       C[i,j]   += A[i,k] * B[k,j]
    BMM      C[b,i,j] += A[b,i,k] * B[b,k,j]     (the model-stack shape)

The dataclasses and the two builders are copied field for field, so a plan
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
