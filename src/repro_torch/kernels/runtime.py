"""Plan-driven kernel runtime (the ExecutionPlan -> kernel contract).

``execute_plan(plan, *tensors)`` looks up the recurrence's ``KernelSpec``
and runs it: a plan stamped ``pallas`` (the mapper's choice) runs the
hand-written Hopper kernel, a plan stamped ``xla`` runs the plain
PyTorch version.

The plan's tiles were sized by the planner for a TPU (128-lane MXU, 16 MiB
of VMEM) and fall back to divisors that are not powers of two (3, 6, 12),
with the whole batch as one block.  ``hopper_tiles`` adapts them to the
compiled kernel tiles (``build.COMPILED_TILES``):

* BM is the smallest compiled row count that covers the plan's row tile
  (the largest where none does; the kernel masks ragged edges, so any
  compiled tile is a legal launch).  The serving plans take all of M
  (1, 4 or up to 16 rows) as their row tile.
* BN is not the plan's column tile.  The TPU's lane width (j = 128) would
  give N = 1024 eight blocks on a 132-SM card, and the kernel's K loop is
  bound by each thread's global loads, B's share of which is BK x BN over
  the block's threads.  Each BM is compiled with the narrowest BN that
  still fills a block of 128 threads, which is also the widest such grid
  (one-warp blocks of 32 columns were slower on an H100).
* BK follows B's layout, not the plan's reduction tile: 32 for a
  row-major B, 8 for a column-major one (the tied lm_head), the faster
  of the two for each layout on an H100.

PERF.md has the times behind both choices (``chip_smoke.py`` and its
``--tile-sweep``).

The batch block is not a kernel tile: the kernel gives every batch entry
its own grid slice.

``acc_dtype``/``out_dtype`` are the reference's accumulator ladder:
integer inputs accumulate and land in int32, floats accumulate in fp32
and land in the input dtype.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from . import build

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.mapper import ExecutionPlan


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype ladder: integer inputs -> int32, else float32."""
    return torch.float32 if dtype.is_floating_point else torch.int32


def out_dtype(dtype: torch.dtype) -> torch.dtype:
    """Default output dtype: int accumulations widen to int32."""
    return dtype if dtype.is_floating_point else torch.int32


@dataclasses.dataclass(frozen=True)
class HopperTiles:
    """A plan's ``(bm, bn, bk)`` tiles and the compiled kernel tile that
    executes them."""

    plan: tuple[int, int, int]
    tile: tuple[int, int, int]


def hopper_tiles(plan: "ExecutionPlan", *,
                 b_col_major: bool = False) -> HopperTiles:
    """Map the plan's kernel-scope tiles onto a compiled Hopper tile (see
    the module docstring); ``b_col_major`` is B's layout."""
    from . import registry

    kw = registry.get(plan.recurrence.name).block_kwargs(plan)
    want = (kw["bm"], kw["bn"], kw["bk"])
    covering = [t for t in build.COMPILED_BM if t >= want[0]]
    bm = min(covering) if covering else max(build.COMPILED_BM)
    bk = 8 if b_col_major else 32
    tile = next(t for t in build.COMPILED_TILES if t[0] == bm and t[2] == bk)
    return HopperTiles(plan=want, tile=tile)


def execute_plan(plan: "ExecutionPlan", *tensors, out_dtype=None):
    """Execute an ExecutionPlan on concrete tensors: the hand kernel for a
    ``pallas`` stamp (the plain version when the tensors lie on the CPU),
    the plain version for an ``xla`` stamp."""
    from . import registry

    spec = registry.get(plan.recurrence.name)
    if len(tensors) != spec.arity:
        raise ValueError(f"{spec.name} expects {spec.arity} operands, got "
                         f"{len(tensors)}")
    if plan.backend == "xla":
        return spec.ref(*tensors, out_dtype=out_dtype)
    if plan.backend != "pallas":
        raise NotImplementedError(
            f"backend {plan.backend!r} has no lowering in the port")
    tiles = hopper_tiles(plan, b_col_major=not tensors[1].is_contiguous())
    return spec.hopper(*tensors, tiles=tiles.tile, out_dtype=out_dtype)
