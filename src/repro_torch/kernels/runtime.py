"""Plan-driven kernel runtime (the ExecutionPlan -> kernel contract).

``execute_plan(plan, *tensors)`` looks up the recurrence's ``KernelSpec``
and runs it: a plan stamped ``pallas`` (the mapper's choice) runs the
hand-written Hopper kernel, a plan stamped ``xla`` runs the plain
PyTorch version.  ``last_tiles`` records, per recurrence, the plan's
block beside the compiled tile the last hand-kernel launch used.

The plan's tiles were sized by the planner for a TPU (128-lane MXU, 16 MiB
of VMEM) and fall back to divisors that are not powers of two (3, 6, 12,
103), with the whole batch as one block.  The ``*_tile`` functions adapt
them to the compiled kernel tiles.

mm, bmm and the fft2d stages (``hopper_tiles``, tiles
``build.COMPILED_TILES``):

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
``--tile-sweep``).  The batch block is not a kernel tile: the kernel
gives every batch entry its own grid slice.

fir and conv2d (``fir_tile``, ``conv2d_tile``): the plan's output block
({n: 103} or {h: 8, w: 64} on the audio frontend) is a TPU tile; the
kernels are compiled for a 256-thread block computing 1 or 4 outputs a
thread.  The larger tile is taken when it still gives every one of the
card's 132 SMs a block, the smaller one otherwise (the frontend's
chunks are a few thousand outputs: 25 and 16 blocks with the small
tiles, 7 and 8 with the large).  On an H100 this picks the faster tile
at both the frontend and the bench shapes (PERF.md, from
``chip_smoke.py``).

The star stencils and mttkrp (``stencil_tile``, ``mttkrp_tile``): the
reference planner's single-chip plans are TPU tiles again ({i: 2, j: 2},
{i: 12, j: 12}, {i: 89, j: 89} for the three stencils at their bench
sizes, ``bj = 8`` for mttkrp).  Each kernel is compiled for one tile, a
256-thread block of 4 x 4 outputs a thread (``build.STENCIL_TILE``,
``build.MTTKRP_TILE``), which every plan maps onto: the path runs them
at the bench sizes only, where it was the faster of two tiles on an
H100 (PERF.md).

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


#: streaming multiprocessors of an H100 SXM
SMS = 132


@dataclasses.dataclass(frozen=True)
class HopperTiles:
    """A plan's kernel-scope tiles and the compiled kernel tile that
    executes them."""

    plan: tuple[int, ...]
    tile: tuple[int, ...]


#: recurrence name -> the tiles of its last hand-kernel launch
last_tiles: dict[str, HopperTiles] = {}


def hopper_tiles(plan: "ExecutionPlan", *,
                 b_col_major: bool = False) -> HopperTiles:
    """Map an mm-family plan's kernel-scope tiles onto a compiled Hopper
    tile (see the module docstring); ``b_col_major`` is B's layout."""
    from . import registry

    kw = registry.get(plan.recurrence.name).block_kwargs(plan)
    want = (kw["bm"], kw["bn"], kw["bk"])
    covering = [t for t in build.COMPILED_BM if t >= want[0]]
    bm = min(covering) if covering else max(build.COMPILED_BM)
    bk = 8 if b_col_major else 32
    tile = next(t for t in build.COMPILED_TILES if t[0] == bm and t[2] == bk)
    return HopperTiles(plan=want, tile=tile)


def fir_tile(plan: "ExecutionPlan", n_out: int) -> HopperTiles:
    """The compiled FIR tile for ``n_out`` outputs: the larger BN while it
    leaves a block for every SM (module docstring)."""
    from . import registry

    small, large = build.FIR_TILES
    bn = large if -(-n_out // large) >= SMS else small
    return HopperTiles(
        plan=(registry.get("fir").block_kwargs(plan)["bn"],), tile=(bn,))


def conv2d_tile(plan: "ExecutionPlan", oh: int, ow: int) -> HopperTiles:
    """The compiled conv2d tile for an ``oh`` x ``ow`` output: the taller
    one while it leaves a block for every SM (module docstring)."""
    from . import registry

    kw = registry.get("conv2d").block_kwargs(plan)
    small, large = build.CONV2D_TILES
    blocks = -(-oh // large[0]) * -(-ow // large[1])
    return HopperTiles(plan=(kw["bh"], kw["bw"]),
                       tile=large if blocks >= SMS else small)


def stencil_tile(plan: "ExecutionPlan") -> HopperTiles:
    """A star-stencil plan's tile beside the compiled one."""
    from . import registry

    kw = registry.get(plan.recurrence.name).block_kwargs(plan)
    return HopperTiles(plan=(kw["bh"], kw["bw"]), tile=build.STENCIL_TILE)


def mttkrp_tile(plan: "ExecutionPlan") -> HopperTiles:
    """An mttkrp plan's tile beside the compiled one."""
    from . import registry

    kw = registry.get("mttkrp").block_kwargs(plan)
    return HopperTiles(plan=(kw["bi"], kw["bj"], kw["bk"], kw["bl"]),
                       tile=build.MTTKRP_TILE)


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
    tiles = spec.tiles(plan, *tensors)
    if tensors[0].device.type != "cpu":
        last_tiles[spec.name] = tiles
    return spec.hopper(*tensors, tiles=tiles.tile, out_dtype=out_dtype)
