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

mm, bmm and the fft2d stages run one of two kernels of
``csrc/widesa_mm.cu`` (``gemm_tiles``, ``gemm_tile``):

* The skinny kernel takes every product whose A has at most 16 rows
  (``SKINNY_ROWS``): all serving GEMMs (decode batches, prompts of at most
  16 tokens, 8-frame audio chunks, GQA rows) and the fft2d stages.  Bytes
  of B bound them, so its configuration (``skinny_tile``, a
  ``SkinnyTile``) is computed from the shape alone (M, N, K, the batch and
  the dtype), not from the plan: blocks of 32 columns, and, for a B above
  1 MiB, K split over the blocks of a cluster (at most 8) until the grid
  has three blocks for each of the card's 132 SMs, as far as K and the A
  each block stages in shared memory allow (``SKINNY_SPLIT_BYTES``,
  ``SKINNY_TARGET_BLOCKS``).  B's layout and alignment decide the copy width
  (``b_copy_bytes``): rows of B must allow copies of at least 4 bytes.
* The tiled kernel (``hopper_tiles``, tiles ``build.COMPILED_TILES``)
  takes A of more rows and any B whose rows are not 4-byte aligned (a
  storage offset, or an odd row of 2-byte elements).  BM is the smallest
  compiled row count that covers the plan's row tile (the largest where
  none does; the kernel masks ragged edges, so any compiled tile is a
  legal launch).  BN is not the plan's column tile: each BM is compiled
  with the narrowest BN that still fills a block of 128 threads.  BK
  follows B's layout, not the plan's reduction tile: 32 for a row-major
  B, 8 for a column-major one (the tied lm_head).

PERF.md has the times behind these choices (``chip_smoke.py`` and its
``--tile-sweep``).  ``last_tiles`` records the plan's block beside the
configuration that ran.  The batch block is not a kernel tile: each
batch entry gets its own grid slice.

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
import functools
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
    """Map an mm-family plan's kernel-scope tiles onto a compiled tile of
    the tiled kernel (see the module docstring); ``b_col_major`` is B's
    layout."""
    from . import registry

    kw = registry.get(plan.recurrence.name).block_kwargs(plan)
    want = (kw["bm"], kw["bn"], kw["bk"])
    covering = [t for t in build.COMPILED_BM if t >= want[0]]
    bm = min(covering) if covering else max(build.COMPILED_BM)
    bk = 8 if b_col_major else 32
    tile = next(t for t in build.COMPILED_TILES if t[0] == bm and t[2] == bk)
    return HopperTiles(plan=want, tile=tile)


#: the skinny kernel's geometry (``kSkinny*`` in csrc/widesa_mm.cu): rows of
#: A at most, columns a block computes, bytes of K a ring stage holds (so
#: BK = 128 / element size), and the largest cluster (the portable size)
SKINNY_ROWS = 16
SKINNY_BN = 32
SKINNY_RUN_BYTES = 128
SKINNY_MAX_CLUSTER = 8
#: bytes of A (rows x its K range) a skinny block stages at most; a deeper
#: range splits further, or takes the tiled kernel past 8 blocks
SKINNY_A_BYTES = 96 * 1024
#: K is split only for a B of more bytes than this (below, the cluster's
#: reduction costs more than idle SMs: 1 MiB of decode values read in
#: 0.0022 ms unsplit, 0.0036 ms split in two, on an H100), and then until
#: the grid has this many blocks, three for each SM (mlp.gate/up at
#: decode: 0.0065 ms at 176 blocks, 0.0056-0.0058 ms at 352-704)
SKINNY_SPLIT_BYTES = 2**20
SKINNY_TARGET_BLOCKS = 3 * SMS


@dataclasses.dataclass(frozen=True)
class SkinnyTile:
    """A skinny-kernel launch: K is split over ``split`` blocks of one
    cluster, each reducing ``kblk`` elements of K (a multiple of the stage
    depth ``skinny_bk``)."""

    split: int
    kblk: int

    def blocks(self, n: int, batch: int = 1) -> int:
        """Blocks of the grid for N columns and ``batch`` products."""
        return -(-n // SKINNY_BN) * batch * self.split


def skinny_bk(dtype: torch.dtype) -> int:
    """Elements of K in one ring stage of the skinny kernel."""
    return SKINNY_RUN_BYTES // dtype.itemsize


@functools.lru_cache(maxsize=4096)
def skinny_tile(m: int, n: int, k: int, batch: int,
                dtype: torch.dtype) -> SkinnyTile | None:
    """The skinny kernel's configuration for ``batch`` products of
    [m, k] @ [k, n], or None where it does not apply (more than 16 rows,
    an empty extent, or more A per block than ``SKINNY_A_BYTES`` even at
    the largest split).  The split is the smallest that keeps A's stage
    within ``SKINNY_A_BYTES`` and, for a B above ``SKINNY_SPLIT_BYTES``,
    gives the grid ``SKINNY_TARGET_BLOCKS`` blocks (else the largest K
    allows); every block of a cluster reduces a non-empty range of K."""
    if not (1 <= m <= SKINNY_ROWS and n >= 1 and k >= 1):
        return None
    bk = skinny_bk(dtype)
    stages = -(-k // bk)
    spread = n * k * batch * dtype.itemsize > SKINNY_SPLIT_BYTES
    best = None
    for split in range(1, min(SKINNY_MAX_CLUSTER, stages) + 1):
        kblk = -(-stages // split) * bk
        if m * kblk * dtype.itemsize > SKINNY_A_BYTES:
            continue
        best = SkinnyTile(split=-(-k // kblk), kblk=kblk)
        if not spread or best.blocks(n, batch) >= SKINNY_TARGET_BLOCKS:
            break
    return best


def check_skinny(tile: SkinnyTile, m: int, k: int,
                 dtype: torch.dtype) -> None:
    """Raise unless ``tile`` is a launch the skinny kernel takes for
    [m, k] operands of ``dtype``."""
    bk = skinny_bk(dtype)
    if not (1 <= m <= SKINNY_ROWS
            and 1 <= tile.split <= SKINNY_MAX_CLUSTER
            and tile.kblk >= bk and tile.kblk % bk == 0
            and (tile.split - 1) * tile.kblk < k <= tile.split * tile.kblk
            and m * tile.kblk * dtype.itemsize <= SKINNY_A_BYTES):
        raise ValueError(f"{tile} is not a skinny launch for M={m}, K={k}, "
                         f"{dtype}")


def copy_bytes(ptr: int, row_bytes: int) -> int:
    """The widest copy (16, 8 or 4 bytes) that keeps every row of an
    operand at ``ptr`` with rows of ``row_bytes`` aligned; 0 if none."""
    for width in (16, 8, 4):
        if ptr % width == 0 and row_bytes % width == 0:
            return width
    return 0


def b_col_major(b: torch.Tensor) -> int | None:
    """How the GEMM kernels read B: 0 row-major (B contiguous), 1
    column-major (the transpose of a contiguous tensor, which a single
    column of B also is: its K elements then lie in one run), None if
    neither."""
    if b.is_contiguous() and b.shape[-1] != 1:
        return 0
    if b.transpose(-1, -2).is_contiguous():
        return 1
    return 0 if b.is_contiguous() else None


def b_copy_bytes(b: torch.Tensor) -> int:
    """``copy_bytes`` of B: its rows run along N when it is read
    row-major, along K when column-major (``b_col_major``)."""
    inner = b.shape[-2] if b_col_major(b) else b.shape[-1]
    return copy_bytes(b.data_ptr(), inner * b.element_size())


def gemm_tile(a: torch.Tensor, b: torch.Tensor, tiled: tuple[int, ...]):
    """The launch configuration of ``a @ b`` (2-D, or batched 3-D): the
    skinny kernel's ``SkinnyTile`` for at most 16 rows of A when B's rows
    allow copies of 4 bytes or more, else the tiled kernel's tile
    ``tiled``."""
    m, k = a.shape[-2:]
    if m > SKINNY_ROWS or b_copy_bytes(b) < 4:
        return tiled
    batch = a.shape[0] if a.dim() == 3 else 1
    return skinny_tile(m, b.shape[-1], k, batch, a.dtype) or tiled


def gemm_tiles(plan: "ExecutionPlan", a: torch.Tensor,
               b: torch.Tensor) -> HopperTiles:
    """An mm or bmm plan's tiles beside the configuration that launches
    ``a @ b`` (``gemm_tile``; the tiled kernel's tile from
    ``hopper_tiles``)."""
    tiles = hopper_tiles(plan, b_col_major=b_col_major(b) == 1)
    return HopperTiles(plan=tiles.plan, tile=gemm_tile(a, b, tiles.tile))


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
