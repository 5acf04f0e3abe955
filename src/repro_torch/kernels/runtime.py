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

mm, bmm and the fft2d composition's products run one of four kernels of
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
* The tensor-core kernels take A of more than 16 rows in bf16 (to bf16
  or fp32), float32 (3xTF32), int8, int16 and int32 (as int8 limbs; to
  int32) where TMA can address both operands (``tma_operand``: a 16-byte
  aligned base, rows of whole 16-byte units, so a contiguous integer A
  needs K % 16 == 0 in int8, K % 8 in int16, K % 4 in int32; A
  contiguous or in padded rows, ``a_pitch``; B contiguous or the
  transpose of a contiguous tensor).
  Their configuration is a ``TcTile`` (``tc_tile``) from the shape and
  the dtype: bf16 runs a 128-row tile 128 columns wide from N =
  ``TC_WIDE_N`` up, 64 below; float32 a tile 128 columns wide and 64 or
  128 rows tall; int8 a 128-row tile 256 columns wide from N =
  ``TC_WIDE_N`` up, 64 below; int16 and int32 a 128 x 64 tile (their 3
  and 4 accumulator sets).  Where the output tiles leave SMs idle, K is
  split over the blocks of a cluster (at most ``TC_MAX_SPLIT``, each rank
  at least ``TC_MIN_RANK_KTILES`` k-tiles of 128 bytes of K) as far as
  the grid stays within one block an SM; an integer rank reduces at most
  ``TC_INT_MAX_RANK_K`` of K, where the split grows to the portable
  cluster's 8 if it must (no s32 accumulator set can then leave int32).
  A ring of ``TC_MAX_STAGES`` stages where a rank has that many k-tiles,
  else as many as it has (2 at the least).  An integer launch reads its
  operands by TMA as int8 limb planes that a pre-pass writes to scratch
  (``widesa_mm.limb_planes``), but for an int8 K-major operand, read as it
  is.
* The tiled kernel (``hopper_tiles``, tiles ``build.COMPILED_TILES``)
  takes the rest: operands TMA cannot address, an integer K past 8 ranks'
  ``TC_INT_MAX_RANK_K``, and B rows the skinny kernel cannot copy (not
  4-byte aligned: a storage offset, or an odd row of 2-byte elements).
  BM is the smallest compiled row count that covers the plan's row tile
  (the largest where none does; the kernel masks ragged edges, so any
  compiled tile is a legal launch).  BN is not the plan's column tile: each BM is compiled
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

The star stencils (``stencil_tile``): the reference planner's
single-chip plans are TPU tiles again ({i: 2, j: 2}, {i: 12, j: 12},
{i: 89, j: 89} for the three stencils at their bench sizes).  The kernel
is compiled for one tile, a 256-thread block of 4 x 4 outputs a thread
(``build.STENCIL_TILE``), which every plan maps onto: the path runs them
at the bench sizes only, where it was the faster of two tiles on an H100
(PERF.md).

mttkrp runs one of two kernels of ``csrc/widesa_hpc.cu`` (``mttkrp_tile``,
``mttkrp_route``), chosen from the dtype and the shape, not from the plan
(``bj = 8`` at the bench size, a TPU tile):

* The tensor-core kernel takes float32 (3xTF32), int8, and int16 and
  int32 as int8 limbs, where X's rows allow copies of 4 bytes or more
  (L % 4 == 0 in int8, L even in int16), B's rows allow copies of 4
  bytes (J % 4 == 0 in int8, J even in int16), C's tile fits in shared
  memory next to the ring (``mttkrp_smem``: float32 up to L = 256, int8
  up to L = 2048, int16 up to 1024, int32 up to 512).  Its output tile is fixed
  (``MTTKRP_TC_TILE``, 128 x 80); the configuration is an
  ``MttkrpTile``: X's copy width (16 bytes where rows and pointer allow
  it, else 4) and the split of K over the blocks of a cluster
  (``mttkrp_split``): 8, the portable maximum, where every rank keeps 16
  k or more, else the largest power of two that does.  One block fills
  an SM, so the 160 tiles of the bench size alone are 1.2 waves of 132;
  split 8 makes 1280 blocks.  On an H100 it was the fastest of the
  splits 1 to 8 in float32 and within 7 % of the fastest (2) in int8,
  and clusters of 3, 5, 6 and 7 were slower than their neighbours
  (``chip_smoke.py --mttkrp-sweep``; PERF.md).
* The CUDA-core kernel (``build.MTTKRP_TILE``) takes what the
  tensor-core kernel refuses.

fft2d (``fft2d_tile``, ``fft2d_route``) runs one of two forms, chosen from
the shape: the fused kernel of ``csrc/widesa_sp.cu`` (one launch, both DFT
stages, an ``Fft2dTile``) for grids of at most ``FFT2D_MAX_ROWS`` rows
whose passes fit in shared memory, else the composition of six GEMMs
(``gemm_tile`` for each product, the plan's tiled tile where neither the
skinny nor the tensor-core kernel applies).  At the largest grid it takes,
the recurrence pipeline's 64 x 64, the fused kernel ran in 0.0059 ms on
an H100 against the composition's 0.0385 (``chip_smoke.py --fft-sweep``;
PERF.md).  It splits K (the columns of the grid) over the blocks of a
cluster, as far as the grid stays within ``FFT2D_MAX_BLOCKS`` blocks
(``fft2d_split``).

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


def a_pitch(a: torch.Tensor) -> int | None:
    """The row pitch, in elements, at which the GEMM kernels read A: K for
    a contiguous A, the row stride of one whose rows are padded (unit
    stride along K, rows evenly pitched, batch entries M rows apart), None
    for any other layout."""
    if a.is_contiguous():
        return a.shape[-1]
    m, k = a.shape[-2:]
    pitch = a.stride(-2)
    if a.stride(-1) != 1 or pitch < k or (
            a.dim() == 3 and a.shape[0] > 1 and a.stride(0) != m * pitch):
        return None
    return pitch


def b_copy_bytes(b: torch.Tensor) -> int:
    """``copy_bytes`` of B: its rows run along N when it is read
    row-major, along K when column-major (``b_col_major``)."""
    inner = b.shape[-2] if b_col_major(b) else b.shape[-1]
    return copy_bytes(b.data_ptr(), inner * b.element_size())


#: the tensor-core kernel's geometry (``kTc*`` in csrc/widesa_mm.cu): its
#: threads (two consumer warpgroups and a producer warp), the bytes of K a
#: ring stage holds (one 128-byte swizzle row: 64 bf16, 32 float32), the
#: deepest ring (4 stages, which ran well ahead of 2 at the prefill
#: shapes on an H100: ``chip_smoke.py --tc-sweep``, PERF.md), the largest
#: cluster and the shared memory a block may use
TC_THREADS = 288
TC_ROW_BYTES = 128
TC_MAX_STAGES = 4
TC_MAX_CLUSTER = 8
TC_MAX_SMEM = 232448
#: the compiled output tiles (BM, BN) by input dtype (``launch_tc_*``)
TC_TILES = {torch.bfloat16: ((128, 64), (128, 128)),
            torch.float32: ((64, 128), (128, 128)),
            torch.int8: ((128, 64), (128, 256)),
            torch.int16: ((128, 64),),
            torch.int32: ((128, 64),)}
#: the most K a rank of a split reduces in each integer dtype
#: (``kTc*MaxRankK`` in the source): (2^31 - 1) over the most one element
#: of K adds to an s32 accumulator set of limb products (int8: 128 x 128;
#: int16: 2 x 255 x 128, its shift-8 set; int32: 2 x 255^2 + 2 x 255 x 128,
#: its shift-24 set), so no set leaves int32
TC_INT_MAX_RANK_K = {torch.int8: 131071, torch.int16: 32896,
                     torch.int32: 10994}
#: bf16 and int8 take their wide tile from this N up (qwen's gate/up, N =
#: 2816; the paper's MM/BMM), the narrow one below (q/k/v/o, down, the
#: scores and values, the pipeline's smoke shapes); K is split over at
#: most this many blocks, only while the grid stays
#: within one block an SM and every rank keeps this many k-tiles: the
#: fastest choices at the prefill shapes of 64-512 tokens on an H100
#: (``chip_smoke.py --tc-sweep``, PERF.md)
TC_WIDE_N = 2048
TC_MAX_SPLIT = 4
TC_MIN_RANK_KTILES = 4


@dataclasses.dataclass(frozen=True)
class TcTile:
    """A tensor-core GEMM launch: a ``bm`` x ``bn`` output tile, a ring of
    ``stages`` stages of one k-tile (128 bytes of K), K split over
    ``split`` blocks of a cluster."""

    bm: int
    bn: int
    stages: int
    split: int = 1

    def blocks(self, m: int, n: int, batch: int = 1) -> int:
        """Blocks of the grid for an M x N output and ``batch`` products."""
        return -(-m // self.bm) * -(-n // self.bn) * batch * self.split

    def smem(self, dtype: torch.dtype) -> int:
        """Shared memory a block takes (``tc_smem`` in the source): the
        ring, each stage A's and B's tiles (and, in float32, A's low
        parts), or the fp32 partial tile with rows padded by 4 values if
        that is larger; the 1 KB the swizzle's alignment may cost; the
        barriers."""
        rows = self.bm + self.bn + (self.bm if dtype == torch.float32 else 0)
        ring = self.stages * rows * TC_ROW_BYTES
        return max(ring, self.bm * (self.bn + 4) * 4) + 1024 \
            + 2 * TC_MAX_STAGES * 8


def tc_rank_k(k: int, dtype: torch.dtype, split: int) -> int:
    """Elements of K the ranks of a split reduce at most: whole k-tiles of
    128 bytes."""
    ktiles = -(-k * dtype.itemsize // TC_ROW_BYTES)
    return -(-ktiles // split) * (TC_ROW_BYTES // dtype.itemsize)


def tc_tile(m: int, n: int, k: int, dtype: torch.dtype,
            batch: int = 1) -> TcTile | None:
    """The tensor-core kernels' configuration for ``batch`` products of
    [m, k] @ [k, n] in ``dtype``, or None for a dtype they do not take or
    an integer K that 8 ranks cannot hold (module docstring)."""
    if dtype not in TC_TILES or min(m, n, k, batch) < 1:
        return None
    if dtype == torch.float32:
        bm, bn = 64 if m <= 64 else 128, 128
    elif dtype in (torch.bfloat16, torch.int8):
        wide, narrow = TC_TILES[dtype][1][1], TC_TILES[dtype][0][1]
        bm, bn = 128, wide if n >= TC_WIDE_N else narrow
    else:
        bm, bn = TC_TILES[dtype][0]
    ktiles = -(-k * dtype.itemsize // TC_ROW_BYTES)
    tiles = -(-m // bm) * -(-n // bn) * batch
    split = max(1, min(TC_MAX_SPLIT, ktiles // TC_MIN_RANK_KTILES,
                       SMS // tiles))
    if dtype in TC_INT_MAX_RANK_K:
        while split <= TC_MAX_CLUSTER \
                and tc_rank_k(k, dtype, split) > TC_INT_MAX_RANK_K[dtype]:
            split += 1
        if split > TC_MAX_CLUSTER:
            return None
    split = -(-ktiles // -(-ktiles // split))  # no rank without a k-tile
    stages = min(TC_MAX_STAGES, max(2, -(-ktiles // split)))
    return TcTile(bm=bm, bn=bn, stages=stages, split=split)


def tma_operand(t: torch.Tensor, inner: int) -> bool:
    """Whether TMA can address an operand at ``t.data_ptr()`` whose rows
    hold ``inner`` elements: a 16-byte aligned base and rows of whole
    16-byte units."""
    return copy_bytes(t.data_ptr(), inner * t.element_size()) == 16


def tc_route(a: torch.Tensor, b: torch.Tensor) -> TcTile | None:
    """``tc_tile`` for ``a @ b`` where a tensor-core kernel takes the
    operands (a dtype it has, A and B in layouts the GEMMs read, both
    addressable by TMA at A's row pitch), else None."""
    layout, pitch = b_col_major(b), a_pitch(a)
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if a.dtype not in TC_TILES or b.dtype != a.dtype or layout is None \
            or pitch is None or not tma_operand(a, pitch) \
            or not tma_operand(b, k if layout else n):
        return None
    return tc_tile(m, n, k, a.dtype, a.shape[0] if a.dim() == 3 else 1)


def check_tc(tile: TcTile, a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise unless ``tile`` is a launch the tensor-core kernels take for
    these operands (``check_operands`` has checked shapes, dtypes and
    layouts): a compiled tile of the dtype, a legal ring and split, an
    integer rank's K within ``TC_INT_MAX_RANK_K``."""
    layout = b_col_major(b)
    k, n = a.shape[-1], b.shape[-1]
    ktiles = -(-k * a.element_size() // TC_ROW_BYTES)
    if (tile.bm, tile.bn) not in TC_TILES.get(a.dtype, ()) \
            or not 2 <= tile.stages <= TC_MAX_STAGES \
            or not 1 <= tile.split <= TC_MAX_CLUSTER \
            or (tile.split - 1) * -(-ktiles // tile.split) >= ktiles \
            or (a.dtype in TC_INT_MAX_RANK_K and tc_rank_k(
                k, a.dtype, tile.split) > TC_INT_MAX_RANK_K[a.dtype]) \
            or tile.smem(a.dtype) > TC_MAX_SMEM:
        raise ValueError(f"{tile} is not a tensor-core launch for {a.dtype} "
                         f"at K={k}")
    if not (tma_operand(a, a_pitch(a))
            and tma_operand(b, k if layout else n)):
        raise ValueError("TMA cannot address these operands (bases must be "
                         "16-byte aligned and rows whole 16-byte units): "
                         "launch the tiled kernel")


def gemm_tile(a: torch.Tensor, b: torch.Tensor, tiled: tuple[int, ...]):
    """The launch configuration of ``a @ b`` (2-D, or batched 3-D): for at
    most 16 rows of A, the skinny kernel's ``SkinnyTile`` when B's rows
    allow copies of 4 bytes or more; for more rows, the tensor-core
    kernels' ``TcTile`` where they take the operands (``tc_route``); else
    the tiled kernel's tile ``tiled``."""
    m, k = a.shape[-2:]
    if m > SKINNY_ROWS:
        return tc_route(a, b) or tiled
    if b_copy_bytes(b) < 4:
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


#: the tensor-core MTTKRP kernel's geometry (``kTc*`` in
#: csrc/widesa_hpc.cu): its output tile (BI, BJ), the bytes of l a ring
#: stage holds, its stages, the rows of B it holds, the bytes padding a row
#: of X in a stage, the largest cluster (the portable size) and the shared
#: memory a block may use
MTTKRP_TC_TILE = (128, 80)
MTTKRP_TC_CHUNK = 128
MTTKRP_TC_STAGES = 3
MTTKRP_TC_B_SLOTS = 4
MTTKRP_TC_PAD = 32
MTTKRP_TC_MAX_CLUSTER = 8
MTTKRP_TC_MAX_SMEM = 232448
#: the input dtypes it takes (int16 and int32 as int8 limbs)
MTTKRP_TC_DTYPES = (torch.float32, torch.int8, torch.int16, torch.int32)
#: k a rank of a split reduces at the least
MTTKRP_MIN_RANK_K = 16


@dataclasses.dataclass(frozen=True)
class MttkrpTile:
    """A tensor-core MTTKRP launch: K split over ``split`` blocks of a
    cluster, X copied ``copy`` bytes at a time (16 or 4)."""

    split: int
    copy: int


def mttkrp_smem(nl: int, dtype: torch.dtype) -> int:
    """Shared memory of a tensor-core MTTKRP block: C's tile (80 columns
    of L rounded up to whole stages, as planes: hi and lo in float32, one
    of bytes a limb of an integer) and the ring of X (rows padded by
    ``MTTKRP_TC_PAD``)."""
    row = -(-nl * dtype.itemsize // MTTKRP_TC_CHUNK) * MTTKRP_TC_CHUNK
    if dtype == torch.float32:
        planes, plane_row = 2, row
    else:
        planes, plane_row = dtype.itemsize, row // dtype.itemsize
    return (planes * MTTKRP_TC_TILE[1] * plane_row
            + MTTKRP_TC_STAGES * MTTKRP_TC_TILE[0]
            * (MTTKRP_TC_CHUNK + MTTKRP_TC_PAD)
            + MTTKRP_TC_B_SLOTS * MTTKRP_TC_TILE[1] * dtype.itemsize)


def mttkrp_split(nk: int) -> int:
    """The split of K: the largest power of two up to the portable
    cluster size (8) that leaves every rank ``MTTKRP_MIN_RANK_K`` k or
    more (module docstring)."""
    split = MTTKRP_TC_MAX_CLUSTER
    while split > 1 and -(-nk // split) < MTTKRP_MIN_RANK_K:
        split //= 2
    return split


def mttkrp_route(shape: tuple[int, int, int, int], dtype: torch.dtype,
                 x_ptr: int = 0, b_ptr: int = 0) -> MttkrpTile | None:
    """The tensor-core kernel's configuration for X of ``shape`` = (I, J,
    K, L) in ``dtype`` at address ``x_ptr`` and B at ``b_ptr``, or None
    where it does not apply and the CUDA-core kernel runs (module
    docstring)."""
    ni, nj, nk, nl = shape
    if dtype not in MTTKRP_TC_DTYPES or min(shape) < 1:
        return None
    width = copy_bytes(x_ptr, nl * dtype.itemsize)
    if width < 4 or copy_bytes(b_ptr, nj * dtype.itemsize) < 4 \
            or nk * nl >= 2**31 \
            or mttkrp_smem(nl, dtype) > MTTKRP_TC_MAX_SMEM:
        return None
    return MttkrpTile(split=mttkrp_split(nk), copy=16 if width == 16 else 4)


def mttkrp_tile(plan: "ExecutionPlan", x: torch.Tensor | None = None,
                b: torch.Tensor | None = None) -> HopperTiles:
    """An mttkrp plan's tile beside the configuration that launches it
    (``mttkrp_route``, else the CUDA-core kernel's ``build.MTTKRP_TILE``),
    from the plan's extents and dtype, and X's and B's addresses where
    given."""
    from . import registry

    kw = registry.get("mttkrp").block_kwargs(plan)
    rec = plan.recurrence
    shape = tuple(rec.extent(loop) for loop in ("i", "j", "k", "l"))
    dtype = getattr(torch, rec.dtype) if x is None else x.dtype
    route = mttkrp_route(shape, dtype, 0 if x is None else x.data_ptr(),
                         0 if b is None else b.data_ptr())
    return HopperTiles(plan=(kw["bi"], kw["bj"], kw["bk"], kw["bl"]),
                       tile=route or build.MTTKRP_TILE)


#: the fused fft2d kernel's geometry (``kFft*`` in csrc/widesa_sp.cu): its
#: output tile (rows, columns), its warps' k groups, the k a pass stages,
#: the rows of X a pass holds at most, the largest cluster and the shared
#: memory a block may use
FFT2D_TILE = (16, 32)
FFT2D_K_GROUPS = 8
FFT2D_CHUNK = 128
FFT2D_MAX_ROWS = 64
FFT2D_MAX_CLUSTER = 8
FFT2D_MAX_SMEM = 232448
#: k a rank of a split reduces at the least, and the blocks a split may
#: fill: on an H100 at 12 x 515 (17 column tiles) clusters of 6 (102
#: blocks) ran in 0.0064 ms, of 5 in 0.0068, of 7 (119) in 0.0077 and of 8
#: (136) in 0.0073 (``chip_smoke.py --fft-sweep``, profiler device time;
#: PERF.md)
FFT2D_MIN_RANK_K = 8
FFT2D_MAX_BLOCKS = 104


@dataclasses.dataclass(frozen=True)
class Fft2dTile:
    """A fused fft2d launch: K split over ``split`` blocks of a cluster."""

    split: int


def fft2d_smem(nr: int, kc: int) -> int:
    """Shared memory of a fused fft2d block for R = ``nr`` and passes of
    ``kc`` k (a multiple of 4): F_C's rows and X's columns of a pass, F_R's
    tile rows and Y's pass with its sums, or, after the passes, the sums of
    the 8 warps (each a k group) over the tile, whichever is larger; then
    the partial tiles a split's ranks send the block."""
    rows, cols = FFT2D_TILE
    passes = 2 * kc * cols + 2 * nr * kc + 2 * nr * rows + 3 * kc * rows
    return 4 * (max(passes, FFT2D_K_GROUPS * 2 * rows * cols)
                + 2 * rows * cols + FFT2D_MAX_CLUSTER)


def fft2d_split(nr: int, nc: int) -> int:
    """The split of K (the grid's C columns): the largest cluster, up to
    the portable 8, that keeps the grid within ``FFT2D_MAX_BLOCKS`` blocks
    and every rank at ``FFT2D_MIN_RANK_K`` k or more; 1 where none does."""
    rows, cols = FFT2D_TILE
    tiles = -(-nr // rows) * -(-nc // cols)
    for split in range(FFT2D_MAX_CLUSTER, 1, -1):
        if tiles * split <= FFT2D_MAX_BLOCKS \
                and -(-nc // split) >= FFT2D_MIN_RANK_K:
            return split
    return 1


def fft2d_allows(nr: int, nc: int, split: int) -> bool:
    """Whether the fused kernel takes an ``nr`` x ``nc`` grid with K split
    over ``split`` blocks: at most ``FFT2D_MAX_ROWS`` rows, no rank
    without k, passes that fit in shared memory."""
    if not 1 <= nr <= FFT2D_MAX_ROWS or nc < 1 \
            or not 1 <= split <= min(FFT2D_MAX_CLUSTER, nc):
        return False
    kblk = -(-nc // split)
    kc = -(-min(kblk, FFT2D_CHUNK) // 4) * 4
    return (split - 1) * kblk < nc and fft2d_smem(nr, kc) <= FFT2D_MAX_SMEM


def fft2d_route(nr: int, nc: int) -> Fft2dTile | None:
    """The fused kernel's configuration for an ``nr`` x ``nc`` grid, or
    None where the composition runs (module docstring)."""
    split = fft2d_split(nr, nc)
    return Fft2dTile(split=split) if fft2d_allows(nr, nc, split) else None


def fft2d_tile(plan: "ExecutionPlan", x_re: torch.Tensor,
               x_im: torch.Tensor) -> HopperTiles:
    """An fft2d_stage plan's tiles beside the form that runs the grid
    ``x_re + i x_im``: the fused kernel's ``Fft2dTile`` (``fft2d_route``),
    else the tiled tile the composition falls back to
    (``hopper_tiles``)."""
    tiles = hopper_tiles(plan)
    return HopperTiles(plan=tiles.plan,
                       tile=fft2d_route(*x_re.shape) or tiles.tile)


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
