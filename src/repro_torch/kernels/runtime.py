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
  (``SKINNY_ROWS``), at any K: all serving GEMMs (decode batches, prompts
  of at most 16 tokens, 8-frame audio chunks, GQA rows, products over
  long contexts) and the fft2d stages.  Bytes of B bound them, so its
  configuration (``skinny_tile``, a ``SkinnyTile``) is computed from the
  shape alone (M, N, K, the batch and the dtype), not from the plan:
  blocks of 32 columns, and, for a B above 1 MiB, K split over the
  blocks of a cluster (at most 8) until the grid has three blocks for
  each of the card's 132 SMs, as far as K allows (``SKINNY_SPLIT_BYTES``,
  ``SKINNY_TARGET_BLOCKS``); for a smaller B whose column tiles leave SMs
  idle (the MoE router's float32 [d, 64]), until no block walks more than
  ``SKINNY_DEEP_STAGES`` ring stages of K.  A streams through the ring
  beside B, so nothing of it is staged whole.  B's layout and alignment
  decide the copy width (``b_copy_bytes``): rows of B must allow copies
  of at least 4 bytes; A's rows any (``a_copy_bytes``, plain loads where
  they allow no copy).
* The tensor-core kernels take A of more than 16 rows in bf16 (to bf16
  or fp32), float32 (3xTF32), int8, int16 and int32 (as int8 limbs; to
  int32) in any layout the GEMMs read (A contiguous or in padded rows,
  ``a_pitch``; B contiguous, the transpose of a contiguous tensor, or a
  slice of either's columns or rows read at the wider tensor's pitch,
  ``b_layout``).  ``gemm_tc_kernel`` (the floats) fills its ring by TMA
  where TMA can address an operand (``tma_operand``, ``tma_b``: a 16-byte
  aligned base, pitch and batch stride; the rows' own length is free),
  and otherwise by cp.async copies of the 8 or 4 bytes its rows allow
  (``tc_copies``, carried in ``TcTile.copies``), per operand; the integer
  kernel reads planes a pre-pass writes (``widesa_mm.limb_planes``) from
  any layout, but for an int8 K-major operand TMA can address, read as it
  is.
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
  else as many as it has (2 at the least).
* The tiled kernel (``hopper_tiles``, tiles ``build.COMPILED_TILES``)
  keeps two cases (``tiled_reason``): a B whose rows allow no 4-byte copy
  (an odd row of 2-byte elements, a storage offset of one element), and
  an integer K past 8 ranks' ``TC_INT_MAX_RANK_K``; above 16 rows also an
  A whose rows allow none, which the planned facade's backward pads first
  (``planned._a_rows``), so no planned path sends one.
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

fir (``fir_tile``, ``fir_config``): the plan's output block ({n: 103} on
the audio frontend) is a TPU tile and sets nothing.  The kernel runs on
the instantiation compiled for the filter's tap count (15, else the
generic one) with lanes of 4 consecutive outputs; a block of 256 lanes
walks chunks of 1024 outputs, or of 128 lanes chunks of 512 where 256
would leave SMs without a chunk (the frontend's 6180 outputs: 13 blocks
of 128 lanes, not 7 of 256).  The grid is as many blocks as the card
keeps resident (``FIR_SM_LANES`` lanes an SM, half for the complex FIR,
fewer where a block's ring of chunk slots, ``fir_smem``, fills the SM's
shared memory), at most one a chunk: at 1M outputs 528 blocks of 256
lanes each walk about two chunks, and every chunk's copy is issued
before the first chunk is computed.

conv2d and the one-sweep star stencils run the window kernels
(``csrc/window.cuh``): blocks of 4 warps side by side, 512 output
columns, each warp walking a band
of output rows.  The plan's block ({h: 8, w: 64} on the frontend; {i: 2,
j: 2} and {i: 12, j: 12} for the stencils at their bench sizes) is a TPU
tile and sets nothing: ``window_rows`` cuts the rows into the fewest bands
that still give each SM ``WINDOW_BLOCKS_PER_SM`` blocks (194 rows at the
bench sizes, one row a band for the frontend's 8 output rows), since a
band reads its rows' halo (P - 1 or 2R rows) a second time.  conv2d's
``Conv2dTile`` names the compiled filter window its P x Q runs on
(``conv2d_window``: 4 x 4, 8 x 8 and 5 x 4, else the generic
instantiation); the star's ``StarTile`` only the rows, since the star
(5 or 9 points) follows the recurrence.

jacobi2d_ms (``sweep_tile``) runs the multi-sweep kernel: T_b sweeps a
launch on 64 x 128 tiles of the state with a T_b-wide halo, so T sweeps
take ceil(T / T_b) launches (``SweepTile.launches``).  T_b is
min(T, ``build.SWEEP_MAX``): at 8 the two tile buffers (95 KB) still
leave room for a second block on an SM, and on an H100 T_b = 8 was the
fastest of 1, 2, 4 and 8 at the bench size (PERF.md, ``chip_smoke.py``);
the plan's block ({i: 89, j: 89} at the bench size) sets nothing
either.

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

fft2d (``fft2d_tile``, ``fft2d_route``) runs one of three forms, chosen
from the shape: the fused kernel of ``csrc/widesa_sp.cu`` (one launch, both
DFT stages, an ``Fft2dTile``) for grids of at most ``FFT2D_MAX_ROWS`` rows
whose passes fit in shared memory; else, where both sides are powers of two
up to ``FFT_MAX_SIDE``, the FFT kernel of ``csrc/widesa_fft.cu`` (a row
pass and a column pass of Stockham FFTs, an ``FftTile``: ``fft_config``);
else the composition of six GEMMs (``gemm_tile`` for each product, the
plan's tiled tile where neither the skinny nor the tensor-core kernel
applies).  At the largest grid the fused kernel takes, the recurrence
pipeline's 64 x 64, it ran in 0.0059 ms on an H100 against the
composition's 0.0385 (``chip_smoke.py --fft-sweep``; PERF.md).  It splits K
(the columns of the grid) over the blocks of a cluster, as far as the grid
stays within ``FFT2D_MAX_BLOCKS`` blocks (``fft2d_split``).  At the
pipeline's 8192^2 bench grids the FFT kernel replaces the composition's six
8192^3 products (PERF.md, PR 34).

``acc_dtype``/``out_dtype`` are the reference's accumulator ladder:
integer inputs accumulate and land in int32, floats accumulate in fp32
and land in the input dtype.

The route decisions that read an operand's address, the copy widths
(``copy_bytes``: ``a_copy_bytes``, ``b_copy_bytes``) and TMA's alignment
(``tma_operand``, ``tma_b``), take it
from ``address``: a tensor's ``data_ptr()``, or for a fake tensor (the
dry run's, ``launch/fakecuda.py``), which has no storage, its storage
offset in bytes over a base aligned to ``FAKE_BASE_ALIGN`` bytes, which
is what the caching allocator gives every block it hands out.  So a fake
operand takes the route the same operand would take on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import TYPE_CHECKING

import torch
from torch._subclasses.fake_tensor import FakeTensor

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
#: K is split only for a B of more bytes than this (below, the cluster's
#: reduction costs more than idle SMs: 1 MiB of decode values read in
#: 0.0022 ms unsplit, 0.0036 ms split in two, on an H100), and then until
#: the grid has this many blocks, three for each SM (mlp.gate/up at
#: decode: 0.0065 ms at 176 blocks, 0.0056-0.0058 ms at 352-704)
SKINNY_SPLIT_BYTES = 2**20
SKINNY_TARGET_BLOCKS = 3 * SMS
#: a B of at most ``SKINNY_SPLIT_BYTES`` is split all the same where its
#: column tiles are fewer than the SMs and a block would walk more than
#: this many ring stages of K: then until no rank walks more (or the
#: cluster is full).  On an H100 (``chip_smoke.py --skinny-sweep``,
#: PERF.md): the MoE router's float32 mm(4, 64, 2048), 2 blocks of 64
#: stages, took 0.0551 ms whole and 0.0097 ms at split 8; whisper-base's
#: d 512 projections at decode (8 stages) 0.0050 and 0.0036 at split 4;
#: its encoder chunk's values over 1024 frames (16 stages) 0.0086 and
#: 0.0044 at split 8; qwen's decode values (2 stages, 128 blocks) stay
#: whole (0.0024; split 2 0.0036)
SKINNY_DEEP_STAGES = 2


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
    [m, k] @ [k, n], at any K, or None where it does not apply (more than
    16 rows, an empty extent).  The split is the smallest that, for a B
    above ``SKINNY_SPLIT_BYTES``, gives the grid ``SKINNY_TARGET_BLOCKS``
    blocks, or, for a smaller B whose column tiles are fewer than the SMs,
    keeps each rank within ``SKINNY_DEEP_STAGES`` stages of K (else the
    largest K allows); every block of a cluster reduces a non-empty range
    of K."""
    if not (1 <= m <= SKINNY_ROWS and n >= 1 and k >= 1):
        return None
    bk = skinny_bk(dtype)
    stages = -(-k // bk)
    spread = n * k * batch * dtype.itemsize > SKINNY_SPLIT_BYTES
    deep = not spread and -(-n // SKINNY_BN) * batch < SMS
    best = None
    for split in range(1, min(SKINNY_MAX_CLUSTER, stages) + 1):
        kblk = -(-stages // split) * bk
        best = SkinnyTile(split=-(-k // kblk), kblk=kblk)
        if spread:
            if best.blocks(n, batch) >= SKINNY_TARGET_BLOCKS:
                break
        elif not deep or kblk // bk <= SKINNY_DEEP_STAGES:
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
            and (tile.split - 1) * tile.kblk < k <= tile.split * tile.kblk):
        raise ValueError(f"{tile} is not a skinny launch for M={m}, K={k}, "
                         f"{dtype}")


#: the alignment of the base of a block of the CUDA caching allocator,
#: taken as a fake tensor's base address (module docstring)
FAKE_BASE_ALIGN = 512


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor: shapes and dtypes on a device, no
    storage behind them (``torch._subclasses.FakeTensor``)."""
    return isinstance(t, FakeTensor)


def address(t: torch.Tensor) -> int:
    """The address a kernel would read ``t`` at: ``data_ptr()``, or for a
    fake tensor its storage offset in bytes over a ``FAKE_BASE_ALIGN``
    aligned base (module docstring)."""
    if is_fake(t):
        return FAKE_BASE_ALIGN + t.storage_offset() * t.element_size()
    return t.data_ptr()


def copy_bytes(ptr: int, row_bytes: int) -> int:
    """The widest copy (16, 8 or 4 bytes) that keeps every row of an
    operand at ``ptr`` with rows of ``row_bytes`` aligned; 0 if none."""
    for width in (16, 8, 4):
        if ptr % width == 0 and row_bytes % width == 0:
            return width
    return 0


def b_layout(b: torch.Tensor) -> tuple[int, int, int] | None:
    """How the GEMM kernels read B, as ``(col_major, pitch, batch
    stride)`` in elements, or None for a layout they do not read.

    Row-major (0): unit stride along N, rows of K ``pitch`` >= N apart
    (N for a contiguous B; a slice of a wider B's columns, a hierarchical
    column split's group, keeps the wider B's N).  Column-major (1): unit
    stride along K, columns ``pitch`` >= K apart (K for the transpose of a
    contiguous tensor, which a single column of B also is; a slice of its
    rows keeps the wider K).  Batch entries of a 3-D B lie ``batch
    stride`` apart, at least one entry's extent (a 2-D B, or a batch of
    one, takes that extent)."""
    k, n = b.shape[-2:]
    if b.is_contiguous() and n != 1:
        col, pitch = 0, n
    elif b.transpose(-1, -2).is_contiguous():
        col, pitch = 1, k
    elif b.is_contiguous():
        col, pitch = 0, n
    elif b.stride(-1) == 1 and b.stride(-2) >= n:
        col, pitch = 0, b.stride(-2)
    elif b.stride(-2) == 1 and b.stride(-1) >= k:
        col, pitch = 1, b.stride(-1)
    else:
        return None
    entry = (n if col else k) * pitch
    if b.dim() == 3 and b.shape[0] > 1:
        if b.stride(0) < entry:
            return None
        return col, pitch, b.stride(0)
    return col, pitch, entry


def b_col_major(b: torch.Tensor) -> int | None:
    """How the GEMM kernels read B: 0 row-major, 1 column-major, None if
    neither (``b_layout``)."""
    layout = b_layout(b)
    return None if layout is None else layout[0]


def b_pitch(b: torch.Tensor) -> int | None:
    """The pitch, in elements, at which the GEMM kernels read B's rows
    (of N, row-major) or columns (of K, column-major), or None
    (``b_layout``): N or K for a contiguous B or its transpose, the wider
    tensor's for a slice of its columns or rows."""
    layout = b_layout(b)
    return None if layout is None else layout[1]


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
    row-major, along K when column-major (``b_layout``); a copy must keep
    the row's length, its pitch and the batch stride aligned.  0 for a
    layout the GEMMs do not read."""
    layout = b_layout(b)
    if layout is None:
        return 0
    col, pitch, stride = layout
    size, ptr = b.element_size(), address(b)
    inner = b.shape[-2] if col else b.shape[-1]
    return min(copy_bytes(ptr, inner * size), copy_bytes(ptr, pitch * size),
               copy_bytes(ptr, stride * size))


#: the tensor-core kernel's geometry (``kTc*`` in csrc/widesa_mm.cu): its
#: threads (two consumer warpgroups and two producer warps), the bytes of K a
#: ring stage holds (one 128-byte swizzle row: 64 bf16, 32 float32), the
#: deepest ring (4 stages, which ran well ahead of 2 at the prefill
#: shapes on an H100: ``chip_smoke.py --tc-sweep``, PERF.md), the largest
#: cluster and the shared memory a block may use
TC_THREADS = 320
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
#: bf16 -> bf16 on the tensor-core kernel sums each output in the tensor
#: cores' accumulator, whose additions lose more than fp32 rounding; past
#: this K the wrappers launch the bf16 -> fp32 instantiation (each stage's
#: products added to the sums in fp32) and round its result to bf16.  At K
#: = 4096 the bf16 outputs stayed within one rounding of the fp32 product
#: on an H100; at 32768 and 151936 (the tied lm_head's dx in training)
#: 0.1 % and 0.7 % of them did not (PERF.md, PR 25)
TC_PROMOTE_K = 4096


def tc_promotes(tiles, dtype: torch.dtype, out_dtype: torch.dtype,
                k: int) -> bool:
    """Whether a launch on ``tiles`` runs bf16 -> fp32 and rounds to bf16
    after (``TC_PROMOTE_K``)."""
    return isinstance(tiles, TcTile) and dtype == torch.bfloat16 \
        and out_dtype == torch.bfloat16 and k > TC_PROMOTE_K


@dataclasses.dataclass(frozen=True)
class TcTile:
    """A tensor-core GEMM launch: a ``bm`` x ``bn`` output tile, a ring of
    ``stages`` stages of one k-tile (128 bytes of K), K split over
    ``split`` blocks of a cluster, A's and B's parts of each stage filled
    as ``copies`` says (``tc_copies``: 0 by TMA, else by cp.async copies
    of that many bytes; copies only in bf16 and float32: the integer
    kernel reads planes its pre-pass writes, which TMA always
    addresses)."""

    bm: int
    bn: int
    stages: int
    split: int = 1
    copies: tuple[int, int] = (0, 0)

    @property
    def producer(self) -> str:
        """What fills the ring: "tma", or "cp" where an operand comes by
        cp.async copies."""
        return "cp" if any(self.copies) else "tma"

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


def tma_operand(t: torch.Tensor, pitch: int) -> bool:
    """Whether TMA can address an operand at ``address(t)`` whose rows lie
    ``pitch`` elements apart: a 16-byte aligned base and pitch (the rows'
    own length is free: TMA zero-fills past it)."""
    return copy_bytes(address(t), pitch * t.element_size()) == 16


def tma_b(b: torch.Tensor) -> bool:
    """Whether the tensor-core kernels' TMA can address B (``b_layout``):
    a 16-byte aligned base, pitch and batch stride (its rows' own length
    is free, as A's)."""
    layout = b_layout(b)
    return layout is not None and min(
        copy_bytes(address(b), layout[1] * b.element_size()),
        copy_bytes(address(b), layout[2] * b.element_size())) == 16


def a_copy_bytes(a: torch.Tensor) -> int:
    """The widest copy (16, 8 or 4 bytes) of A's rows that keeps its base,
    its pitch and its rows' length aligned, so that no copy straddles a
    row's end (a padded row's tail is not zeros); 0 if none or A is in no
    layout the GEMMs read."""
    pitch = a_pitch(a)
    if pitch is None:
        return 0
    size, ptr = a.element_size(), address(a)
    return min(copy_bytes(ptr, pitch * size),
               copy_bytes(ptr, a.shape[-1] * size))


def tc_copies(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int] | None:
    """How ``gemm_tc_kernel``'s producer fills A's and B's parts of a
    stage: 0 by TMA (``tma_operand``, ``tma_b``: 16-byte aligned base,
    pitch and batch stride), else by cp.async copies of the width the
    rows allow (8 or 4 bytes, as ``a_copy_bytes`` and ``b_copy_bytes``);
    None where an operand allows neither (rows of an odd number of 2-byte
    elements, a storage offset of one element) or is in no layout the
    GEMMs read.  Each layout is read once: this runs at every launch."""
    pitch, layout = a_pitch(a), b_layout(b)
    if pitch is None or layout is None:
        return None
    widths = []
    for t, pitches, inner in (
            (a, (pitch,), a.shape[-1]),
            (b, layout[1:], b.shape[-2] if layout[0] else b.shape[-1])):
        ptr, size = address(t), t.element_size()
        tma = min(copy_bytes(ptr, p * size) for p in pitches)
        if tma == 16:
            widths.append(0)
            continue
        width = min(tma, copy_bytes(ptr, inner * size))
        if width < 4:
            return None
        widths.append(width)
    return widths[0], widths[1]


def tc_route(a: torch.Tensor, b: torch.Tensor) -> TcTile | None:
    """``tc_tile`` for ``a @ b`` where a tensor-core kernel takes the
    operands, else None.  Floats: both operands by TMA (producer "tma"),
    or an operand TMA cannot address by cp.async copies (producer "cp",
    ``tc_copies``); rows that allow neither have no route.  Integers: any
    layout the GEMMs read, since the limb pre-pass reads any and writes
    planes TMA addresses (an int8 K-major operand TMA can address is read
    as it is)."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if a.dtype not in TC_TILES or b.dtype != a.dtype:
        return None
    if a.is_floating_point():
        copies = tc_copies(a, b)
    else:
        copies = None if b_layout(b) is None or a_pitch(a) is None \
            else (0, 0)
    if copies is None:
        return None
    tile = tc_tile(m, n, k, a.dtype, a.shape[0] if a.dim() == 3 else 1)
    return tile if tile is None or copies == (0, 0) \
        else dataclasses.replace(tile, copies=copies)


def check_tc(tile: TcTile, a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise unless ``tile`` is a launch the tensor-core kernels take for
    these operands (``check_operands`` has checked shapes, dtypes and
    layouts): a compiled tile of the dtype, a legal ring and split, an
    integer rank's K within ``TC_INT_MAX_RANK_K``."""
    k = a.shape[-1]
    ktiles = -(-k * a.element_size() // TC_ROW_BYTES)
    if (tile.bm, tile.bn) not in TC_TILES.get(a.dtype, ()) \
            or not 2 <= tile.stages <= TC_MAX_STAGES \
            or not 1 <= tile.split <= TC_MAX_CLUSTER \
            or (tile.split - 1) * -(-ktiles // tile.split) >= ktiles \
            or (a.dtype in TC_INT_MAX_RANK_K and tc_rank_k(
                k, a.dtype, tile.split) > TC_INT_MAX_RANK_K[a.dtype]) \
            or tile.smem(a.dtype) > TC_MAX_SMEM \
            or not all(c in (0, 4, 8) for c in tile.copies) \
            or (tile.producer == "cp" and not a.is_floating_point()):
        raise ValueError(f"{tile} is not a tensor-core launch for {a.dtype} "
                         f"at K={k}")
    if not a.is_floating_point():
        return
    copies = tc_copies(a, b)
    if copies != tile.copies:
        raise ValueError(f"{tile} fills its ring with copies {tile.copies}, "
                         f"these operands need {copies} (0: TMA, which "
                         "needs 16-byte aligned bases, pitches and batch "
                         "strides; else cp.async copies of that width; "
                         "None: launch the tiled kernel)")


#: why ``gemm_tile`` leaves a product on the tiled kernel
#: (``tiled_reason``); the first two are the kernel's own cases
TILED_B_ROWS = "B's rows allow no 4-byte copy"
TILED_INT_K = "an integer K past 8 ranks' TC_INT_MAX_RANK_K"
TILED_A_ROWS = "A's rows allow no 4-byte copy (unpadded)"


def _route(a: torch.Tensor, b: torch.Tensor, tiled):
    """``gemm_tile``'s configuration of ``a @ b`` beside why it is the
    tiled kernel's ``tiled`` (``TILED_*``; None where another kernel
    takes the product, or for an empty extent)."""
    m, k = a.shape[-2:]
    if m <= SKINNY_ROWS:
        if b_copy_bytes(b) < 4:
            return tiled, TILED_B_ROWS
        batch = a.shape[0] if a.dim() == 3 else 1
        return skinny_tile(m, b.shape[-1], k, batch, a.dtype) or tiled, None
    tile = tc_route(a, b)
    if tile is not None:
        return tile, None
    if not a.is_floating_point() and a.dtype in TC_TILES:
        return tiled, TILED_INT_K
    if not tma_b(b) and b_copy_bytes(b) < 4:
        return tiled, TILED_B_ROWS
    return tiled, TILED_A_ROWS


def gemm_tile(a: torch.Tensor, b: torch.Tensor, tiled: tuple[int, ...]):
    """The launch configuration of ``a @ b`` (2-D, or batched 3-D): for at
    most 16 rows of A, the skinny kernel's ``SkinnyTile`` when B's rows
    allow copies of 4 bytes or more; for more rows, the tensor-core
    kernels' ``TcTile`` where they take the operands (``tc_route``); else
    the tiled kernel's tile ``tiled``."""
    return _route(a, b, tiled)[0]


def tiled_reason(a: torch.Tensor, b: torch.Tensor) -> str | None:
    """Why ``gemm_tile`` sends ``a @ b`` to the tiled kernel
    (``TILED_*``), or None where another kernel takes it."""
    return _route(a, b, None)[1]


def gemm_tiles(plan: "ExecutionPlan", a: torch.Tensor,
               b: torch.Tensor) -> HopperTiles:
    """An mm or bmm plan's tiles beside the configuration that launches
    ``a @ b`` (``gemm_tile``; the tiled kernel's tile from
    ``hopper_tiles``)."""
    tiles = hopper_tiles(plan, b_col_major=b_col_major(b) == 1)
    return HopperTiles(plan=tiles.plan, tile=gemm_tile(a, b, tiles.tile))


@dataclasses.dataclass(frozen=True)
class FirTile:
    """A FIR launch (``csrc/widesa_sp.cu`` ``fir_kernel``): the compiled
    tap count it runs on (``build.FIR_GENERIC`` for the generic
    instantiation), the lanes a block and the blocks of the grid.  A lane
    computes ``build.FIR_LANE_OUTPUTS`` consecutive outputs, so a block's
    chunk is ``lanes * 4`` outputs."""

    taps: int
    lanes: int
    blocks: int

    @property
    def chunk(self) -> int:
        return self.lanes * build.FIR_LANE_OUTPUTS


#: shared memory of one SM of an H100 that blocks may use, and what each
#: block reserves of it
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
#: bytes a FIR chunk slot holds past its inputs (``kFirSlack``)
FIR_SLACK = 64


def fir_smem(tile: FirTile, taps: int, elem: int, planes: int = 1) -> int:
    """Dynamic shared memory of a FIR block (``fir_launch``): for each
    plane, ``build.FIR_STAGES`` chunk slots (the chunk's inputs and halo
    from any 16-byte phase, the taps rounded up to 4, and the slack), and
    in the generic instantiation the taps (int8 packed four to a word,
    else 4 bytes each)."""
    tpad = -(-taps // 4) * 4
    slot = ((tile.chunk + tpad) * elem + 16 + FIR_SLACK + 15) // 16 * 16
    taps_bytes = 0
    if tile.taps == build.FIR_GENERIC:
        taps_bytes = (tpad + 15) // 16 * 16 if elem == 1 else 4 * tpad
    return planes * (taps_bytes + build.FIR_STAGES * slot)


def fir_config(n_out: int, taps: int, elem: int = 4, planes: int = 1,
               compiled: int | None = None) -> FirTile:
    """The FIR launch of ``n_out`` outputs of a ``taps``-tap filter on
    ``elem``-byte inputs, ``planes`` of them (2: the complex FIR), on the
    instantiation ``compiled`` (by default the tap count's own where
    compiled, else the generic one; module docstring)."""
    if compiled is None:
        compiled = taps if taps in build.FIR_TAPS else build.FIR_GENERIC
    small, large = build.FIR_LANES
    per_lane = build.FIR_LANE_OUTPUTS
    lanes = large if -(-n_out // (large * per_lane)) >= SMS else small
    chunks = -(-n_out // (lanes * per_lane))
    probe = FirTile(taps=compiled, lanes=lanes, blocks=1)
    resident = min(build.FIR_SM_LANES // planes // lanes,
                   SM_SMEM // (fir_smem(probe, taps, elem, planes)
                               + BLOCK_RESERVED_SMEM))
    return FirTile(taps=compiled, lanes=lanes,
                   blocks=max(1, min(chunks, SMS * resident)))


def fir_tile(plan: "ExecutionPlan", n_out: int,
             elem: int | None = None) -> HopperTiles:
    """A FIR plan's block beside the launch of its ``n_out`` outputs
    (``fir_config`` at the plan's tap count, its inputs ``elem`` bytes
    each: by default the plan's dtype's, 4 for the float32 planes of
    ``cfloat``)."""
    from . import registry

    rec = plan.recurrence
    if elem is None:
        elem = {"int8": 1, "int16": 2}.get(rec.dtype, 4)
    return HopperTiles(
        plan=(registry.get("fir").block_kwargs(plan)["bn"],),
        tile=fir_config(n_out, rec.extent("t"), elem))


#: blocks the window kernels' grid aims to give each SM (``window_rows``)
WINDOW_BLOCKS_PER_SM = 8
#: output columns a window kernel's block owns: 4 warps x 32 lanes x 4
WINDOW_BLOCK_COLS = build.WINDOW_WARPS * 32 * build.WINDOW_LANE_COLS


def window_rows(oh: int, ow: int, block_cols: int) -> int:
    """Output rows each warp of a window kernel (conv2d, the one-sweep
    star) walks for an ``oh`` x ``ow`` output, blocks ``block_cols``
    columns wide: the fewest that still give the card
    ``WINDOW_BLOCKS_PER_SM`` blocks an SM, or one output row a band
    (module docstring)."""
    across = -(-ow // block_cols)
    bands = max(1, min(oh, -(-SMS * WINDOW_BLOCKS_PER_SM // across)))
    return -(-oh // bands)


@dataclasses.dataclass(frozen=True)
class Conv2dTile:
    """A conv2d launch (``csrc/widesa_sp.cu`` ``conv2d_kernel``): the
    compiled filter window (P, Q), or ``build.CONV2D_GENERIC`` for the
    generic instantiation, and the output rows each warp walks."""

    window: tuple[int, int]
    rows: int


def conv2d_window(p: int, q: int) -> tuple[int, int]:
    """The compiled window a P x Q filter runs on: its own where compiled
    (``build.CONV2D_WINDOWS``), else the generic instantiation."""
    return (p, q) if (p, q) in build.CONV2D_WINDOWS else build.CONV2D_GENERIC


def conv2d_config(p: int, q: int, oh: int, ow: int,
                  window: tuple[int, int] | None = None) -> Conv2dTile:
    """The launch of an ``oh`` x ``ow`` conv2d output by a ``p`` x ``q``
    filter: on ``window`` (by default the one ``conv2d_window`` picks;
    ``build.CONV2D_GENERIC`` for the generic instantiation), in bands of
    the rows ``window_rows`` gives its blocks (``WINDOW_BLOCK_COLS``)."""
    window = conv2d_window(p, q) if window is None else tuple(window)
    return Conv2dTile(window=window,
                      rows=window_rows(oh, ow, WINDOW_BLOCK_COLS))


def conv2d_tile(plan: "ExecutionPlan", oh: int, ow: int) -> HopperTiles:
    """A conv2d plan's block beside the launch of its ``oh`` x ``ow``
    output (``conv2d_config``)."""
    from . import registry

    kw = registry.get("conv2d").block_kwargs(plan)
    rec = plan.recurrence
    return HopperTiles(plan=(kw["bh"], kw["bw"]), tile=conv2d_config(
        rec.extent("p"), rec.extent("q"), oh, ow))


@dataclasses.dataclass(frozen=True)
class StarTile:
    """A one-sweep star launch (``csrc/widesa_hpc.cu`` ``star_kernel``):
    the output rows each warp walks."""

    rows: int


def star_tile(oh: int, ow: int) -> StarTile:
    """The one-sweep star launch of an ``oh`` x ``ow`` output."""
    return StarTile(rows=window_rows(oh, ow, WINDOW_BLOCK_COLS))


@dataclasses.dataclass(frozen=True)
class SweepTile:
    """A multi-sweep stencil call (``csrc/widesa_hpc.cu``
    ``sweeps_kernel``): the sweeps T_b each launch fuses.  T sweeps take
    ``launches(T)`` launches, the last one the remainder."""

    sweeps: int

    def launches(self, t: int) -> int:
        return -(-t // self.sweeps)


def sweep_tile(t: int) -> SweepTile:
    """T_b for ``t`` sweeps (module docstring): as many as the kernel
    fuses, ``build.SWEEP_MAX``, and at most ``t``; 1 for no sweep."""
    return SweepTile(sweeps=max(1, min(t, build.SWEEP_MAX)))


def stencil_tile(plan: "ExecutionPlan") -> HopperTiles:
    """A star-stencil plan's block beside its launch: a ``SweepTile`` for
    jacobi2d_ms, else the ``StarTile`` of its output."""
    from . import registry

    rec = plan.recurrence
    kw = registry.get(rec.name).block_kwargs(plan)
    tile = (sweep_tile(rec.extent("t")) if rec.name == "jacobi2d_ms"
            else star_tile(rec.extent("i"), rec.extent("j")))
    return HopperTiles(plan=(kw["bh"], kw["bw"]), tile=tile)


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


#: the FFT kernel's geometry (``kStock*`` in csrc/widesa_fft.cu): complex
#: points a thread holds through a stage, the largest radix, the points a
#: block holds (both planes in shared memory, a pad word every 32), the
#: largest cluster and side
FFT_POINTS = 16
FFT_MAX_RADIX = 16
FFT_BLOCK_POINTS = 8192
FFT_MAX_CLUSTER = 16
FFT_MAX_SIDE = 8192
#: the row pass's points a block where rows are short (rows grouped), and
#: the column pass's columns a block (64 bytes a plane a row): at 8192^2
#: 16 columns over a cluster of 16 ran fastest of the strips 4-16, each on
#: the least cluster that holds it (``chip_smoke.py --fft-sweep``; PERF.md)
FFT_ROW_POINTS = 4096
FFT_STRIP = 16


@dataclasses.dataclass(frozen=True)
class FftTile:
    """An FFT launch (csrc/widesa_fft.cu): the row pass's radices and rows
    a block; the column pass's radices within a block, columns a block
    (``strip``) and blocks a column (``cluster``: a last radix-``cluster``
    stage across the cluster's shared memory when above 1)."""

    row_radices: tuple[int, ...]
    col_radices: tuple[int, ...]
    rows: int
    strip: int
    cluster: int


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def fft_radices(n: int) -> tuple[int, ...]:
    """The radix plan of an n-point FFT (n a power of two): as few stages
    as radix ``FFT_MAX_RADIX`` allows, log2 n spread evenly over them, the
    larger radices first."""
    bits = n.bit_length() - 1
    stages = max(1, -(-bits // 4))
    base, extra = divmod(bits, stages)
    return tuple([2 ** (base + 1)] * extra + [2 ** base] * (stages - extra))


def fft_config(nr: int, nc: int, rows: int | None = None,
               strip: int | None = None,
               cluster: int | None = None) -> FftTile:
    """The FFT launch of an ``nr`` x ``nc`` grid: ``FFT_ROW_POINTS`` points
    a row-pass block (whole rows, at least one), ``FFT_STRIP`` columns a
    column-pass block, and the smallest cluster whose blocks hold their
    share of a column; each may be given instead (``chip_smoke.py
    --fft-sweep``)."""
    if rows is None:
        rows = min(nr, max(1, FFT_ROW_POINTS // nc))
    if strip is None:
        strip = min(nc, FFT_STRIP)
    if cluster is None:
        cluster = 1
        while cluster < FFT_MAX_CLUSTER \
                and nr // cluster * strip > FFT_BLOCK_POINTS:
            cluster *= 2
    return FftTile(row_radices=fft_radices(nc),
                   col_radices=fft_radices(max(1, nr // cluster)),
                   rows=rows, strip=strip, cluster=cluster)


def fft_allows(nr: int, nc: int, tile: FftTile) -> bool:
    """Whether the FFT kernel takes an ``nr`` x ``nc`` grid on ``tile``
    (``launch_fft`` in csrc/widesa_fft.cu checks the same): both sides
    powers of two from 2 to ``FFT_MAX_SIDE``, blocks of whole rows and
    strips within ``FFT_BLOCK_POINTS`` points and at least a thread's,
    radix plans of radices 2 to ``FFT_MAX_RADIX`` over each side."""
    if not (_pow2(nr) and _pow2(nc) and 2 <= nr <= FFT_MAX_SIDE
            and 2 <= nc <= FFT_MAX_SIDE):
        return False
    rows, strip, cluster = tile.rows, tile.strip, tile.cluster
    if not (_pow2(rows) and rows <= nr and _pow2(strip) and strip <= nc
            and _pow2(cluster) and cluster <= FFT_MAX_CLUSTER
            and cluster < nr):
        return False
    col_n = nr // cluster
    if not all(FFT_POINTS <= pts <= FFT_BLOCK_POINTS
               for pts in (rows * nc, col_n * strip)):
        return False

    def covers(radices, n):
        return 1 <= len(radices) <= 8 and math.prod(radices) == n and all(
            _pow2(r) and 2 <= r <= FFT_MAX_RADIX for r in radices)

    return covers(tile.row_radices, nc) and covers(tile.col_radices, col_n)


def radix_logs(radices) -> int:
    """A radix plan as the kernel takes it: log2 of each radix, 4 bits a
    stage, the first stage lowest."""
    return sum((r.bit_length() - 1) << (4 * s) for s, r in enumerate(radices))


def fft2d_route(nr: int, nc: int) -> Fft2dTile | FftTile | None:
    """The form that runs an ``nr`` x ``nc`` grid (module docstring): the
    fused kernel's configuration, else the FFT kernel's, else None where
    the composition runs."""
    split = fft2d_split(nr, nc)
    if fft2d_allows(nr, nc, split):
        return Fft2dTile(split=split)
    tile = fft_config(nr, nc)
    return tile if fft_allows(nr, nc, tile) else None


def fft2d_tile(plan: "ExecutionPlan", x_re: torch.Tensor,
               x_im: torch.Tensor) -> HopperTiles:
    """An fft2d_stage plan's tiles beside the form that runs the grid
    ``x_re + i x_im``: the fused kernel's ``Fft2dTile`` or the FFT
    kernel's ``FftTile`` (``fft2d_route``), else the tiled tile the
    composition falls back to (``hopper_tiles``)."""
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
