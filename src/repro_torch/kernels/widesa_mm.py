"""``C[m,n] = A[m,k] @ B[k,n]`` on the hand-written Hopper GEMMs.

The port of ``repro.kernels.widesa_mm`` (``mm_kernel``): the kernels
themselves are in ``csrc/widesa_mm.cu``, shared with ``bmm`` (mm is their
batch = 1 launch).  ``matmul`` checks its operands, allocates the output
and launches on the current stream the kernel its ``tiles`` name: a
``runtime.SkinnyTile`` runs the skinny kernel (A of at most 16 rows), a
``runtime.TcTile`` a tensor-core one (more rows: ``gemm_tc_kernel`` in
bf16 and float32, ``gemm_tc_int_kernel`` in the integers, after the limb
planes it reads are written to scratch by ``limb_planes_kernel``), a
``(BM, BN, BK)`` tuple the tiled one.  A CPU tensor runs the plain version
in ``ref.py`` instead.  ``launches`` counts kernel launches, ``variants``
the same launches by kernel.
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import build, ref, runtime

launches = 0
#: launches by kernel: ``skinny`` (M <= 16), ``wgmma`` (the tensor-core
#: kernels, floats and integers) and ``tiled``
variants = {"skinny": 0, "wgmma": 0, "tiled": 0}


def check_operands(a, b, tiles, out_dtype, *, batched: bool):
    """Validate a CUDA launch and return ``(out_dtype, lda, b_col_major,
    b_copy)``: A's row pitch (``runtime.a_pitch``), B's layout
    (``runtime.b_col_major``) and the bytes a copy of its rows may take
    (``runtime.copy_bytes``).

    A is contiguous or in padded rows; B is contiguous or the transpose of a
    contiguous tensor (read column-major, as the tied lm_head reads the
    embedding table).  ``tiles`` is a ``runtime.SkinnyTile`` that fits the
    shape (``runtime.check_skinny``) with B's rows aligned to 4 bytes or
    more, a ``runtime.TcTile`` a tensor-core kernel takes for these
    operands (``runtime.check_tc``), or a compiled ``(BM, BN, BK)`` of the
    tiled kernel (or one of the tiles its sweep times,
    ``build.SWEEP_TILES``).
    """
    nd = 3 if batched else 2
    if a.dim() != nd or b.dim() != nd:
        raise ValueError(f"expected {nd}-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"shapes do not chain: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} vs {b.dtype}")
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"operands must share one CUDA device, got "
                         f"{a.device} and {b.device}")
    out_dtype = out_dtype or runtime.out_dtype(a.dtype)
    if (a.dtype, out_dtype) not in build.COMPILED_DTYPES:
        raise TypeError(f"no kernel for {a.dtype} -> {out_dtype}")
    lda = runtime.a_pitch(a)
    if lda is None:
        raise ValueError("A must be contiguous or in evenly padded rows")
    col_major = runtime.b_col_major(b)
    if col_major is None:
        raise ValueError("B must be contiguous or a transposed contiguous "
                         "tensor")
    if batched and a.shape[0] > 65535:
        raise ValueError(f"batch {a.shape[0]} exceeds the grid")
    inner = b.shape[-2] if col_major else b.shape[-1]
    b_copy = runtime.copy_bytes(b.data_ptr(), inner * b.element_size())
    if isinstance(tiles, runtime.SkinnyTile):
        runtime.check_skinny(tiles, a.shape[-2], a.shape[-1], a.dtype)
        if b_copy < 4:
            raise ValueError("B's rows are not 4-byte aligned: the skinny "
                             "kernel cannot copy them (launch the tiled one)")
    elif isinstance(tiles, runtime.TcTile):
        runtime.check_tc(tiles, a, b)
    elif tuple(tiles) not in build.MM_TILES:
        raise ValueError(f"tile {tiles} is not compiled")
    elif math.ceil(b.shape[-1] / tiles[1]) > 65535:
        raise ValueError(f"grid too large for N={b.shape[-1]}, tile {tiles}")
    return out_dtype, lda, col_major, b_copy


def limb_planes(a, batch: int, m: int, n: int, k: int, col_major: int):
    """Scratch for the integer tensor-core GEMM's K-major byte planes of A
    and of B (``limb_planes_kernel``): [batch, rows, k-tiles x 128] bytes
    each, or None where the kernel reads the operand itself (an int8 A; an
    int8 B that is column-major)."""
    row = -(-k * a.element_size() // runtime.TC_ROW_BYTES) \
        * runtime.TC_ROW_BYTES
    wide = a.element_size() > 1

    def scratch(rows):
        return torch.empty((batch, rows, row), dtype=torch.uint8,
                           device=a.device)

    return (scratch(m) if wide else None,
            scratch(n) if wide or not col_major else None)


def launch(a, b, out, tiles, lda: int, col_major: int, b_copy: int,
           batched: bool) -> str:
    """Launch ``out = a @ b`` (operands checked by ``check_operands``) on
    the kernel ``tiles`` names, on the current stream of ``a``'s card;
    return that kernel's name (a key of ``variants``)."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = a.shape[0] if batched else 1
    codes = build.DTYPE_CODES[a.dtype], build.DTYPE_CODES[out.dtype]
    ptrs = a.data_ptr(), b.data_ptr(), out.data_ptr()
    guard = (contextlib.nullcontext()
             if a.device.index == torch.cuda.current_device()
             else torch.cuda.device(a.device))
    with guard:
        if isinstance(tiles, runtime.SkinnyTile):
            # 16-byte copies of A only where no run straddles K (a padded
            # row's tail is not zeros)
            size = a.element_size()
            a_vec = ptrs[0] % 16 == 0 and lda * size % 16 == 0 \
                and k * size % 16 == 0
            build.call("widesa_skinny_launch", *ptrs, batch, m, n, k, lda,
                       col_major, *codes, tiles.split, tiles.kblk, b_copy,
                       int(a_vec))
            return "skinny"
        if isinstance(tiles, runtime.TcTile) and a.is_floating_point():
            build.call("widesa_tc_launch", *ptrs, batch, m, n, k, lda,
                       col_major, *codes, tiles.bm, tiles.bn, tiles.stages,
                       tiles.split)
            return "wgmma"
        if isinstance(tiles, runtime.TcTile):
            planes = limb_planes(a, batch, m, n, k, col_major)
            build.call("widesa_tc_int_launch", *ptrs,
                       *(p.data_ptr() if p is not None else None
                         for p in planes), batch, m, n, k, lda, col_major,
                       codes[0], tiles.bm, tiles.bn, tiles.stages,
                       tiles.split)
            return "wgmma"
        if batched:
            build.call("widesa_bmm_launch", *ptrs, batch, m, n, k, lda,
                       col_major, *codes, tiles=tuple(tiles))
        else:
            build.call("widesa_mm_launch", *ptrs, m, n, k, lda, col_major,
                       *codes, tiles=tuple(tiles))
    return "tiled"


def matmul(a: torch.Tensor, b: torch.Tensor, *, tiles,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a[m,k] @ b[k,n]`` on the kernel ``tiles`` names (from
    ``runtime.gemm_tile``); floats give the input dtype (or
    ``out_dtype``), integers give int32."""
    global launches
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.mm(a, b, out_dtype)
    out_dtype, *layout = check_operands(a, b, tiles, out_dtype,
                                        batched=False)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype,
                      device=a.device)
    if out.numel() == 0:
        return out
    variants[launch(a, b, out, tiles, *layout, batched=False)] += 1
    launches += 1
    return out
