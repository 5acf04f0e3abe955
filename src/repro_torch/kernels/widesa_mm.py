"""``C[m,n] = A[m,k] @ B[k,n]`` on the hand-written Hopper GEMM.

The port of ``repro.kernels.widesa_mm`` (``mm_kernel``): the kernel itself
is ``csrc/widesa_mm.cu``, shared with ``bmm`` (mm is its batch = 1
launch).  ``matmul`` checks its operands, allocates the output and
launches on the current stream; a CPU tensor runs the plain version in
``ref.py`` instead.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from . import build, ref, runtime

launches = 0


def check_operands(a, b, tiles, out_dtype, *, batched: bool):
    """Validate a CUDA launch and return ``(out_dtype, b_col_major)``.

    A must be contiguous; B is contiguous or the transpose of a
    contiguous tensor (read column-major, as the tied lm_head reads the
    embedding table); ``tiles`` must be a compiled ``(BM, BN, BK)``, or
    one of the tiles the sweep times (``build.SWEEP_TILES``).
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
    if tuple(tiles) not in build.COMPILED_TILES + build.SWEEP_TILES:
        raise ValueError(f"tile {tiles} is not compiled")
    if not a.is_contiguous():
        raise ValueError("A must be contiguous")
    if b.is_contiguous():
        col_major = 0
    elif b.transpose(-1, -2).is_contiguous():
        col_major = 1
    else:
        raise ValueError("B must be contiguous or a transposed contiguous "
                         "tensor")
    n, bn = b.shape[-1], tiles[1]
    if math.ceil(n / bn) > 65535 or (batched and a.shape[0] > 65535):
        raise ValueError(f"grid too large for N={n}, tile {tiles}")
    return out_dtype, col_major


def matmul(a: torch.Tensor, b: torch.Tensor, *, tiles: tuple[int, int, int],
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a[m,k] @ b[k,n]`` with the compiled tile ``tiles`` (from
    ``runtime.hopper_tiles``); floats give the input dtype (or
    ``out_dtype``), integers give int32."""
    global launches
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.mm(a, b, out_dtype)
    out_dtype, col_major = check_operands(a, b, tiles, out_dtype,
                                          batched=False)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        build.call("widesa_mm_launch", a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), m, n, k, col_major,
                   build.DTYPE_CODES[a.dtype], build.DTYPE_CODES[out_dtype],
                   tiles=tuple(tiles))
    launches += 1
    return out
