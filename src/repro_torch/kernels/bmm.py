"""``C[z] = A[z] @ B[z]`` on the hand-written Hopper GEMM.

The port of ``repro.kernels.bmm`` (``bmm_kernel``): the same kernel as
``widesa_mm`` (``csrc/widesa_mm.cu``), launched with one grid slice per
batch entry.  ``out_dtype`` flushes the fp32 accumulator at another dtype
(attention scores take fp32 from bf16 operands without upcasting them).
A CPU tensor runs the plain version in ``ref.py``; ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from . import build, ref
from .widesa_mm import check_operands

launches = 0


def bmm(a: torch.Tensor, b: torch.Tensor, *, tiles: tuple[int, int, int],
        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a[z,m,k] @ b[z,k,n]`` with the compiled tile ``tiles``."""
    global launches
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.bmm(a, b, out_dtype)
    out_dtype, col_major = check_operands(a, b, tiles, out_dtype,
                                          batched=True)
    (z, m, k), n = a.shape, b.shape[2]
    out = torch.empty((z, m, n), dtype=out_dtype, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        build.call("widesa_bmm_launch", a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), z, m, n, k, col_major,
                   build.DTYPE_CODES[a.dtype], build.DTYPE_CODES[out_dtype],
                   tiles=tuple(tiles))
    launches += 1
    return out
