"""``M[i,j] = sum_{k,l} X[i,k,l] B[k,j] C[l,j]`` (MTTKRP) on the
hand-written Hopper kernel.

The port of ``repro.kernels.mttkrp`` (``mttkrp_kernel``): the kernel is
``csrc/widesa_hpc.cu`` (``mttkrp_kernel``), a GEMM of ``X.reshape(I,
K*L)`` with the Khatri-Rao operand it builds in shared memory.
``mttkrp`` checks its operands, allocates the output and launches on the
current stream; a CPU tensor runs the plain version in ``ref.py``
instead.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import build, ref, runtime

launches = 0


def mttkrp(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
           tiles: tuple[int, int],
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` [I, K, L], ``b`` [K, J], ``c`` [L, J] -> [I, J] with the
    compiled output tile ``tiles = (BI, BJ)`` (``build.MTTKRP_TILE``);
    float32 gives float32, integers give int32."""
    global launches
    if all(t.device.type == "cpu" for t in (x, b, c)):
        return ref.mttkrp(x, b, c, out_dtype)
    if x.dim() != 3 or b.dim() != 2 or c.dim() != 2:
        raise ValueError(f"expected operands of 3, 2 and 2 dimensions, got "
                         f"{tuple(x.shape)}, {tuple(b.shape)} and "
                         f"{tuple(c.shape)}")
    ni, nk, nl = x.shape
    nj = b.shape[1]
    if tuple(b.shape) != (nk, nj) or tuple(c.shape) != (nl, nj):
        raise ValueError(f"shapes do not chain: X {tuple(x.shape)}, B "
                         f"{tuple(b.shape)}, C {tuple(c.shape)}")
    if not x.dtype == b.dtype == c.dtype:
        raise TypeError(f"operand dtypes differ: {x.dtype}, {b.dtype}, "
                        f"{c.dtype}")
    if not (x.device == b.device == c.device) or x.device.type != "cuda":
        raise ValueError(f"operands must share one CUDA device, got "
                         f"{x.device}, {b.device} and {c.device}")
    out_dtype = out_dtype or runtime.out_dtype(x.dtype)
    if (x.dtype, out_dtype) not in build.HPC_DTYPES:
        raise TypeError(f"no MTTKRP kernel for {x.dtype} -> {out_dtype}")
    if tuple(tiles) != build.MTTKRP_TILE:
        raise ValueError(f"MTTKRP tile {tiles} is not compiled")
    if min(ni, nj, nk, nl) < 1 or nk * nl >= 2**31 or nj >= 2**31 \
            or -(-ni // tiles[0]) > 65535:
        raise ValueError(f"MTTKRP of {tuple(x.shape)} x {nj} is outside the "
                         "kernel's range")
    if not all(t.is_contiguous() for t in (x, b, c)):
        raise ValueError("MTTKRP operands must be contiguous")
    out = torch.empty((ni, nj), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        build.call("widesa_mttkrp_launch", x.data_ptr(), b.data_ptr(),
                   c.data_ptr(), out.data_ptr(), ni, nj, nk, nl,
                   build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[out_dtype],
                   tiles=tuple(tiles))
    launches += 1
    return out
