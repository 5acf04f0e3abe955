"""``M[i,j] = sum_{k,l} X[i,k,l] B[k,j] C[l,j]`` (MTTKRP) on the
hand-written Hopper kernels.

The port of ``repro.kernels.mttkrp`` (``mttkrp_kernel``).  Two kernels of
``csrc/widesa_hpc.cu`` serve it: ``mttkrp_tc_kernel`` on the tensor cores
(float32 as 3xTF32, int8, and int16 / int32 as int8 limbs, bit-exact; the
two-step form ``sum_k B[k] * (X[:, k, :] @ C)`` with C's tile held in
shared memory) and ``mttkrp_kernel`` on the CUDA cores (rows of X or B
that allow no 4-byte copies, C tiles past the shared memory; a GEMM of
``X.reshape(I, K*L)`` with the Khatri-Rao operand it builds in shared
memory).  ``mttkrp`` checks its operands, allocates the output and
launches on the current stream the kernel its ``tiles`` name: a
``runtime.MttkrpTile`` (from ``runtime.mttkrp_tile``) runs the
tensor-core kernel, ``build.MTTKRP_TILE`` the CUDA-core one.  A CPU
tensor runs the plain version in ``ref.py`` instead.  ``launches`` counts
kernel launches, ``variants`` the same launches by kernel.
"""

from __future__ import annotations

import torch

from . import build, ref, runtime

launches = 0
#: launches by kernel: ``tensor_core`` and ``cuda_core``
variants = {"tensor_core": 0, "cuda_core": 0}


def mttkrp(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
           tiles, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` [I, K, L], ``b`` [K, J], ``c`` [L, J] -> [I, J] on the kernel
    ``tiles`` names: a ``runtime.MttkrpTile`` that ``runtime.mttkrp_route``
    allows for these operands, or the CUDA-core tile
    ``build.MTTKRP_TILE``; float32 gives float32, integers give int32."""
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
    if min(ni, nj, nk, nl) < 1 or nk * nl >= 2**31 or nj >= 2**31:
        raise ValueError(f"MTTKRP of {tuple(x.shape)} x {nj} is outside the "
                         "kernels' range")
    if not all(t.is_contiguous() for t in (x, b, c)):
        raise ValueError("MTTKRP operands must be contiguous")
    shape = (ni, nj, nk, nl)
    if isinstance(tiles, runtime.MttkrpTile):
        allowed = runtime.mttkrp_route(shape, x.dtype, x.data_ptr(),
                                       b.data_ptr())
        if allowed is None or tiles.copy not in (4, allowed.copy) \
                or not 1 <= tiles.split <= min(runtime.MTTKRP_TC_MAX_CLUSTER,
                                               nk) \
                or (tiles.split - 1) * -(-nk // tiles.split) >= nk:
            raise ValueError(f"{tiles} is not a tensor-core MTTKRP launch "
                             f"for {tuple(x.shape)} x {nj} {x.dtype} (the "
                             f"runtime allows {allowed})")
        entry, args, variant = ("widesa_mttkrp_tc_launch",
                                (tiles.split, tiles.copy), "tensor_core")
    elif tuple(tiles) == build.MTTKRP_TILE:
        if -(-ni // tiles[0]) > 65535:
            raise ValueError(f"{ni} rows exceed the CUDA-core MTTKRP's grid")
        entry, args, variant = ("widesa_mttkrp_launch", tuple(tiles),
                                "cuda_core")
    else:
        raise ValueError(f"MTTKRP tile {tiles} is not compiled")
    out = torch.empty((ni, nj), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        build.call(entry, x.data_ptr(), b.data_ptr(), c.data_ptr(),
                   out.data_ptr(), ni, nj, nk, nl,
                   build.DTYPE_CODES[x.dtype], build.DTYPE_CODES[out_dtype],
                   *args)
    variants[variant] += 1
    launches += 1
    return out
