"""``O[h,w] = sum_{p,q} I[h+p, w+q] F[p,q]`` (VALID 2-D correlation) on
the hand-written Hopper kernel.

The port of ``repro.kernels.conv2d`` (``conv_kernel``): the kernel is
``csrc/widesa_sp.cu`` (``conv2d_kernel``), which stages an input tile with
its halo in shared memory instead of reading the reference's shifted
window stack.  ``conv2d`` checks its operands, allocates the output and
launches on the current stream; a CPU tensor runs the plain version in
``ref.py`` instead.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import build, ref, runtime

launches = 0

#: the largest filter extent the kernel's shared-memory tile takes
MAX_FILTER = 32


def conv2d(img: torch.Tensor, filt: torch.Tensor, *,
           tiles: tuple[int, int],
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``img`` [H, W], ``filt`` [P, Q] -> [H-P+1, W-Q+1] with the compiled
    output tile ``tiles = (BH, BW)`` (from ``runtime.conv2d_tile``);
    float32 gives float32, integers give int32."""
    global launches
    if img.device.type == "cpu" and filt.device.type == "cpu":
        return ref.conv2d(img, filt, out_dtype)
    if img.dim() != 2 or filt.dim() != 2:
        raise ValueError(f"expected 2-D operands, got {tuple(img.shape)} "
                         f"and {tuple(filt.shape)}")
    if img.dtype != filt.dtype:
        raise TypeError(f"operand dtypes differ: {img.dtype} vs "
                        f"{filt.dtype}")
    if img.device != filt.device or img.device.type != "cuda":
        raise ValueError(f"operands must share one CUDA device, got "
                         f"{img.device} and {filt.device}")
    out_dtype = out_dtype or runtime.out_dtype(img.dtype)
    if (img.dtype, out_dtype) not in build.SP_DTYPES:
        raise TypeError(f"no conv2d kernel for {img.dtype} -> {out_dtype}")
    if tuple(tiles) not in build.CONV2D_TILES:
        raise ValueError(f"conv2d tile {tiles} is not compiled")
    p, q = filt.shape
    oh, ow = img.shape[0] - p + 1, img.shape[1] - q + 1
    if not (1 <= p <= MAX_FILTER and 1 <= q <= MAX_FILTER) or oh < 1 \
            or ow < 1 or img.numel() >= 2**31 \
            or -(-oh // tiles[0]) > 65535:
        raise ValueError(f"conv2d of {tuple(img.shape)} by {(p, q)} is "
                         "outside the kernel's range")
    if not (img.is_contiguous() and filt.is_contiguous()):
        raise ValueError("conv2d operands must be contiguous")
    out = torch.empty((oh, ow), dtype=out_dtype, device=img.device)
    with torch.cuda.device(img.device):
        build.call("widesa_conv2d_launch", img.data_ptr(), filt.data_ptr(),
                   out.data_ptr(), oh, ow, p, q,
                   build.DTYPE_CODES[img.dtype],
                   build.DTYPE_CODES[out_dtype], tiles=tuple(tiles))
    launches += 1
    return out
