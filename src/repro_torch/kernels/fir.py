"""``y[n] = sum_t x[n+t] h[t]`` (VALID FIR) on the hand-written Hopper
kernel.

The port of ``repro.kernels.fir`` (``fir_kernel``): the kernel is
``csrc/widesa_sp.cu`` (``fir_kernel``), which reads ``x`` directly
instead of the reference's shifted stack.  ``fir`` checks its operands,
allocates the output and launches on the current stream; a CPU tensor
runs the plain version in ``ref.py`` instead.  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from . import build, ref, runtime

launches = 0

#: the largest tap count the kernel's shared-memory tile takes
MAX_TAPS = 4096


def fir(x: torch.Tensor, h: torch.Tensor, *, tiles: tuple[int],
        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` [N], ``h`` [T] -> [N - T + 1] with the compiled output tile
    ``tiles = (BN,)`` (from ``runtime.fir_tile``); float32 gives float32,
    integers give int32."""
    global launches
    if x.device.type == "cpu" and h.device.type == "cpu":
        return ref.fir(x, h, out_dtype)
    if x.dim() != 1 or h.dim() != 1:
        raise ValueError(f"expected 1-D operands, got {tuple(x.shape)} and "
                         f"{tuple(h.shape)}")
    if x.dtype != h.dtype:
        raise TypeError(f"operand dtypes differ: {x.dtype} vs {h.dtype}")
    if x.device != h.device or x.device.type != "cuda":
        raise ValueError(f"operands must share one CUDA device, got "
                         f"{x.device} and {h.device}")
    out_dtype = out_dtype or runtime.out_dtype(x.dtype)
    if (x.dtype, out_dtype) not in build.SP_DTYPES:
        raise TypeError(f"no FIR kernel for {x.dtype} -> {out_dtype}")
    if tuple(tiles) not in [(bn,) for bn in build.FIR_TILES]:
        raise ValueError(f"FIR tile {tiles} is not compiled")
    taps = h.shape[0]
    n_out = x.shape[0] - taps + 1
    if not 1 <= taps <= MAX_TAPS or n_out < 1 or x.shape[0] >= 2**31:
        raise ValueError(f"FIR of {x.shape[0]} samples and {taps} taps is "
                         f"outside the kernel's range")
    if not (x.is_contiguous() and h.is_contiguous()):
        raise ValueError("FIR operands must be contiguous")
    out = torch.empty((n_out,), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        build.call("widesa_fir_launch", x.data_ptr(), h.data_ptr(),
                   out.data_ptr(), n_out, taps, build.DTYPE_CODES[x.dtype],
                   build.DTYPE_CODES[out_dtype], tiles=tuple(tiles))
    launches += 1
    return out
