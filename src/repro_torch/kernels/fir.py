"""``y[n] = sum_t x[n+t] h[t]`` (VALID FIR) and its complex form on the
hand-written Hopper kernel.

The port of ``repro.kernels.fir`` (``fir_kernel``) and of
``repro.kernels.ops.fir_complex``: the kernel is ``csrc/widesa_sp.cu``
(``fir_kernel``), which reads ``x`` directly instead of the reference's
shifted stack, with its taps in registers for the compiled tap counts
(``build.FIR_TAPS``: 15) and in shared memory for any other count
up to ``MAX_TAPS`` (the generic instantiation).  ``fir_complex`` runs the
reference's four real passes and two combines as one launch of the same
kernel on both planes.  The wrappers check their operands, allocate the
outputs and launch on the current stream; CPU tensors run the plain
versions in ``ref.py`` instead.  ``launches`` counts kernel launches, real
and complex, ``variants`` the same launches by the instantiation they ran
on ("15", "generic").
"""

from __future__ import annotations

import torch

from . import build, ref, runtime

launches = 0


def _variant(taps: int) -> str:
    return "generic" if taps == build.FIR_GENERIC else str(taps)


variants = {_variant(t): 0 for t in (*build.FIR_TAPS, build.FIR_GENERIC)}

#: the largest tap count the kernel takes (``kFirMaxTaps``)
MAX_TAPS = 4096


def _check(xs, hs, tiles: runtime.FirTile, out_dtype):
    """Raise for operands or a launch the kernel does not take; return
    (n_out, taps, out_dtype)."""
    for x, h in zip(xs, hs):
        if x.dim() != 1 or h.dim() != 1:
            raise ValueError(f"expected 1-D operands, got {tuple(x.shape)} "
                             f"and {tuple(h.shape)}")
    tensors = (*xs, *hs)
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"operand dtypes differ: "
                        f"{[t.dtype for t in tensors]}")
    if len({t.device for t in tensors}) != 1 \
            or xs[0].device.type != "cuda":
        raise ValueError(f"operands must share one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    dtype = xs[0].dtype
    out_dtype = out_dtype or runtime.out_dtype(dtype)
    if (dtype, out_dtype) not in build.SP_DTYPES:
        raise TypeError(f"no FIR kernel for {dtype} -> {out_dtype}")
    if len({tuple(x.shape) for x in xs}) != 1 \
            or len({tuple(h.shape) for h in hs}) != 1:
        raise ValueError("the planes of a complex FIR differ in shape")
    taps = hs[0].shape[0]
    n_out = xs[0].shape[0] - taps + 1
    if not isinstance(tiles, runtime.FirTile) \
            or tiles.taps not in (taps, build.FIR_GENERIC) \
            or (tiles.taps != build.FIR_GENERIC
                and tiles.taps not in build.FIR_TAPS) \
            or tiles.lanes not in build.FIR_LANES \
            or not 1 <= tiles.blocks < 2**31:
        raise ValueError(f"FIR launch {tiles} is not compiled for {taps} "
                         "taps")
    if not 1 <= taps <= MAX_TAPS or n_out < 1 or xs[0].shape[0] >= 2**31:
        raise ValueError(f"FIR of {xs[0].shape[0]} samples and {taps} taps "
                         "is outside the kernel's range")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("FIR operands must be contiguous")
    return n_out, taps, out_dtype


def _count(tiles: runtime.FirTile) -> None:
    global launches
    launches += 1
    variants[_variant(tiles.taps)] += 1


def fir(x: torch.Tensor, h: torch.Tensor, *, tiles: runtime.FirTile,
        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x`` [N], ``h`` [T] -> [N - T + 1] with the launch ``tiles`` (from
    ``runtime.fir_tile``); float32 gives float32, integers give int32."""
    if x.device.type == "cpu" and h.device.type == "cpu":
        return ref.fir(x, h, out_dtype)
    n_out, taps, out_dtype = _check((x,), (h,), tiles, out_dtype)
    out = torch.empty((n_out,), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        build.call("widesa_fir_launch", x.data_ptr(), h.data_ptr(),
                   out.data_ptr(), n_out, taps, build.DTYPE_CODES[x.dtype],
                   build.DTYPE_CODES[out_dtype], tiles=(
                       tiles.taps, tiles.lanes, tiles.blocks))
    _count(tiles)
    return out


def fir_complex(x_re: torch.Tensor, x_im: torch.Tensor, h_re: torch.Tensor,
                h_im: torch.Tensor, *, tiles: runtime.FirTile | None = None,
                out_dtype: torch.dtype | None = None):
    """The complex FIR of ``x_re + i x_im`` [N] by ``h_re + i h_im`` [T]:
    (``rr - ii``, ``ri + ir``), [N - T + 1] each, as
    ``repro.kernels.ops.fir_complex``, in one launch (``tiles`` by default
    ``runtime.fir_config`` for two planes)."""
    xs, hs = (x_re, x_im), (h_re, h_im)
    if all(t.device.type == "cpu" for t in (*xs, *hs)):
        return ref.fir_complex(x_re, x_im, h_re, h_im, out_dtype)
    if tiles is None and x_re.dim() == h_re.dim() == 1:
        tiles = runtime.fir_config(
            x_re.shape[0] - h_re.shape[0] + 1, h_re.shape[0],
            x_re.element_size(), planes=2)
    n_out, taps, out_dtype = _check(xs, hs, tiles, out_dtype)
    outs = [torch.empty((n_out,), dtype=out_dtype, device=x_re.device)
            for _ in range(2)]
    with torch.cuda.device(x_re.device):
        build.call("widesa_fir_complex_launch",
                   *(t.data_ptr() for t in (*xs, *hs, *outs)), n_out, taps,
                   build.DTYPE_CODES[x_re.dtype],
                   build.DTYPE_CODES[out_dtype], tiles=(
                       tiles.taps, tiles.lanes, tiles.blocks))
    _count(tiles)
    return tuple(outs)
