"""2-D DFT: one fused CUDA kernel, or two complex matrix products over the
hand-written mm kernels.

The port of ``repro.kernels.fft2d`` (``fft2d``/``_cmul_mm``), which has
no ``pallas_call`` of its own: ``X2 = F_R @ X @ F_C`` with each complex
product lowered to three real products (``k1 = Br(Ar+Ai)``,
``k2 = Ar(Bi-Br)``, ``k3 = Ai(Br+Bi)``; ``Re = k1 - k3``,
``Im = k1 + k2``).  ``tiles`` names the form that runs on the card
(``runtime.fft2d_tile`` picks it from the shape before the launch):

* a ``runtime.Fft2dTile``: ``fft2d_kernel`` of ``csrc/widesa_sp.cu``, both
  stages in one launch with the operand sums formed on load and nothing
  but Z written to device memory (fp32 IEEE FMA; K split over a cluster
  of ``split`` blocks).  It reads the DFT planes in rows padded to whole
  16-byte units (``_dft_planes``);
* a tiled-kernel tile: the composition, each real product one
  ``widesa_mm.matmul`` launch on the configuration ``runtime.gemm_tile``
  gives it (this tile where neither the skinny nor the tensor-core kernel
  applies), six a transform, with the sums and combinations as PyTorch
  array operations.

A CPU tensor runs the composition over the plain ``ref.mm`` whatever the
tile.  ``launches`` counts transforms run on the card, ``variants`` the
same by form (``fused`` / ``composition``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import build, runtime, widesa_mm

launches = 0
#: transforms by form: ``fused`` (one kernel) and ``composition``
variants = {"fused": 0, "composition": 0}


#: the largest transform whose DFT planes stay cached, on the host and on
#: each device (a pair of 1024-point planes is 8 MiB, so the 16 entries
#: of either cache hold at most 128 MiB); a larger transform's planes are
#: built on its device for the call and freed after it, as the reference
#: builds every transform's (an 8192-point pair is 512 MiB)
DFT_CACHE_MAX_N = 1024


def _dft_matrix(n: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    k = np.arange(n)
    ang = -2.0 * np.pi * np.outer(k, k) / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


_dft_matrix_cached = functools.lru_cache(maxsize=16)(_dft_matrix)


def dft_matrix(n: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag planes of the n-point DFT matrix (cached up to
    ``DFT_CACHE_MAX_N`` points)."""
    build_fn = _dft_matrix_cached if n <= DFT_CACHE_MAX_N else _dft_matrix
    return build_fn(n, dtype)


def _make_planes(n: int, device: torch.device, padded: bool = False):
    pitch = -(-n // 4) * 4 if padded else n
    if n <= DFT_CACHE_MAX_N:
        mats = [torch.from_numpy(m) for m in dft_matrix(n)]
    else:
        # ``dft_matrix``'s float64 arithmetic, on the device: the host's
        # cos/sin of n^2 angles take seconds at 8192 points
        k = torch.arange(n, dtype=torch.float64, device=device)
        ang = (-2.0 * math.pi) * torch.outer(k, k) / n
        mats = [torch.cos(ang), torch.sin(ang)]
    planes = []
    for m in mats:
        plane = torch.zeros((n, pitch), dtype=torch.float32, device=device)
        plane[:, :n] = m
        planes.append(plane)
    return tuple(planes)


_planes_cached = functools.lru_cache(maxsize=16)(_make_planes)


def _dft_planes(n: int, device: torch.device, padded: bool = False):
    """``dft_matrix(n)`` on ``device`` (copied there once up to
    ``DFT_CACHE_MAX_N`` points, per call above): contiguous, or with
    ``padded`` in rows of whole 16-byte units (zeros past n), as the
    fused kernel's 16-byte copies read them."""
    build_fn = _planes_cached if n <= DFT_CACHE_MAX_N else _make_planes
    return build_fn(n, device, padded)


def _cmul_mm(ar, ai, br, bi, *, tiles):
    """Complex matmul (A @ B) via three real mm kernel calls, each on the
    configuration ``runtime.gemm_tile`` gives its operands (``tiles``: the
    tiled kernel's tile where the skinny one does not apply)."""
    def dot(x, y):
        return widesa_mm.matmul(x, y, tiles=runtime.gemm_tile(x, y, tiles))

    k1 = dot(ar + ai, br)
    k2 = dot(ar, bi - br)
    k3 = dot(ai, br + bi)
    return k1 - k3, k1 + k2


def _fused(x_re, x_im, tile: runtime.Fft2dTile):
    r, c = x_re.shape
    if not runtime.fft2d_allows(r, c, tile.split):
        raise ValueError(f"{tile} is not a fused fft2d launch for a {r} x "
                         f"{c} grid (the runtime picks "
                         f"{runtime.fft2d_route(r, c)})")
    fr_re, fr_im = _dft_planes(r, x_re.device, True)
    fc_re, fc_im = _dft_planes(c, x_re.device, True)
    z_re, z_im = (torch.empty((r, c), dtype=torch.float32,
                              device=x_re.device) for _ in range(2))
    with torch.cuda.device(x_re.device):
        build.call("widesa_fft2d_launch", x_re.data_ptr(), x_im.data_ptr(),
                   fr_re.data_ptr(), fr_im.data_ptr(), fc_re.data_ptr(),
                   fc_im.data_ptr(), z_re.data_ptr(), z_im.data_ptr(), r, c,
                   tile.split)
    return z_re, z_im


def fft2d(x_re: torch.Tensor, x_im: torch.Tensor, *, tiles,
          out_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """2-D DFT of a float32 (R, C) complex grid held as two real planes,
    in the form ``tiles`` names (module docstring)."""
    global launches
    del out_dtype  # the planes are float32, as the reference's
    if x_re.dtype != torch.float32 or x_im.dtype != torch.float32:
        raise TypeError(f"fft2d takes float32 planes, got {x_re.dtype} and "
                        f"{x_im.dtype}")
    if x_re.dim() != 2 or x_re.shape != x_im.shape:
        raise ValueError(f"fft2d takes two planes of one 2-D shape, got "
                         f"{tuple(x_re.shape)} and {tuple(x_im.shape)}")
    x_re, x_im = x_re.contiguous(), x_im.contiguous()
    on_card = x_re.device.type != "cpu"
    if on_card and isinstance(tiles, runtime.Fft2dTile):
        if x_im.device != x_re.device or x_re.device.type != "cuda":
            raise ValueError(f"planes must share one CUDA device, got "
                             f"{x_re.device} and {x_im.device}")
        out, form = _fused(x_re, x_im, tiles), "fused"
    else:
        r, c = x_re.shape
        fr_re, fr_im = _dft_planes(r, x_re.device)
        fc_re, fc_im = _dft_planes(c, x_re.device)
        # stage 1: rows — Y = F_R @ X
        y_re, y_im = _cmul_mm(fr_re, fr_im, x_re, x_im, tiles=tiles)
        # stage 2: cols — Z = Y @ F_C
        out, form = _cmul_mm(y_re, y_im, fc_re, fc_im, tiles=tiles), \
            "composition"
    if on_card:
        variants[form] += 1
        launches += 1
    return out
