"""2-D DFT as two complex matrix products over the hand-written mm kernel.

The port of ``repro.kernels.fft2d`` (``fft2d``/``_cmul_mm``), which has
no ``pallas_call`` of its own: ``X2 = F_R @ X @ F_C`` with each complex
product lowered to three real products (``k1 = Br(Ar+Ai)``,
``k2 = Ar(Bi-Br)``, ``k3 = Ai(Br+Bi)``; ``Re = k1 - k3``,
``Im = k1 + k2``), each one ``widesa_mm.matmul`` launch: six launches of
the fp32 IEEE GEMMs per transform (the skinny kernel for up to 16 rows),
no new CUDA.  A CPU tensor runs the same composition over the plain
``ref.mm``.  ``launches`` counts compositions run on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import runtime, widesa_mm

launches = 0


@functools.lru_cache(maxsize=16)
def dft_matrix(n: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag planes of the n-point DFT matrix."""
    k = np.arange(n)
    ang = -2.0 * np.pi * np.outer(k, k) / n
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


@functools.lru_cache(maxsize=16)
def _dft_planes(n: int, device: torch.device):
    """``dft_matrix(n)`` on ``device``, copied there once."""
    return tuple(torch.from_numpy(m).to(device) for m in dft_matrix(n))


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


def fft2d(x_re: torch.Tensor, x_im: torch.Tensor, *,
          tiles: tuple[int, int, int],
          out_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """2-D DFT of a float32 (R, C) complex grid held as two real planes;
    ``tiles`` is the tiled kernel's tile for the products the skinny
    kernel does not take (``_cmul_mm``)."""
    global launches
    del out_dtype  # the planes are float32, as the reference's
    if x_re.dtype != torch.float32 or x_im.dtype != torch.float32:
        raise TypeError(f"fft2d takes float32 planes, got {x_re.dtype} and "
                        f"{x_im.dtype}")
    r, c = x_re.shape
    fr_re, fr_im = _dft_planes(r, x_re.device)
    fc_re, fc_im = _dft_planes(c, x_re.device)
    x_re, x_im = x_re.contiguous(), x_im.contiguous()
    # stage 1: rows — Y = F_R @ X
    y_re, y_im = _cmul_mm(fr_re, fr_im, x_re, x_im, tiles=tiles)
    # stage 2: cols — Z = Y @ F_C
    z_re, z_im = _cmul_mm(y_re, y_im, fc_re, fc_im, tiles=tiles)
    if x_re.device.type != "cpu":
        launches += 1
    return z_re, z_im
