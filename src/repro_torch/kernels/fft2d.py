"""2-D DFT: one fused CUDA kernel, a hand-written FFT, or two complex
matrix products over the hand-written mm kernels.

The port of ``repro.kernels.fft2d`` (``fft2d``/``_cmul_mm``), which has
no ``pallas_call`` of its own: ``X2 = F_R @ X @ F_C`` with each complex
product lowered to three real products (``k1 = Br(Ar+Ai)``,
``k2 = Ar(Bi-Br)``, ``k3 = Ai(Br+Bi)``; ``Re = k1 - k3``,
``Im = k1 + k2``).  ``tiles`` names the form that runs on the card
(``runtime.fft2d_tile`` picks it from the shape before the launch):

* a ``runtime.Fft2dTile``: ``fft2d_kernel`` of ``csrc/widesa_sp.cu``, both
  stages in one launch with the operand sums formed on load and nothing
  but Z written to device memory (fp32 IEEE FMA; K split over a cluster
  of ``split`` blocks), for grids of at most 64 rows.  It reads the DFT
  planes in rows padded to whole 16-byte units (``_dft_planes``);
* a ``runtime.FftTile``: ``fft_pass_kernel`` of ``csrc/widesa_fft.cu``,
  the same transform as radix-2^k Stockham FFTs, a row pass and a column
  pass (two launches, each one read and one write of the grid), for the
  taller grids whose sides are powers of two up to 16384.  It reads one
  twiddle table a side (``twiddles``), no DFT plane;
  ``fft_plain`` is its plain version, stage by stage;
* a tiled-kernel tile: the composition, each real product one
  ``widesa_mm.matmul`` launch on the configuration ``runtime.gemm_tile``
  gives it (this tile where neither the skinny nor the tensor-core kernel
  applies), six a transform, with the sums and combinations as PyTorch
  array operations: the taller grids with a side that is no power of
  two.

A CPU tensor runs the composition over the plain ``ref.mm`` whatever the
tile.  ``launches`` counts transforms run on the card, ``variants`` the
same by form (``fused`` / ``fft`` / ``composition``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import build, runtime, widesa_mm

launches = 0
#: transforms by form: ``fused`` (one kernel), ``fft`` (the FFT kernel's
#: two passes) and ``composition``
variants = {"fused": 0, "fft": 0, "composition": 0}


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


@functools.lru_cache(maxsize=32)
def twiddle_table(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(cos, -sin)(2 pi j / n), j < n, in float64 cast to float32, the
    quarter turns' zeros exact: the FFT kernel's twiddles, its butterflies'
    roots of unity among them (w_R^m = entry m n / R)."""
    ang = 2.0 * np.pi * np.arange(n) / n
    planes = []
    for v in (np.cos(ang), -np.sin(ang)):
        v[np.abs(v) < 1e-12] = 0.0
        planes.append(v.astype(np.float32))
    return planes[0], planes[1]


@functools.lru_cache(maxsize=32)
def twiddles(n: int, device: torch.device) -> torch.Tensor:
    """``twiddle_table(n)`` on ``device`` as (n, 2) float32 pairs, copied
    there once (64 KB at 8192 points)."""
    return torch.from_numpy(np.stack(twiddle_table(n), axis=1)).to(device)


def _dft_plain(re, im, table, n):
    """The R-point DFTs over dim -2 of (..., R, m): the kernel's radix-2
    decimation in frequency, level by level (``w_{2h}^j`` from ``table``
    at ``j n / (2h)``), then the bit reversal."""
    r = re.shape[-2]
    lead, m = re.shape[:-2], re.shape[-1]
    h = r // 2
    while h >= 1:
        shape = (*lead, r // (2 * h), 2, h, m)
        a_re, b_re = re.reshape(shape).unbind(-3)
        a_im, b_im = im.reshape(shape).unbind(-3)
        idx = torch.arange(h) * (n // (2 * h))
        c, s = (t[idx].to(re.device).unsqueeze(-1) for t in table)
        d_re, d_im = a_re - b_re, a_im - b_im
        re = torch.stack((a_re + b_re, d_re * c - d_im * s), -3)
        im = torch.stack((a_im + b_im, d_re * s + d_im * c), -3)
        re, im = re.reshape(*lead, r, m), im.reshape(*lead, r, m)
        h //= 2
    bits = r.bit_length() - 1
    rev = [int(format(q, f"0{bits}b")[::-1], 2) if bits else 0
           for q in range(r)]
    return re[..., rev, :], im[..., rev, :]


def _twiddles_plain(table, k, r, stride, device):
    """w^(t k) for t < r, w^j = table entry j stride: the powers of two t
    read from the table, each other t as w^h w^(t - h), h the highest
    power of two below t, rounded as the kernel's ``twiddle``."""
    c, s = [None] * r, [None] * r
    for t in range(r):
        h = 1 << (t.bit_length() - 1) if t else 0
        if h == t:
            c[t], s[t] = (v[t * k * stride].to(device) for v in table)
        else:
            a_re, a_im, b_re, b_im = c[h], s[h], c[t - h], s[t - h]
            c[t], s[t] = a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re
    return torch.stack(c), torch.stack(s)


def _stockham_plain(re, im, radices, table, log_p=0):
    """The kernel's Stockham stages (``stage`` in csrc/widesa_fft.cu) over
    the last dim of ``re``/``im``, the first with p = 2^``log_p`` (the
    column pass's cluster stage): butterfly i reads points i + t n / R,
    twiddles point t by w_{pR}^(t k) (k = i mod p, ``table`` of the whole
    transform), and writes output q to (i - k) R + k + q p."""
    tab_n = len(table[0])
    lead, n = re.shape[:-1], re.shape[-1]
    p = 1 << log_p
    for r in radices:
        span = n // r
        a_re, a_im = re.reshape(*lead, r, span), im.reshape(*lead, r, span)
        k = torch.arange(span) % p
        c, s = _twiddles_plain(table, k, r, tab_n // (p * r), re.device)
        a_re, a_im = a_re * c - a_im * s, a_re * s + a_im * c
        b_re, b_im = _dft_plain(a_re, a_im, table, tab_n)
        # output q of butterfly i = (i // p) p + k at (i // p) p r + q p + k
        re, im = (v.reshape(*lead, r, span // p, p).transpose(-3, -2)
                  .reshape(*lead, n) for v in (b_re, b_im))
        p *= r
    return re, im


def fft_plain(x_re: torch.Tensor, x_im: torch.Tensor,
              tile: runtime.FftTile) -> tuple[torch.Tensor, torch.Tensor]:
    """The FFT kernel's arithmetic in torch ops, stage by stage, on
    ``tile``'s radix plans and the same float32 twiddle tables: the row
    pass over each row; the column pass over each column's ``cluster``
    decimated sequences (rows k, k + cluster, ...), then, above one block
    a column, the cluster's radix-``cluster`` stage.  Each product and
    sum is rounded on its own, as the kernel's."""
    r, c = x_re.shape
    table = tuple(torch.from_numpy(t) for t in twiddle_table(c))
    y_re, y_im = _stockham_plain(x_re.float(), x_im.float(),
                                 tile.row_radices, table)
    table = tuple(torch.from_numpy(t) for t in twiddle_table(r))
    p, m = tile.cluster, r // tile.cluster
    cols = [v.T.reshape(c, m, p).transpose(-1, -2) for v in (y_re, y_im)]
    z_re, z_im = _stockham_plain(*cols, tile.col_radices, table)
    if p > 1:
        z_re, z_im = _stockham_plain(z_re.reshape(c, r), z_im.reshape(c, r),
                                     (p,), table, m.bit_length() - 1)
    return (z_re.reshape(c, r).T.contiguous(),
            z_im.reshape(c, r).T.contiguous())


def _fft(x_re, x_im, tile: runtime.FftTile):
    r, c = x_re.shape
    if not runtime.fft_allows(r, c, tile):
        raise ValueError(f"{tile} is not an fft launch for a {r} x {c} "
                         f"grid (the runtime picks "
                         f"{runtime.fft2d_route(r, c)})")
    tw_rows, tw_cols = (twiddles(n, x_re.device) for n in (c, r))
    z_re, z_im = (torch.empty((r, c), dtype=torch.float32,
                              device=x_re.device) for _ in range(2))
    with torch.cuda.device(x_re.device):
        build.call("widesa_fft_launch", x_re.data_ptr(), x_im.data_ptr(),
                   tw_rows.data_ptr(), tw_cols.data_ptr(), z_re.data_ptr(),
                   z_im.data_ptr(), r, c, runtime.radix_logs(tile.row_radices),
                   len(tile.row_radices),
                   runtime.radix_logs(tile.col_radices),
                   len(tile.col_radices), tile.rows, tile.strip, tile.cluster)
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
    if on_card and isinstance(tiles, (runtime.Fft2dTile, runtime.FftTile)):
        if x_im.device != x_re.device or x_re.device.type != "cuda":
            raise ValueError(f"planes must share one CUDA device, got "
                             f"{x_re.device} and {x_im.device}")
        if isinstance(tiles, runtime.Fft2dTile):
            out, form = _fused(x_re, x_im, tiles), "fused"
        else:
            out, form = _fft(x_re, x_im, tiles), "fft"
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
