"""Plain PyTorch versions of the port's kernels (the ground truth): mm,
bmm, fir, conv2d, fft2d, the star stencils (jacobi2d, jacobi2d_9pt and
the multi-sweep jacobi2d_ms) and mttkrp.

They follow ``repro.kernels.ref``: float inputs accumulate in fp32 and
round once to the input dtype (or to ``out_dtype``; fir and conv2d keep
the fp32 accumulator, as the reference's oracles do); integer inputs give
int32 results that wrap around exactly as XLA's int32 arithmetic does.
They run on any device, so the same function is the CPU path of the
kernel wrappers and the yardstick the kernels are held against on the
card.

Integer products are computed exactly in float64 from 16-bit limbs:
with ``a = a_hi * 2^16 + a_lo`` (``a_lo`` in [0, 2^16)), the product
modulo 2^32 is ``a_lo*b_lo + 2^16 * (a_hi*b_lo + a_lo*b_hi)``, and every
partial sum of those terms is an integer below 2^53 for K < 2^21, so
the float64 products are exact on every device and in any order.

``fir``, ``conv2d`` and the stencils are the reference's shifted-slice
loops (t; p then q; the star points in order), not ``F.conv1d`` /
``F.conv2d``: cuDNN runs float32 convolutions in TF32 by default, and the
loop keeps the reference's summation order.  Their integer products and
sums are taken in int64 and wrapped to int32 after every step, which is
exact modulo 2^32.  ``fft2d`` is ``torch.fft.fft2`` on complex64.
``mttkrp`` is one matrix product with its Khatri-Rao operand written out.
"""

from __future__ import annotations

import torch

from repro_torch.core.recurrence import JACOBI2D_9PT_OFFSETS, JACOBI2D_OFFSETS


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b`` of integer tensors, wrapped to int32."""
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16

    def exact(x, y):
        return torch.matmul(x.double(), y.double()).to(torch.int64)

    low = exact(a_lo, b_lo)
    mid = exact(a_hi, b_lo) + exact(a_lo, b_hi)
    r = (low + ((mid & 0xFFFF) << 16)) & 0xFFFFFFFF
    return (r - ((r >> 31) << 32)).to(torch.int32)


def _matmul(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    if a.dtype.is_floating_point:
        out = torch.matmul(a.float(), b.float())
        return out.to(out_dtype or a.dtype)
    out = _int_matmul(a, b)
    return out if out_dtype is None else out.to(out_dtype)


def mm(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C[m,n] = A[m,k] @ B[k,n]."""
    return _matmul(a, b, out_dtype)


def bmm(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C[z] = A[z] @ B[z]; ``out_dtype`` is the dtype the fp32/int32
    accumulator flushes to (attention scores take fp32 from bf16)."""
    return _matmul(a, b, out_dtype)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced modulo 2^32 into int32's range (still
    int64)."""
    return ((v + 2**31) & 0xFFFFFFFF) - 2**31


def _shifted_sum(slices, weights, dtype) -> torch.Tensor:
    """sum_s slices[s] * weights[s] in the reference's accumulator ladder:
    fp32 for floats, int32 with wraparound for integers, in order."""
    out = None
    for xs, w in zip(slices, weights):
        if dtype.is_floating_point:
            term = xs.float() * w.float()
            out = term if out is None else out + term
        else:
            term = xs.to(torch.int64) * w.to(torch.int64)
            out = _wrap32(term if out is None else out + term)
    if dtype.is_floating_point:
        return out
    return out.to(torch.int32)


def fir(x: torch.Tensor, h: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """y[n] = sum_t x[n+t] h[t] (VALID): float32 for float inputs, int32
    for integers."""
    t = h.shape[0]
    n_out = x.shape[0] - t + 1
    out = _shifted_sum((x[i:i + n_out] for i in range(t)),
                       (h[i] for i in range(t)), x.dtype)
    return out if out_dtype is None else out.to(out_dtype)


def conv2d(img: torch.Tensor, filt: torch.Tensor,
           out_dtype=None) -> torch.Tensor:
    """VALID 2-D correlation O[h,w] = sum_{p,q} I[h+p, w+q] F[p,q]."""
    ph, pq = filt.shape
    h, w = img.shape
    oh, ow = h - ph + 1, w - pq + 1
    pairs = [(p, q) for p in range(ph) for q in range(pq)]
    out = _shifted_sum((img[p:p + oh, q:q + ow] for p, q in pairs),
                       (filt[p, q] for p, q in pairs), img.dtype)
    return out if out_dtype is None else out.to(out_dtype)


def fft2d(x_re: torch.Tensor, x_im: torch.Tensor, out_dtype=None):
    """2-D DFT of the complex grid ``x_re + i x_im``: the (real, imag)
    float32 planes of ``torch.fft.fft2`` on complex64."""
    del out_dtype  # the planes are float32, as the reference's
    z = torch.fft.fft2(torch.complex(x_re.float(), x_im.float()))
    return z.real.contiguous(), z.imag.contiguous()


def _star_pad(offsets) -> int:
    """Pad width of a padded-offsets star: the largest offset component is
    2 * radius (1 for the 5-point star, 2 for the radius-2 9-point star)."""
    return max(max(di, dj) for di, dj in offsets) // 2


def star2d(grid: torch.Tensor, weights: torch.Tensor, offsets,
           out_dtype=None) -> torch.Tensor:
    """One weighted star sweep over the interior (VALID):
    ``O[i,j] = sum_s w[s] G[i + di_s, j + dj_s]`` with padded-grid
    ``offsets``; float32 for float grids, int32 for integers."""
    pad = _star_pad(offsets)
    h, w = grid.shape
    oh, ow = h - 2 * pad, w - 2 * pad
    out = _shifted_sum((grid[di:di + oh, dj:dj + ow] for di, dj in offsets),
                       (weights[s] for s in range(len(offsets))), grid.dtype)
    return out if out_dtype is None else out.to(out_dtype)


def star2d_ms(grid: torch.Tensor, weights: torch.Tensor, offsets,
              out_dtype=None) -> torch.Tensor:
    """``weights.shape[0]`` star sweeps: sweep t reads sweep t-1's interior
    inside the fixed boundary ring.  The state is promoted to the
    accumulator dtype (int32 for integers) once, up front."""
    pad = _star_pad(offsets)
    g = grid.to(torch.float32 if grid.dtype.is_floating_point
                else torch.int32).clone()
    inner = (slice(pad, -pad), slice(pad, -pad))
    for t in range(weights.shape[0]):
        g[inner] = star2d(g, weights[t], offsets)
    out = g[inner].contiguous()
    return out if out_dtype is None else out.to(out_dtype)


def jacobi2d(grid, weights, out_dtype=None):
    """Weighted 5-point Jacobi sweep over the interior (VALID)."""
    return star2d(grid, weights, JACOBI2D_OFFSETS, out_dtype)


def jacobi2d_9pt(grid, weights, out_dtype=None):
    """Weighted 9-point radius-2 star sweep over the interior (VALID)."""
    return star2d(grid, weights, JACOBI2D_9PT_OFFSETS, out_dtype)


def jacobi2d_ms(grid, weights, out_dtype=None):
    """Multi-sweep Jacobi on the 5-point star (see ``star2d_ms``)."""
    return star2d_ms(grid, weights, JACOBI2D_OFFSETS, out_dtype)


def khatri_rao(b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``KR[k * L + l, j] = B[k, j] * C[l, j]``: float32 for floats,
    int32 (wrapped) for integers."""
    if b.dtype.is_floating_point:
        kr = b.float()[:, None, :] * c.float()[None, :, :]
    else:
        kr = _wrap32(b.to(torch.int64)[:, None, :]
                     * c.to(torch.int64)[None, :, :]).to(torch.int32)
    return kr.reshape(-1, b.shape[1])


def mttkrp(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           out_dtype=None) -> torch.Tensor:
    """M[i,j] = sum_{k,l} X[i,k,l] B[k,j] C[l,j] as
    ``X.reshape(I, K*L) @ khatri_rao(B, C)``: float32 for float inputs
    (fp32 ``torch.matmul``), int32 for integers (the exact limb product,
    exact for K*L < 2^21)."""
    x2 = x.reshape(x.shape[0], -1)
    kr = khatri_rao(b, c)
    if x.dtype.is_floating_point:
        out = torch.matmul(x2.float(), kr)
    else:
        out = _int_matmul(x2, kr)
    return out if out_dtype is None else out.to(out_dtype)
