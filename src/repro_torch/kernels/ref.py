"""Plain PyTorch versions of the port's kernels (the ground truth): mm,
bmm, fir, conv2d and fft2d.

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

``fir`` and ``conv2d`` are the reference's shifted-slice loops (t; p then
q), not ``F.conv1d``/``F.conv2d``: cuDNN runs float32 convolutions in
TF32 by default, and the loop keeps the reference's summation order.
Their integer products and sums are taken in int64 and wrapped to int32
after every step, which is exact modulo 2^32.  ``fft2d`` is
``torch.fft.fft2`` on complex64.
"""

from __future__ import annotations

import torch


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
