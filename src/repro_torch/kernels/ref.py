"""Plain PyTorch versions of the mm and bmm kernels (the ground truth).

They follow ``repro.kernels.ref``: float inputs accumulate in fp32 and
round once to the input dtype (or to ``out_dtype``); integer inputs give
int32 results that wrap around exactly as XLA's int32 arithmetic does.
They run on any device, so the same function is the CPU path of the
kernel wrappers and the yardstick the kernels are held against on the
card.

Integer products are computed exactly in float64 from 16-bit limbs:
with ``a = a_hi * 2^16 + a_lo`` (``a_lo`` in [0, 2^16)), the product
modulo 2^32 is ``a_lo*b_lo + 2^16 * (a_hi*b_lo + a_lo*b_hi)``, and every
partial sum of those terms is an integer below 2^53 for K < 2^21, so
the float64 products are exact on every device and in any order.
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
