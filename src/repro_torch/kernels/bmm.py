"""``C[z] = A[z] @ B[z]`` on the hand-written Hopper GEMMs.

The port of ``repro.kernels.bmm`` (``bmm_kernel``): the same kernels as
``widesa_mm`` (``csrc/widesa_mm.cu``), launched with one grid slice per
batch entry; ``tiles`` names the kernel as there.  ``out_dtype`` flushes
the fp32 accumulator at another dtype (attention scores take fp32 from
bf16 operands without upcasting them); a bf16 result over a K past
``runtime.TC_PROMOTE_K`` on the tensor-core kernel is the fp32 one
rounded.  A CPU tensor runs the plain
version in ``ref.py``; ``launches`` counts kernel launches, ``variants``
the same launches by kernel.
"""

from __future__ import annotations

import torch

from . import ref, runtime
from .widesa_mm import check_operands, launch

launches = 0
#: launches by kernel, as ``widesa_mm.variants``: ``skinny``, ``wgmma``,
#: ``wgmma_cp`` and ``tiled``
variants = {"skinny": 0, "wgmma": 0, "wgmma_cp": 0, "tiled": 0}


def bmm(a: torch.Tensor, b: torch.Tensor, *, tiles,
        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a[z,m,k] @ b[z,k,n]`` on the kernel ``tiles`` names."""
    global launches
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.bmm(a, b, out_dtype)
    out_dtype, *layout = check_operands(a, b, tiles, out_dtype,
                                        batched=True)
    promote = runtime.tc_promotes(tiles, a.dtype, out_dtype, a.shape[-1])
    out = torch.empty((*a.shape[:2], b.shape[2]),
                      dtype=torch.float32 if promote else out_dtype,
                      device=a.device)
    if out.numel() == 0:
        return out.to(out_dtype)
    name = launch(a, b, out, tiles, *layout, batched=True)
    if name is not None:
        variants[name] += 1
        launches += 1
    return out.to(out_dtype)
