"""``C[m,n] = A[m,k] @ B[k,n]`` on the hand-written Hopper GEMMs.

The port of ``repro.kernels.widesa_mm`` (``mm_kernel``): the kernels
themselves are in ``csrc/widesa_mm.cu``, shared with ``bmm`` (mm is their
batch = 1 launch).  ``matmul`` checks its operands, allocates the output
and launches on the current stream the kernel its ``tiles`` name: a
``runtime.SkinnyTile`` runs the skinny kernel (A of at most 16 rows), a
``runtime.TcTile`` a tensor-core one (more rows: ``gemm_tc_kernel`` in
bf16 and float32, its ring filled by TMA or, for an operand TMA cannot
address, by cp.async copies (``TcTile.copies``), a bf16 result
over a K past ``runtime.TC_PROMOTE_K`` from its fp32 instantiation,
rounded; ``gemm_tc_int_kernel`` in the integers, after the limb planes
it reads are written to scratch by ``limb_planes_kernel``), a
``(BM, BN, BK)`` tuple the tiled one.  Every kernel reads B in place at
its pitch (``runtime.b_layout``), so a slice of a weight's columns or
rows, a hierarchical plan's group, is launched without a copy.  A CPU tensor runs the plain version
in ``ref.py`` instead.  ``launches`` counts kernel launches, ``variants``
the same launches by kernel.

Fake operands (the dry run's, ``launch/fakecuda.py``: a ``cuda``
device, no storage) pass everything before the launch as on the card,
the route included (``runtime.address``), and ``launch`` then runs no
kernel: it loads no library, reads no address, and hands a record of
the launch (kernel, variant, tiles, shape, the product's FLOPs and the
bytes of reading each operand once and writing the result once) to each
callable in ``fake_sinks``.  No kernel ran, so ``launches`` and
``variants`` do not count it: the sinks' records are the dry run's only
tally.  A real operand never takes that branch.
"""

from __future__ import annotations

import contextlib
import math
from collections import Counter

import torch

from . import build, ref, runtime

launches = 0
#: launches by kernel: ``skinny`` (M <= 16), ``wgmma`` (the tensor-core
#: kernels, floats and integers, fed by TMA), ``wgmma_cp`` (the float one
#: fed by cp.async copies for an operand TMA cannot address) and ``tiled``
variants = {"skinny": 0, "wgmma": 0, "wgmma_cp": 0, "tiled": 0}
#: the tiled launches of both wrappers, this one's and ``bmm``'s, by
#: ``runtime.tiled_reason`` (None: a tiled tile asked for operands
#: another kernel takes, as the timing rows do)
tiled_why: Counter = Counter()
#: callables handed a record of each launch on fake operands (module
#: docstring); the dry run's ``accounting.StepCounter`` adds itself
fake_sinks: list = []


def check_operands(a, b, tiles, out_dtype, *, batched: bool):
    """Validate a CUDA launch and return ``(out_dtype, lda, b_col_major,
    ldb, sb, b_copy)``: A's row pitch (``runtime.a_pitch``), B's layout,
    pitch and batch stride (``runtime.b_layout``) and the bytes a copy of
    its rows may take (``runtime.b_copy_bytes``).

    A is contiguous or in padded rows; B is contiguous or the transpose of a
    contiguous tensor (read column-major, as the tied lm_head reads the
    embedding table), or a slice of either's columns or rows, read in
    place at the wider tensor's pitch (a hierarchical plan's groups).
    ``tiles`` is a ``runtime.SkinnyTile`` that fits the
    shape (``runtime.check_skinny``) with B's rows aligned to 4 bytes or
    more, a ``runtime.TcTile`` a tensor-core kernel takes for these
    operands with its producer (``runtime.check_tc``), or a compiled
    ``(BM, BN, BK)`` of the
    tiled kernel (or one of the tiles its sweep times,
    ``build.SWEEP_TILES``).
    """
    nd = 3 if batched else 2
    if a.dim() != nd or b.dim() != nd:
        raise ValueError(f"expected {nd}-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"shapes do not chain: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise TypeError(f"operand dtypes differ: {a.dtype} vs {b.dtype}")
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"operands must share one CUDA device, got "
                         f"{a.device} and {b.device}")
    out_dtype = out_dtype or runtime.out_dtype(a.dtype)
    if (a.dtype, out_dtype) not in build.COMPILED_DTYPES:
        raise TypeError(f"no kernel for {a.dtype} -> {out_dtype}")
    lda = runtime.a_pitch(a)
    if lda is None:
        raise ValueError("A must be contiguous or in evenly padded rows")
    layout = runtime.b_layout(b)
    if layout is None:
        raise ValueError("B must be row- or column-major at a pitch of at "
                         "least its rows' length, its batch entries apart")
    if batched and a.shape[0] > 65535:
        raise ValueError(f"batch {a.shape[0]} exceeds the grid")
    b_copy = runtime.b_copy_bytes(b)
    if isinstance(tiles, runtime.SkinnyTile):
        runtime.check_skinny(tiles, a.shape[-2], a.shape[-1], a.dtype)
        if b_copy < 4:
            raise ValueError("B's rows are not 4-byte aligned: the skinny "
                             "kernel cannot copy them (launch the tiled one)")
    elif isinstance(tiles, runtime.TcTile):
        runtime.check_tc(tiles, a, b)
    elif tuple(tiles) not in build.MM_TILES:
        raise ValueError(f"tile {tiles} is not compiled")
    elif math.ceil(b.shape[-1] / tiles[1]) > 65535:
        raise ValueError(f"grid too large for N={b.shape[-1]}, tile {tiles}")
    return (out_dtype, lda, *layout, b_copy)


def limb_planes(a, b, batch: int, m: int, n: int, k: int, col_major: int,
                lda: int):
    """Scratch for the integer tensor-core GEMM's K-major byte planes of A
    and of B (``limb_planes_kernel``): [batch, rows, k-tiles x 128] bytes
    each, or None where the kernel reads the operand itself (an int8 A, or
    an int8 B that is column-major, that TMA can address)."""
    row = -(-k * a.element_size() // runtime.TC_ROW_BYTES) \
        * runtime.TC_ROW_BYTES
    byte = a.element_size() == 1

    def scratch(rows):
        return torch.empty((batch, rows, row), dtype=torch.uint8,
                           device=a.device)

    a_direct = byte and runtime.tma_operand(a, lda)
    b_direct = byte and col_major and runtime.tma_b(b)
    return (None if a_direct else scratch(m),
            None if b_direct else scratch(n))


def launch(a, b, out, tiles, lda: int, col_major: int, ldb: int, sb: int,
           b_copy: int, batched: bool) -> str:
    """Launch ``out = a @ b`` (operands checked by ``check_operands``) on
    the kernel ``tiles`` names, on the current stream of ``a``'s card;
    return that kernel's name (a key of ``variants``), or None where the
    operands are fake and no kernel ran (``fake_launch``).  ``out`` is
    allocated under the same mode as ``a`` and ``b``, so it alone says
    whether they are fake."""
    if runtime.is_fake(out):
        fake_launch(a, b, out, tiles, batched)
        return None
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = a.shape[0] if batched else 1
    codes = build.DTYPE_CODES[a.dtype], build.DTYPE_CODES[out.dtype]
    ptrs = a.data_ptr(), b.data_ptr(), out.data_ptr()
    guard = (contextlib.nullcontext()
             if a.device.index == torch.cuda.current_device()
             else torch.cuda.device(a.device))
    with guard:
        if isinstance(tiles, runtime.SkinnyTile):
            # A's copies as wide as its rows allow with no copy straddling
            # K (a padded row's tail is not zeros); 0: plain loads
            build.call("widesa_skinny_launch", *ptrs, batch, m, n, k, lda,
                       col_major, ldb, sb, *codes, tiles.split, tiles.kblk,
                       b_copy, runtime.a_copy_bytes(a))
            return "skinny"
        if isinstance(tiles, runtime.TcTile) and a.is_floating_point():
            build.call("widesa_tc_launch", *ptrs, batch, m, n, k, lda,
                       col_major, ldb, sb, *codes, tiles.bm, tiles.bn,
                       tiles.stages, tiles.split, *tiles.copies)
            return variant_of(tiles)
        if isinstance(tiles, runtime.TcTile):
            planes = limb_planes(a, b, batch, m, n, k, col_major, lda)
            build.call("widesa_tc_int_launch", *ptrs,
                       *(p.data_ptr() if p is not None else None
                         for p in planes), batch, m, n, k, lda, col_major,
                       ldb, sb, codes[0], tiles.bm, tiles.bn, tiles.stages,
                       tiles.split)
            return "wgmma"
        if batched:
            build.call("widesa_bmm_launch", *ptrs, batch, m, n, k, lda,
                       col_major, ldb, sb, *codes, tiles=tuple(tiles))
        else:
            build.call("widesa_mm_launch", *ptrs, m, n, k, lda, col_major,
                       ldb, *codes, tiles=tuple(tiles))
    tiled_why[runtime.tiled_reason(a, b)] += 1
    return "tiled"


def variant_of(tiles) -> str:
    """The kernel ``tiles`` names, as a key of ``variants``."""
    if isinstance(tiles, runtime.SkinnyTile):
        return "skinny"
    if isinstance(tiles, runtime.TcTile):
        return "wgmma_cp" if tiles.producer == "cp" else "wgmma"
    return "tiled"


def fake_launch(a, b, out, tiles, batched: bool) -> None:
    """``launch`` on fake operands: no kernel, a record to each of
    ``fake_sinks`` (module docstring)."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    batch = a.shape[0] if batched else 1
    variant = variant_of(tiles)
    record = {
        "kernel": "bmm" if batched else "mm", "variant": variant,
        "tiles": repr(tiles), "batch": batch, "m": m, "n": n, "k": k,
        "dtype": str(a.dtype).removeprefix("torch."),
        "flops": 2 * batch * m * n * k,
        "bytes": batch * (m * k * a.element_size()
                          + k * n * b.element_size()
                          + m * n * out.element_size()),
    }
    for sink in fake_sinks:
        sink(record)


def matmul(a: torch.Tensor, b: torch.Tensor, *, tiles,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a[m,k] @ b[k,n]`` on the kernel ``tiles`` names (from
    ``runtime.gemm_tile``); floats give the input dtype (or
    ``out_dtype``), integers give int32."""
    global launches
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.mm(a, b, out_dtype)
    out_dtype, *layout = check_operands(a, b, tiles, out_dtype,
                                        batched=False)
    promote = runtime.tc_promotes(tiles, a.dtype, out_dtype, a.shape[-1])
    out = torch.empty((a.shape[0], b.shape[1]),
                      dtype=torch.float32 if promote else out_dtype,
                      device=a.device)
    if out.numel() == 0:
        return out.to(out_dtype)
    name = launch(a, b, out, tiles, *layout, batched=False)
    if name is not None:
        variants[name] += 1
        launches += 1
    return out.to(out_dtype)
