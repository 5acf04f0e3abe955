#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --tile-sweep [--out sweep.json]
    python3 chip_smoke.py --mttkrp-sweep [--out sweep.json]
    python3 chip_smoke.py --tc-sweep [--out sweep.json]
    python3 chip_smoke.py --fft-sweep [--out sweep.json]

Needs one CUDA card and the CUDA toolkit.  It imports only the port, never
JAX nor the JAX package, and runs eight phases, each printing its own
line(s); any failure exits non-zero:

1. device — the card's name and power limit, torch and CUDA versions;
2. build  — compiles the port's three CUDA sources from ``src/`` (one
   ``nvcc`` each, started together; set-up time);
3. kernels — every hand-written kernel against its plain PyTorch version
   on the card: the mm/bmm GEMMs in all five dtypes at every serving
   shape and at ragged ones on the kernel the runtime picks (the skinny
   kernel for A of at most 16 rows, the tensor-core one above in bf16 and
   float32, the tiled one for the rest), the tensor-core kernel at every
   qwen prefill GEMM of 17, 64, 127 and 512 tokens, quickstart's float32
   1024^3 and ragged shapes in bf16 -> bf16, bf16 -> fp32 and float32
   with both B layouts (and a one-TF32 control that float32's atol must
   reject), the skinny
   kernel at every M up to 16 with both B layouts and K split unevenly
   over a cluster, a misaligned B (routed to the tiled kernel where its
   rows do not allow 4-byte copies), every compiled tile of the tiled
   kernel, the bf16 -> fp32 bmm, and two runs of split-K float products
   bitwise equal; FIR and conv2d in every dtype they take, at the
   whisper-base frontend shapes and at ragged ones, with the tile the
   runtime picks and every compiled tile; the fused fft2d kernel at
   ``FFT_SHAPES`` (two runs bitwise equal) and the composition over the
   GEMMs at the frontend tile against ``torch.fft.fft2``.  Then each is
   timed beside its plain
   version, one PyTorch call computing the same function
   (``torch.matmul``/``torch.bmm``, ``F.conv1d``, ``F.conv2d``,
   ``torch.fft.fft2``: yardsticks only) and its memory/compute bound, at
   the main-path shapes and, for FIR and conv2d, at the registry's
   bandwidth-sized bench shapes.  The GEMMs (every qwen serving shape and
   whisper-base's lm_head) get ``torch.profiler`` device time of the
   skinny kernel, of the tiled kernel at the tile the plan maps to and of
   the library call, the weight GEMMs over a rotation of distinct B operands
   of ``COLD_BYTES`` so that B comes from HBM as in a decode step, and
   the host time of a wrapper call and of a planned-facade call (with a
   ``cProfile`` breakdown at one shape); the prefill GEMMs of a 512-token
   prompt and quickstart's float32 1024^3 the same for the tensor-core
   kernel, the tiled kernel and the library call; FIR, conv2d, the fused
   fft2d kernel (the composition's device time beside it, at the
   frontend tile and the pipeline's 64 x 64 grid) and their library
   calls also get their device time (the launch overhead left out), FIR
   and conv2d with every compiled tile;
4. serve  — full-width qwen1.5-0.5b (bf16, 24 layers, vocab 151936,
   random weights from a ``torch.Generator`` seeded with 0) on the slot
   engine: 4 slots, max_seq 128, 8 requests of 4-16 prompt tokens and 8
   new tokens each.  Checks every request's budget, that every planned
   site planned and never fell back, that both GEMM kernels launched
   during the drain, that the GEMMs ran on the kernel the runtime must
   pick for each shape (``check_routes``: the skinny kernel, but for the
   scores of odd-length prompts), that every GEMM shape the drain gave a
   site matches the plain version (``drain_parity``), and that each
   prompt's prefill logits match a second, explicit prefill through the
   plain versions.  One 4-lane decode step is then timed on the host
   clock and traced with ``torch.profiler`` for the card's busy time and
   the share of each GEMM kernel;
5. prefill — the same model on the slot engine with max_seq 640 serving
   4 prompts of 64, 127, 256 and 512 tokens, 8 new tokens each: the
   serve phase's checks (budgets, every site planned, ``check_routes``:
   every prefill GEMM above 16 rows on the tensor-core kernel,
   ``drain_parity``, prefill logits against the plain versions), then
   one prefill of 512 tokens timed on the host clock and traced;
6. stream — full-width whisper-base (bf16, 6+6 layers, d 512, vocab
   51865, random weights seeded with 0) on the slot engine: 4 slots,
   max_seq 128, 8 streamed int16 audio requests of 1-8 chunks and 8 new
   tokens each, every chunk through the planned frontend (FIR and conv2d
   kernels, the fft2d chain's ``xla`` stamp) and the incremental encoder.
   Checks every budget, that every site planned with no fallback
   (``frontend.*`` and ``mlp.pair`` included), that the GEMM, FIR and
   conv2d kernels launched during the drain, that every GEMM shape the
   drain gave a site matches the plain version (the d 512 projections,
   the lm_head over 51865 columns, the encoder chunk attention, the
   cross-attention over the 1500-row encoder cache), and that one
   request's features and stream-prefill logits match a run through the
   plain versions;
7. recurrences — the WideSA mapper -> kernel pipeline,
   ``repro_torch.launch.recurrences.run`` (the entry point's function):
   the Table II compiler report, quickstart's 1024^3 MM, and every
   registered recurrence planned on one chip and run through
   ``lower_plan(plan, "pallas")`` against its plain version, the stencils
   and mttkrp at their paper-scale bench sizes in every parity dtype.
   Checks that the star-stencil (B6) and MTTKRP (B7) kernels launched,
   every mttkrp case on the kernel its dtype and shape call for (every
   bench case on the tensor cores, int16 and int32 as int8 limbs) with
   each launch counted under it, the fft2d_stage case on the fused
   kernel, and every float32 mm / bmm above 16 rows on the tensor-core
   GEMM.  Then holds B6 (5-point, 9-point, and the multi-sweep
   form on its int32 state) and B7 against their plain versions at the
   bench sizes and at ragged ones, in float32, int8, int16 and int32, on
   the kernel the runtime routes each to, checks that the float32 bound
   rejects a TF32 control (the plain MTTKRP with TF32 GEMMs on), and
   times them beside their plain versions, one PyTorch call
   (``F.conv2d`` with the star as a zero-padded filter, ``torch.einsum``;
   yardsticks only) and their bounds, with ``torch.profiler`` device
   time; the tensor-core MTTKRP rows also time the CUDA-core kernel on
   the same operands and give the bound at the tensor-core rate beside
   the fp32 CUDA-core one;
8. summary — a JSON line of the kernels, the ``nvidia-smi`` name and
   power limit, and the result line.

Every wrapper's launch count is set to 0 just before each serving drain
and before the recurrence pipeline, and read just after; the kernels
line gives each path's counts apart (``"launches": {"qwen": n,
"qwen_prefill": p, "whisper_stream": m, "recurrences": k}``), and for the
two GEMM wrappers the same launches by kernel (``"launches_by_kernel"``:
skinny / wgmma / tiled) beside their device times and host time a call
(and under ``"wgmma"`` the tensor-core kernel's at its 512-token prefill
shape beside the tiled kernel's and the library's), and for mttkrp its
launches by kernel (tensor_core / cuda_core) beside the device times of
both kernels.  The comparison and
timing launches of phases 3 and 6 and of ``drain_parity`` do not count.

``--tile-sweep`` runs only the device and build phases, then times the
tiled GEMM in bf16 with each of the 24 tiles of ``build.SWEEP_TILES`` (a
second library holds those not compiled for the main path) and the
skinny GEMM with every split of K, at every main-path shape, and prints,
per shape, the tile ``runtime.hopper_tiles`` picks, the skinny
configuration ``runtime.gemm_tile`` picks and the fastest of each
(``--out`` writes all times as JSON).  ``--mttkrp-sweep`` builds only the
HPC source, then holds the tensor-core MTTKRP at the bench size in
float32, int8, int16 and int32 with every split of K (1 to 8) to the
plain version and prints each split's device time beside the CUDA-core kernel's and
``torch.einsum``'s.  ``--tc-sweep`` builds only the GEMM source, then
holds the tensor-core GEMM at the qwen prefill shapes of 512, 127 and 64
tokens (bf16) and at quickstart's float32 1024^3 to the plain version with
every compiled tile, split of K (1-4) and ring of 2 or 4 stages, and prints
each one's device time beside the runtime's pick and ``torch.matmul`` /
``torch.bmm``'s.  ``--fft-sweep`` builds the GEMM and signal-processing
sources, then holds the fused fft2d kernel at 12 x 515, 16 x 1024 and
64 x 64 with every split of K it takes to ``ref.fft2d`` and prints each
one's device time beside the composition's and ``torch.fft.fft2``'s.

Tolerances: integer results are bit-exact (wrapping int32, as XLA);
float32 results within the kernel registry's atol 1e-3 (sums of up to
2816 products, 3xTF32 on the tensor-core GEMM; 1.0 for the
fft2d, the registry's fft2d_stage atol: fp32 sums of 515
terms of magnitude ~100); bf16 results within ``2^-7 * |ref| + 1e-3``,
one bf16 rounding step of the output (8-bit significand) on top of fp32
sums taken in another order.  The logits of the whole bf16 models are
held to ``LOGIT_ATOL`` (see there); the int16 frontend features are
exact.  The stencils' and mttkrp's float32 results are held to
``recurrences.float_bound``: the registry's atol 1e-3 plus ``8 sqrt(n)
2^-24`` times the root of the sum of each output's squared terms (n
terms an output, zero-mean operands), since at the bench sizes mttkrp
sums 65536 products of magnitude ~1 and |M| reaches the hundreds.
"""

from __future__ import annotations

import ast
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: peak rates of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s
#: and bf16 / fp32 (CUDA cores) / TF32 and int8 (tensor cores) operations
#: per second.  FIR and conv2d run on the CUDA cores in every dtype, and
#: the data sheet gives no integer rate for them, so their operations
#: count at the fp32 rate (a bound that is low for integers; the bytes
#: bound them at every shape timed here anyway)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12,
                  "tfloat32": 495e12}

#: prefill logits of the bf16 models (24 layers of qwen, 6+6 of whisper),
#: hand kernels vs the plain versions: every GEMM output rounds to bf16
#: (2^-8 relative) and the two paths sum in different orders, so roundings
#: flip between them and the flips propagate through the residual layers;
#: logits are O(1) here
LOGIT_ATOL = 0.25

ARCH = "qwen1.5-0.5b"
STREAM_ARCH = "whisper-base"
SLOTS, MAX_SEQ, REQUESTS, MAX_NEW = 4, 128, 8, 8

#: the serving GEMMs of the qwen path timed in phase 3 (prefill of a
#: 12-token prompt and a 4-lane decode step), as (site, kind, shape, B
#: column-major, launches in one decode step of the 24-layer model); the
#: shapes each drain really gives are checked after it (``drain_parity``)
MAIN_SHAPES = (
    ("attn.q/k/v/out, prefill", "mm", (12, 1024, 1024), False, 0),
    ("mlp.gate/up, prefill", "mm", (12, 2816, 1024), False, 0),
    ("mlp.down, prefill", "mm", (12, 1024, 2816), False, 0),
    ("lm_head, prefill", "mm", (1, 151936, 1024), True, 0),
    ("attn.q/k/v/out, decode", "mm", (4, 1024, 1024), False, 96),
    ("mlp.gate/up, decode", "mm", (4, 2816, 1024), False, 48),
    ("mlp.down, decode", "mm", (4, 1024, 2816), False, 24),
    ("lm_head, decode", "mm", (4, 151936, 1024), True, 1),
    ("attn.decode_scores", "bmm", (64, 1, 128, 64), True, 24),
    ("attn.decode_values", "bmm", (64, 1, 64, 128), False, 24),
    ("attn.scores, prefill", "bmm", (16, 12, 12, 64), True, 0),
    ("attn.values, prefill", "bmm", (16, 12, 64, 12), False, 0),
)
#: the GEMMs timed: MAIN_SHAPES, whisper-base's tied lm_head over its
#: 51865-word vocabulary (a 4-lane decode step), B column-major, and the
#: decode scores with K^T materialized row-major (the layout before the
#: scores read K column-major), for the comparison
TIMED_SHAPES = MAIN_SHAPES + (
    ("lm_head, whisper-base decode", "mm", (4, 51865, 512), True, 0),
    ("attn.decode_scores, K^T row-major", "bmm", (64, 1, 128, 64), False,
     0))
#: qwen1.5-0.5b's prefill GEMMs of a P-token prompt (A of P rows: the
#: tensor-core kernel), as (site, kind, shape, B column-major, launches in
#: one prefill of the 24-layer model)
def prefill_shapes(p):
    return (("attn.q/k/v/out", "mm", (p, 1024, 1024), False, 96),
            ("mlp.gate/up", "mm", (p, 2816, 1024), False, 48),
            ("mlp.down", "mm", (p, 1024, 2816), False, 24),
            ("attn.scores", "bmm", (16, p, p, 64), True, 24),
            ("attn.values", "bmm", (16, p, 64, p), False, 24))


#: prompt lengths of the tensor-core parity cases, the prefill timed, and
#: the prompts the prefill phase serves
TC_PROMPTS = (17, 64, 127, 512)
TC_TIMED_PROMPT = 512
PREFILL_PROMPTS = (64, 127, 256, 512)
PREFILL_MAX_SEQ = 640
#: quickstart's float32 MM, and ragged shapes (M and N no multiple of any
#: tile, K rows whole 16-byte units) for the tensor-core kernel
QUICKSTART = ("mm", (1024, 1024, 1024))
TC_RAGGED = (("mm", (100, 200, 136)), ("bmm", (3, 61, 72, 64)))
RAGGED_SHAPES = (("mm", (61, 126, 37)), ("mm", (1, 300, 77)),
                 ("bmm", (3, 61, 126, 37)), ("bmm", (5, 7, 33, 130)))
#: the skinny kernel at every row count up to 16: N, and a K that no split
#: divides (B above 1 MiB in every dtype, so the runtime splits K over 8
#: blocks of a cluster)
SKINNY_NK = (96, 11004)
#: bytes of distinct B operands a weight GEMM is timed over, so that each
#: launch reads its B from HBM as a decode step does (the L2 holds 50 MB)
COLD_BYTES = 80 * 2**20

#: the kernel row of each ported TPU kernel: its main-path shape for the
#: timing columns, what it replaces and where its source is
SOURCE = "src/repro_torch/kernels/csrc/widesa_mm.cu"
SP_SOURCE = "src/repro_torch/kernels/csrc/widesa_sp.cu"
HPC_SOURCE = "src/repro_torch/kernels/csrc/widesa_hpc.cu"
KERNELS = {
    "widesa_mm": dict(kind="mm", shape=(4, 151936, 1024), col_major=True,
                      replaces="src/repro/kernels/widesa_mm.py:31",
                      source=SOURCE),
    "bmm": dict(kind="bmm", shape=(64, 1, 128, 64), col_major=True,
                replaces="src/repro/kernels/bmm.py:24", source=SOURCE),
    "fir": dict(replaces="src/repro/kernels/fir.py:25", source=SP_SOURCE),
    "conv2d": dict(replaces="src/repro/kernels/conv2d.py:32",
                   source=SP_SOURCE),
    # the fused kernel (the composition over the GEMMs above for taller
    # grids)
    "fft2d": dict(replaces="src/repro/kernels/fft2d.py:34",
                  source=SP_SOURCE),
    # one kernel for jacobi2d, jacobi2d_9pt and each sweep of jacobi2d_ms
    "jacobi2d": dict(replaces="src/repro/kernels/jacobi2d.py:31",
                     source=HPC_SOURCE),
    "mttkrp": dict(replaces="src/repro/kernels/mttkrp.py:29",
                   source=HPC_SOURCE),
}

#: the tensor-core kernel's row in the kernels line: the P = 512 prefill
#: shape of each GEMM wrapper
WGMMA_SHAPES = {"widesa_mm": ("mm", (512, 1024, 1024), False),
                "bmm": ("bmm", (16, 512, 512, 64), True)}

#: the frontend shapes of whisper-base (FrontendConfig(d_model=512): a
#: 12 x 515 tile of 6180 samples, 15 taps, a 5 x 4 filter, int16), ragged
#: shapes, and the registry's bandwidth-sized bench shapes (float32)
SP_MAIN = {"fir": (6180, 15), "conv2d": (8, 512, 5, 4)}
SP_RAGGED = {"fir": ((1000, 7), (70001, 15)),
             "conv2d": ((37, 70, 3, 5), (130, 333, 4, 4))}
SP_BENCH = {"fir": (1048576, 15), "conv2d": (10240, 10240, 4, 4)}
FFT_MAIN = (12, 515)
#: the fused fft2d kernel's parity shapes: the frontend's, a wider one, a
#: single row, ragged ones (C no multiple of 4 or of the 32-column tile),
#: and the recurrence pipeline's fft2d_stage smoke grid (64 rows: the
#: kernel's largest), the two timed
FFT_PIPELINE = (64, 64)
FFT_SHAPES = (FFT_MAIN, (16, 1024), (1, 7), (12, 67), (7, 130), FFT_PIPELINE)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def wrappers() -> dict:
    """Each kernel's wrapper module, which holds its launch count."""
    from repro_torch.kernels import (bmm, conv2d, fft2d, fir, jacobi2d,
                                     mttkrp, widesa_mm)

    return {"widesa_mm": widesa_mm, "bmm": bmm, "fir": fir,
            "conv2d": conv2d, "fft2d": fft2d, "jacobi2d": jacobi2d,
            "mttkrp": mttkrp}


def reset_counts() -> None:
    for mod in wrappers().values():
        mod.launches = 0
        for variant in getattr(mod, "variants", {}):
            mod.variants[variant] = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in wrappers().items()}


def read_variants() -> dict:
    """The wrappers' launches by kernel: the GEMMs' (skinny / wgmma /
    tiled), mttkrp's (tensor_core / cuda_core), fft2d's (fused /
    composition)."""
    return {name: dict(mod.variants) for name, mod in wrappers().items()
            if hasattr(mod, "variants")}


def col_major_site(site: str, shape) -> bool:
    """Whether a serving site reads B column-major: the tied lm_head (the
    embedding table), the attention scores (K^T as the transpose of K's
    rows) and a single column."""
    return site == "lm_head" or "scores" in site or shape[-2] == 1


def padded_site(site: str) -> bool:
    """Whether a serving site's A comes in rows padded to whole 16-byte
    units: the prompt's attention values (the softmax weights)."""
    return site == "attn.values"


def padded(torch, a):
    """``a`` in rows padded to whole 16-byte units, as the attention layer
    hands the values bmm its softmax weights (a view of the first K
    columns)."""
    k, unit = a.shape[-1], 16 // a.element_size()
    rows = torch.empty((*a.shape[:-1], -(-k // unit) * unit), dtype=a.dtype,
                       device=a.device)[..., :k]
    rows.copy_(a)
    return rows


def serving_kernel(site: str, shape) -> str:
    """The kernel the runtime must pick for a serving GEMM (bf16, fresh
    16-byte aligned operands, A contiguous or, for the values, in padded
    rows): the skinny kernel for at most 16 rows of A where B's rows allow
    4-byte copies, the tensor-core kernel for more rows where TMA can
    address A's and B's rows (whole 16-byte units), else the tiled
    kernel."""
    from repro_torch.kernels import runtime

    m, n, k = shape[-3:]
    inner = k if col_major_site(site, shape) else n
    if m <= runtime.SKINNY_ROWS:
        return "skinny" if runtime.copy_bytes(0, 2 * inner) >= 4 else "tiled"
    whole = (padded_site(site) or runtime.copy_bytes(0, 2 * k) == 16) and \
        runtime.copy_bytes(0, 2 * inner) == 16
    return "wgmma" if whole else "tiled"


def check_routes(path: str, report: dict, variants: dict) -> str:
    """Hold a serving drain's GEMM launches by kernel to what the runtime
    must pick for the shapes the drain gave each site (``serving_kernel``;
    the scores read K column-major and the values their weights in padded
    rows, so both take 16-byte units at any prompt length).  Fail on any
    other launch count; return the explanation of any tiled launch."""
    want = {"widesa_mm": {}, "bmm": {}}
    why = []
    for site, st in report.items():
        if site.startswith(NON_GEMM_SITES):
            continue
        for key, count in st["shapes"].items():
            shape = ast.literal_eval(key)
            kind = "widesa_mm" if len(shape) == 3 else "bmm"
            kernel = serving_kernel(site, shape)
            want[kind][kernel] = want[kind].get(kernel, 0) + count
            if kernel == "tiled":
                why.append(f"{site} {shape} x{count}")
    got = {name: {v: n for v, n in variants[name].items() if n}
           for name in want}
    if got != want:
        fail(f"{path}: GEMM launches by kernel {got}, the shapes call for "
             f"{want} (tiled: {why})")
    return (f"tiled launches {sum(g.get('tiled', 0) for g in got.values())}"
            f", each for rows neither other kernel takes: {why}" if why
            else "no tiled launch")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def draw(torch, gen, shape, dtype, device="cuda"):
    """Operands spanning each dtype's range (integers exercise wraparound)."""
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=device).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=gen,
                         device=device, dtype=torch.int64).to(dtype)


def operands(torch, gen, kind, shape, dtype, col_major):
    """A row-major, and B row-major or (``col_major``) the transpose of a
    row-major [.., N, K] tensor."""
    (m, n, k), lead = shape[-3:], shape[:-3]
    a = draw(torch, gen, (*lead, m, k), dtype)
    b = (draw(torch, gen, (*lead, n, k), dtype).transpose(-1, -2)
         if col_major else draw(torch, gen, (*lead, k, n), dtype))
    return a, b


def gemm_fn(kind):
    from repro_torch.kernels import bmm, widesa_mm

    return widesa_mm.matmul if kind == "mm" else bmm.bmm


def gemm_plan(kind, shape, dtype):
    from repro_torch.kernels import planned

    plan = planned.plan_for(kind, shape, planned.dtype_name(dtype))
    if plan is None:
        fail(f"no feasible plan for {kind}{shape} {dtype}")
    return plan


def kernel_call(kind, shape, dtype, a, b, out_dtype=None):
    """The hand kernel on the configuration the serving path picks for
    these operands (the registry's ``tiles``: ``runtime.gemm_tiles``):
    (call, HopperTiles)."""
    from repro_torch.kernels import registry

    tiles = registry.get(kind).tiles(gemm_plan(kind, shape, dtype), a, b)
    fn = gemm_fn(kind)
    return (lambda x, y: fn(x, y, tiles=tiles.tile, out_dtype=out_dtype)), \
        tiles


def tiled_call(kind, shape, dtype, col_major, out_dtype=None):
    """The tiled kernel at the tile the plan maps onto
    (``runtime.hopper_tiles``), as the serving GEMMs ran before the
    skinny kernel: (call, tile)."""
    from repro_torch.kernels import runtime

    tile = runtime.hopper_tiles(gemm_plan(kind, shape, dtype),
                                b_col_major=col_major).tile
    fn = gemm_fn(kind)
    return (lambda x, y: fn(x, y, tiles=tile, out_dtype=out_dtype)), tile


def describe(tile, kind=None, shape=None) -> str:
    """A GEMM launch configuration in words (with its grid for a shape)."""
    from repro_torch.kernels import runtime

    if isinstance(tile, runtime.TcTile):
        text = (f"wgmma {tile.bm}x{tile.bn} split {tile.split} stages "
                f"{tile.stages}")
        if shape is not None:
            (m, n), z = shape[-3:-1], (shape[0] if kind == "bmm" else 1)
            text += f" ({tile.blocks(m, n, z)} blocks)"
        return text
    if not isinstance(tile, runtime.SkinnyTile):
        return f"tiled {tuple(tile)}"
    text = f"skinny split {tile.split} x {tile.kblk}"
    if shape is not None:
        n, z = (shape[1], 1) if kind == "mm" else (shape[2], shape[0])
        text += f" ({tile.blocks(n, z)} blocks)"
    return text


def max_error(torch, out, want, dtype) -> tuple[float, bool]:
    """(max |out - want|, within tolerance) for one output dtype."""
    if out.shape != want.shape or out.dtype != want.dtype:
        return float("inf"), False
    diff = (out.double() - want.double()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    if not dtype.is_floating_point:
        return err, err == 0
    if dtype == torch.float32:
        return err, err <= 1e-3
    bound = 2.0 ** -7 * want.double().abs() + 1e-3
    return err, bool((diff <= bound).all())


GEMM_DTYPES = ("float32", "bfloat16", "int8", "int16", "int32")


def parity(torch) -> None:
    """The GEMM kernels against their plain versions, all five dtypes: the
    serving and ragged shapes on the configuration the runtime picks; the
    skinny kernel at every M up to 16, both B layouts, K split unevenly;
    a misaligned B, which must take the tiled kernel; every compiled tile
    of the tiled kernel; the bf16 -> fp32 bmm; two runs of split-K float
    products bitwise equal."""
    from collections import Counter

    from repro_torch.kernels import bmm, build, ref, runtime, widesa_mm

    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = [getattr(torch, d) for d in GEMM_DTYPES]
    n, routes = 0, Counter()

    def check(what, out, want, dtype):
        nonlocal n
        torch.cuda.synchronize()
        err, ok = max_error(torch, out, want, dtype)
        if not ok:
            fail(f"{what}: max |err| {err}")
        n += 1

    cases = [(kind, shape, col) for _, kind, shape, col, _ in TIMED_SHAPES]
    cases += [(kind, shape, False) for kind, shape in RAGGED_SHAPES]
    cases += [("mm", (61, 126, 37), True)]
    for dtype in dtypes:
        for kind, shape, col in cases:
            a, b = operands(torch, gen, kind, shape, dtype, col)
            fn, tiles = kernel_call(kind, shape, dtype, a, b)
            plain = ref.mm if kind == "mm" else ref.bmm
            check(f"{kind}{shape} {dtype} {describe(tiles.tile)}", fn(a, b),
                  plain(a, b), dtype)
            routes[describe(tiles.tile).split()[0]] += 1
            del a, b
    # the skinny kernel at M = 1..16 and both layouts, K split unevenly
    sn, sk = SKINNY_NK
    for dtype in dtypes:
        for m in range(1, 17):
            for col in (False, True):
                a, b = operands(torch, gen, "mm", (m, sn, sk), dtype, col)
                tile = runtime.gemm_tile(a, b, (16, 32, 32))
                if not isinstance(tile, runtime.SkinnyTile) or \
                        sk % tile.split == 0:
                    fail(f"mm({m},{sn},{sk}) {dtype}: {tile} is not an "
                         f"uneven skinny split")
                check(f"mm({m},{sn},{sk}) {dtype} col_major={col} "
                      f"{describe(tile)}", widesa_mm.matmul(a, b, tiles=tile),
                      ref.mm(a, b), dtype)
    # a B one element off its 16-byte boundary takes the tiled kernel
    for dtype in dtypes:
        a = draw(torch, gen, (4, 64), dtype)
        b = draw(torch, gen, (64 * 130 + 1,), dtype)[1:].view(64, 130)
        tile = runtime.gemm_tile(a, b, (4, 32, 32))
        want_tiled = runtime.b_copy_bytes(b) < 4
        before = dict(widesa_mm.variants)
        check(f"misaligned mm(4,130,64) {dtype} {describe(tile)}",
              widesa_mm.matmul(a, b, tiles=tile), ref.mm(a, b), dtype)
        went = "tiled" if widesa_mm.variants["tiled"] > before["tiled"] \
            else "skinny"
        if went != ("tiled" if want_tiled else "skinny"):
            fail(f"misaligned mm {dtype} (B copies of "
                 f"{runtime.b_copy_bytes(b)} bytes) ran {went}")
        routes[f"misaligned {str(dtype).removeprefix('torch.')} -> {went}"] \
            += 1
    # every compiled tile of the tiled kernel, including those no plan
    # picks, on a ragged mm (column-major B) and a ragged bmm
    for tiles in build.COMPILED_TILES:
        for dtype in dtypes:
            for kind, shape, col in (("mm", (61, 126, 37), True),
                                     ("bmm", (3, 61, 126, 37), False)):
                a, b = operands(torch, gen, kind, shape, dtype, col)
                fn, plain = ((widesa_mm.matmul, ref.mm) if kind == "mm"
                             else (bmm.bmm, ref.bmm))
                check(f"{kind}{shape} {dtype} tile {tiles}",
                      fn(a, b, tiles=tiles), plain(a, b), dtype)
    # attention scores: bf16 operands, the fp32 accumulator flushed as is
    for _, kind, shape, *_ in MAIN_SHAPES:
        if kind != "bmm":
            continue
        a, b = operands(torch, gen, kind, shape, torch.bfloat16, False)
        fn, tiles = kernel_call(kind, shape, torch.bfloat16, a, b,
                                torch.float32)
        check(f"bmm{shape} bf16->fp32 {describe(tiles.tile)}", fn(a, b),
              ref.bmm(a, b, torch.float32), torch.float32)
    # the cluster adds partial tiles in a fixed order: the same bits twice
    same = []
    for kind, shape in (("mm", (4, 1024, 2816)), ("mm", (12, 1024, 1024)),
                        ("bmm", (32, 1, 64, 1500))):
        for dtype in (torch.bfloat16, torch.float32):
            a, b = operands(torch, gen, kind, shape, dtype, False)
            fn, tiles = kernel_call(kind, shape, dtype, a, b)
            if tiles.tile.split < 2:
                fail(f"{kind}{shape} {dtype}: no split ({tiles.tile})")
            first, again = fn(a, b), fn(a, b)
            torch.cuda.synchronize()
            if not torch.equal(first, again):
                fail(f"{kind}{shape} {dtype} {describe(tiles.tile)}: two "
                     f"runs differ")
            same.append(f"{kind}{shape} {str(dtype).removeprefix('torch.')} "
                        f"split {tiles.tile.split}")
    print(f"kernels: GEMM parity ok in {n} cases (5 dtypes x "
          f"{len(cases)} serving/ragged shapes on the runtime's pick, "
          f"skinny at M = 1..16 x 2 layouts at (N, K) = {SKINNY_NK}, a "
          f"misaligned B, every compiled tile x 2 ragged shapes, bf16->fp32 "
          f"bmm): integers bit-exact, fp32 <= 1e-3, bf16 <= 2^-7|ref| + "
          f"1e-3; routes {dict(routes)}; bitwise equal on two runs: "
          f"{same}", flush=True)


#: the (input, output) dtypes of the tensor-core kernel: bf16 to bf16, bf16
#: to fp32 (the attention scores), float32 (3xTF32)
TC_DTYPES = (("bfloat16", None), ("bfloat16", "float32"),
             ("float32", None))


def tc_cases():
    """(kind, shape, A in padded rows) of the tensor-core parity cases:
    every prefill GEMM of a prompt of ``TC_PROMPTS`` tokens (the values'
    A padded, as the attention layer pads it), quickstart's 1024^3, the
    ragged shapes."""
    cases = [(kind, shape, padded_site(site)) for p in TC_PROMPTS
             for site, kind, shape, _, _ in prefill_shapes(p)]
    return cases + [(*QUICKSTART, False),
                    *((kind, shape, False) for kind, shape in TC_RAGGED)]


def tc_parity(torch) -> None:
    """The tensor-core kernel against its plain version (``tc_cases``) in
    bf16 -> bf16, bf16 -> fp32 and float32, each B layout, on the
    configuration the runtime picks: ``wgmma`` wherever TMA can address the
    operands (else the tiled kernel), every launch counted there; two runs
    of split-K products bitwise equal; a one-TF32 control (the plain
    version with TF32 GEMMs) must fail float32's atol at quickstart's
    1024^3."""
    from collections import Counter

    from repro_torch.kernels import bmm, ref, runtime, widesa_mm

    gen = torch.Generator(device="cuda").manual_seed(10)
    n, routes, worst = 0, Counter(), {}
    for kind, shape, pad in tc_cases():
        for in_name, out_name in TC_DTYPES:
            dtype = getattr(torch, in_name)
            out_dtype = out_name and getattr(torch, out_name)
            for col in (False, True):
                a, b = operands(torch, gen, kind, shape, dtype, col)
                if pad:
                    a = padded(torch, a)
                fn, tiles = kernel_call(kind, shape, dtype, a, b, out_dtype)
                tma = runtime.tma_operand(a, runtime.a_pitch(a)) and \
                    runtime.tma_operand(b, shape[-1] if col else shape[-2])
                want_kernel = "wgmma" if tma else "tiled"
                mod = widesa_mm if kind == "mm" else bmm
                before = dict(mod.variants)
                out = fn(a, b)
                plain = ref.mm if kind == "mm" else ref.bmm
                want = plain(a, b, out_dtype)
                torch.cuda.synchronize()
                went = [v for v in mod.variants
                        if mod.variants[v] != before[v]]
                label = (f"{kind}{shape} {in_name}->{out_name or in_name} "
                         f"col_major={col}{' A padded' if pad else ''} "
                         f"{describe(tiles.tile, kind, shape)}")
                if went != [want_kernel]:
                    fail(f"{label}: ran {went}, the operands call for "
                         f"{want_kernel}")
                err, ok = max_error(torch, out, want, out.dtype)
                if not ok:
                    fail(f"{label}: max |err| {err}")
                key = f"{in_name}->{out_name or in_name}"
                worst[key] = max(worst.get(key, 0.0), err)
                routes[want_kernel] += 1
                n += 1
                del a, b, out, want
    same = []
    for kind, shape in (("mm", (512, 1024, 1024)), ("bmm", (16, 512, 64, 512)),
                        QUICKSTART):
        for dtype in (torch.bfloat16, torch.float32):
            a, b = operands(torch, gen, kind, shape, dtype, False)
            fn, tiles = kernel_call(kind, shape, dtype, a, b)
            if not isinstance(tiles.tile, runtime.TcTile):
                fail(f"{kind}{shape} {dtype}: not on the tensor-core kernel")
            first, again = fn(a, b), fn(a, b)
            torch.cuda.synchronize()
            if not torch.equal(first, again):
                fail(f"{kind}{shape} {dtype} {describe(tiles.tile)}: two runs "
                     "differ")
            same.append(f"{kind}{shape} {str(dtype).removeprefix('torch.')} "
                        f"split {tiles.tile.split}")
    # one TF32 product: the plain version with TF32 GEMMs must fail
    a, b = operands(torch, gen, *QUICKSTART, torch.float32, False)
    want = ref.mm(a, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = ref.mm(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err, ok = max_error(torch, control, want, torch.float32)
    if ok:
        fail(f"the one-TF32 control of {QUICKSTART} passes float32's atol "
             f"1e-3 (max |err| {err})")
    print(f"kernels: tensor-core GEMM parity ok in {n} cases (qwen prefill "
          f"GEMMs at P = {TC_PROMPTS} with the values' A in padded rows, "
          f"quickstart's {QUICKSTART[1]}, ragged {TC_RAGGED}; x "
          f"{len(TC_DTYPES)} dtype pairs x 2 B layouts): "
          f"launches by kernel {dict(routes)} (tiled: rows TMA cannot "
          f"address); max |err| by dtype {({k: f'{v:.4g}' for k, v in worst.items()})} "
          f"(fp32 <= 1e-3, bf16 <= 2^-7|ref| + 1e-3); bitwise equal on two "
          f"runs: {same}; one-TF32 control max |err| {err:.4g} > 1e-3 "
          f"(rejected)", flush=True)


def tc_timings(torch) -> dict:
    """The tensor-core kernel at the prefill shapes of a
    ``TC_TIMED_PROMPT``-token prompt (bf16; the scores flush to fp32) and
    at quickstart's float32 1024^3: ``torch.profiler`` device time of the
    kernel on the runtime's configuration, of the tiled kernel at the
    tile the plan maps to and of ``torch.matmul``/``torch.bmm``, beside
    the bound (bf16 at 989 TFLOP/s, float32 at 495/3 TFLOP/s: three TF32
    products a product) and the host time of a wrapper call.  The weight
    GEMMs read B over a rotation of ``COLD_BYTES``."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    timed = [(site, kind, shape, col, n, "bfloat16")
             for site, kind, shape, col, n in prefill_shapes(TC_TIMED_PROMPT)]
    timed.append(("quickstart", *QUICKSTART, False, 0, "float32"))
    for site, kind, shape, col, _, dname in timed:
        dtype = getattr(torch, dname)
        out_dtype = torch.float32 if "scores" in site else None
        a, bs = rotation(torch, gen, kind, shape, col, dtype)
        b = bs[0]
        fn, tiles = kernel_call(kind, shape, dtype, a, b, out_dtype)
        tiled, tile = tiled_call(kind, shape, dtype, col, out_dtype)
        lib = torch.matmul if kind == "mm" else torch.bmm

        def library(x, y):
            return lib(x, y) if out_dtype is None else lib(x, y, out_dtype)

        out = fn(a, b)
        plain = ref.mm if kind == "mm" else ref.bmm
        err, _ = max_error(torch, out, plain(a, b, out_dtype), out.dtype)
        reps = max(10, len(bs))
        row = dict(
            tiles=tiles, tiled_tile=tile, max_abs_err=err,
            device_ms=device_ms(torch, cycling(fn, a, bs), "gemm_tc_kernel",
                                reps),
            tiled_device_ms=device_ms(torch, cycling(tiled, a, bs),
                                      "gemm_kernel", reps),
            library_device_ms=device_ms(torch, cycling(library, a, bs), None,
                                        reps),
            plain_ms=time_ms(torch, lambda: plain(a, b, out_dtype)),
            host_us=host_us(torch, cycling(fn, a, bs)),
        )
        if dname == "float32":  # three TF32 products a product
            m, n, k = shape
            row["bound_ms"], row["bound_by"] = least_ms(
                (m * k + k * n + m * n) * 4, 3 * 2 * m * n * k, "tfloat32")
        else:
            row["bound_ms"], row["bound_by"] = bound_ms(
                kind, shape, 2, out.element_size(), "bfloat16")
        rows[(kind, shape, col)] = row
        lib_name = f"torch.{lib.__name__}"
        print(f"time {kind}{shape} {dname}{'->fp32' if out_dtype else ''} "
              f"[{site}] {describe(tiles.tile, kind, shape)}"
              f"{', B column-major' if col else ''}: device (profiler; "
              f"{len(bs)} B operand(s)) wgmma {fmt_ms(row['device_ms'])}, "
              f"tiled {tile} {fmt_ms(row['tiled_device_ms'])}, {lib_name} "
              f"{fmt_ms(row['library_device_ms'])}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}"
              f"{', 3xTF32' if dname == 'float32' else ''}); plain "
              f"{row['plain_ms']:.4f} ms (CUDA events); host per wrapper "
              f"call {row['host_us']:.1f} us; max |err| {err:.4g}",
              flush=True)
        del a, b, bs, out
    per = {key: sum(n * (rows[(kind, shape, col)][key] or 0.0)
                    for _, kind, shape, col, n in
                    prefill_shapes(TC_TIMED_PROMPT))
           for key in ("device_ms", "tiled_device_ms", "library_device_ms",
                       "bound_ms")}
    print(f"time: the {sum(s[-1] for s in prefill_shapes(TC_TIMED_PROMPT))} "
          f"GEMMs above 16 rows of a {TC_TIMED_PROMPT}-token qwen prefill, "
          f"summed from the device times above: wgmma "
          f"{per['device_ms']:.4f} ms, tiled {per['tiled_device_ms']:.4f} ms, "
          f"library {per['library_device_ms']:.4f} ms, bound "
          f"{per['bound_ms']:.4f} ms", flush=True)
    return rows


#: report sites whose shapes are not one GEMM: the frontend's FIR, conv2d
#: and fft2d chain (held in phase 3) and the MLP pair's ``xla`` stamp
NON_GEMM_SITES = ("frontend.", "mlp.pair")


def drain_parity(torch, report, path: str) -> None:
    """Every GEMM shape a serving drain gave a site (``planned_report``),
    through the hand kernel on the configuration the runtime picks against
    the plain version, in bf16 (the serving dtype), in the drain's
    layouts: the lm_head and the scores read B column-major, the values
    their A in padded rows; the score sites flush to fp32.
    Run after the drain's counts are read, so these launches count for
    no path."""
    from collections import Counter

    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = sorted({(site, ast.literal_eval(key))
                    for site, st in report.items()
                    if not site.startswith(NON_GEMM_SITES)
                    for key in st["shapes"]})
    worst, routes = 0.0, Counter()
    for site, shape in cases:
        kind = "mm" if len(shape) == 3 else "bmm"
        col = col_major_site(site, shape)
        out_dtype = torch.float32 if "scores" in site else None
        a, b = operands(torch, gen, kind, shape, torch.bfloat16, col)
        if padded_site(site):
            a = padded(torch, a)
        fn, tiles = kernel_call(kind, shape, torch.bfloat16, a, b, out_dtype)
        plain = ref.mm if kind == "mm" else ref.bmm
        out, want = fn(a, b), plain(a, b, out_dtype)
        torch.cuda.synchronize()
        err, ok = max_error(torch, out, want, out.dtype)
        if not ok:
            fail(f"{path}: {site} {kind}{shape} bf16 {describe(tiles.tile)}: "
                 f"max |err| {err}")
        worst = max(worst, err)
        routes[describe(tiles.tile).split()[0]] += 1
        del a, b, out, want
    print(f"{path}: the {len(cases)} GEMM (site, shape) pairs of the drain "
          f"match the plain versions in bf16 on the runtime's configuration "
          f"({dict(routes)}; bf16 <= 2^-7|ref| + 1e-3, fp32 scores <= 1e-3; "
          f"max |err| {worst:.4g}): {sorted({s for s, _ in cases})}",
          flush=True)


def time_ms(torch, fn, reps=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(torch, fn, kernel=None, reps=10, launches=1):
    """Device time per call of ``fn`` from ``torch.profiler`` over ``reps``
    calls; None if two traces recorded nothing.  With ``kernel``: the
    mean time of the CUDA kernel records whose name holds ``kernel``,
    times ``launches`` (those kernels a call), since the profiler can drop
    device records (all of a short kernel's, now and then: hence the
    second trace) and each record it keeps is one launch's time.
    Without: every device event of the trace, over ``reps``.  Unlike
    ``time_ms`` this leaves out the host's launch overhead, which back-to-
    back launches of a short kernel measure instead of the kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [evt for evt in prof.key_averages()
                if kernel is None or kernel in evt.key]
        us = sum(getattr(evt, "self_device_time_total", 0.0) for evt in evts)
        if us:
            break
    else:
        return None
    if kernel is None:
        return us / reps / 1e3
    return us / sum(evt.count for evt in evts) * launches / 1e3


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def least_ms(moved, ops, dtype_name):
    """The larger of ``moved`` bytes at the HBM rate and ``ops``
    operations at the peak rate of ``dtype_name``, with what bounds it."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(kind, shape, in_bytes, out_bytes, dtype_name):
    """Least time for the work: each input read once and the output
    written once at the HBM rate, or the multiply-adds at the peak rate
    of the operand type, whichever is larger."""
    if kind == "mm":
        (m, n, k), z = shape, 1
    else:
        z, m, n, k = shape
    moved = z * ((m * k + k * n) * in_bytes + m * n * out_bytes)
    return least_ms(moved, 2 * z * m * n * k, dtype_name)


def host_us(torch, fn, calls=200) -> float:
    """Host time of one call of ``fn`` in microseconds: ``calls`` back-to-
    back calls on the host clock, with no synchronisation between them
    (what the Python side costs a launch while the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def host_profile(torch, label, fn, calls=500, top=8) -> None:
    """Where the host time of ``fn`` goes: ``cProfile`` over ``calls``
    back-to-back calls, the ``top`` functions by their own time."""
    import cProfile
    import pstats

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    total = sum(v[2] for v in stats.stats.values()) / calls * 1e6
    parts = ", ".join(f"{name}:{line} {v[2] / calls * 1e6:.1f}"
                      for (path, line, name), v in rows)
    print(f"host profile of {label} (cProfile, {calls} calls, us a call, "
          f"profiler overhead included): total {total:.1f}; by own time: "
          f"{parts}", flush=True)


def rotation(torch, gen, kind, shape, col, dtype):
    """A, and distinct B operands totalling at least ``COLD_BYTES`` (two at
    least) for an mm, so that no launch finds its B in the L2; one B for a
    bmm."""
    a, b = operands(torch, gen, kind, shape, dtype, col)
    bs = [b]
    if kind == "mm":
        copies = max(2, math.ceil(COLD_BYTES / (b.numel() * b.element_size())))
        bs += [operands(torch, gen, kind, shape, dtype, col)[1]
               for _ in range(copies - 1)]
    return a, bs


def cycling(fn, a, bs):
    """``fn(a, b)`` over the B operands ``bs`` in turn."""
    turn = itertools.cycle(bs)
    return lambda: fn(a, next(turn))


def timings(torch) -> dict:
    """The GEMMs at the timed shapes in bf16 (the serving dtype; scores
    flush to fp32): the skinny kernel on the runtime's configuration, the
    tiled kernel at its tile, ``torch.matmul``/``torch.bmm`` and
    the bound, with ``torch.profiler`` device time (the mm rows over
    distinct B operands totalling ``COLD_BYTES``, read cold from HBM),
    CUDA-event times of back-to-back calls (the host's launch rate where
    it is slower than the card), and the host time of a wrapper call and
    of a planned-facade call."""
    from repro_torch.kernels import planned, ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for site, kind, shape, col, _ in TIMED_SHAPES:
        out_dtype = torch.float32 if "scores" in site else None
        a, bs = rotation(torch, gen, kind, shape, col, torch.bfloat16)
        b = bs[0]
        fn, tiles = kernel_call(kind, shape, torch.bfloat16, a, b, out_dtype)
        tiled, tile = tiled_call(kind, shape, torch.bfloat16, col, out_dtype)
        plain = ref.mm if kind == "mm" else ref.bmm
        lib = torch.matmul if kind == "mm" else torch.bmm

        def library(x, y):
            # torch.bmm's out_dtype is the same fp32 flush of bf16 inputs
            return lib(x, y) if out_dtype is None else lib(x, y, out_dtype)

        def facade(x, y):
            if kind == "mm":
                return planned.planned_dense(x, y, site="timing")
            return planned.planned_bmm(x, y, site="timing",
                                       out_dtype=out_dtype)

        out, want = fn(a, b), plain(a, b, out_dtype)
        err, _ = max_error(torch, out, want, out.dtype)
        reps = max(10, len(bs))
        row = dict(
            tiles=tiles, tiled_tile=tile, max_abs_err=err,
            cold=len(bs) > 1,
            device_ms=device_ms(torch, cycling(fn, a, bs), "skinny_kernel",
                                reps),
            tiled_device_ms=device_ms(torch, cycling(tiled, a, bs),
                                      "gemm_kernel", reps),
            library_device_ms=device_ms(torch, cycling(library, a, bs),
                                        None, reps),
            ms=time_ms(torch, cycling(fn, a, bs)),
            plain_ms=time_ms(torch, lambda: plain(a, b, out_dtype)),
            library_ms=time_ms(torch, cycling(library, a, bs)),
            host_us=host_us(torch, cycling(fn, a, bs)),
            facade_us=host_us(torch, cycling(facade, a, bs)),
        )
        row["bound_ms"], row["bound_by"] = bound_ms(
            kind, shape, 2, out.element_size(), "bfloat16")
        rows[(kind, shape, col)] = row
        lib_name = f"torch.{lib.__name__}"
        held = (f"{len(bs)} B operands of "
                f"{b.numel() * b.element_size() / 2**20:.1f} MiB, cold"
                if row["cold"] else "one B, warm")
        print(f"time {kind}{shape} bf16 [{site}] "
              f"{describe(tiles.tile, kind, shape)}{', B column-major' if col else ''}: device ({held}) "
              f"skinny {fmt_ms(row['device_ms'])}, tiled {tile} "
              f"{fmt_ms(row['tiled_device_ms'])}, {lib_name} "
              f"{fmt_ms(row['library_device_ms'])}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); CUDA events: "
              f"skinny {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"{lib_name} {row['library_ms']:.4f} ms; host per call: "
              f"wrapper {row['host_us']:.1f} us, planned facade "
              f"{row['facade_us']:.1f} us", flush=True)
        if (kind, shape) == ("mm", (4, 1024, 1024)):
            host_profile(torch, f"the mm wrapper at {shape}",
                         cycling(fn, a, bs))
            host_profile(torch, f"planned_dense at {shape}",
                         cycling(facade, a, bs))
        del a, b, bs, out, want
    # the GEMM share of one decode step, from the per-shape device times
    step = {key: sum(n * (rows[(kind, shape, col)][key] or 0.0)
                     for _, kind, shape, col, n in MAIN_SHAPES)
            for key in ("device_ms", "tiled_device_ms", "library_device_ms",
                        "bound_ms")}
    print(f"time: the {sum(s[-1] for s in MAIN_SHAPES)} GEMMs of a 4-lane "
          f"qwen decode step, summed from the device times above: skinny "
          f"{step['device_ms']:.4f} ms, tiled "
          f"{step['tiled_device_ms']:.4f} ms, library "
          f"{step['library_device_ms']:.4f} ms, bound "
          f"{step['bound_ms']:.4f} ms", flush=True)
    slower = [f"{kind}{shape}" for (kind, shape, _), row in rows.items()
              if None not in (row["device_ms"], row["tiled_device_ms"])
              and row["device_ms"] > row["tiled_device_ms"]]
    print(f"time: shapes where the skinny kernel's device time is above the "
          f"tiled kernel's: {slower or 'none'}", flush=True)
    return rows


def tile_sweep(torch) -> list[dict]:
    """Every sweep tile of the tiled kernel, and every split of the skinny
    kernel, at every main-path shape, bf16 (profiler device time for the
    skinny kernel, CUDA events for the tiled one)."""
    from repro_torch.kernels import build, runtime

    gen = torch.Generator(device="cuda").manual_seed(3)
    tiles = build.SWEEP_TILES
    rows = []
    for site, kind, shape, col, _ in MAIN_SHAPES:
        a, b = operands(torch, gen, kind, shape, torch.bfloat16, col)
        fn = gemm_fn(kind)
        times = {t: time_ms(torch, lambda t=t: fn(a, b, tiles=t))
                 for t in tiles}
        picked = runtime.hopper_tiles(gemm_plan(kind, shape, torch.bfloat16),
                                      b_col_major=col).tile
        best = min(times, key=times.get)
        m, k = a.shape[-2:]
        bk = runtime.skinny_bk(torch.bfloat16)
        stages = -(-k // bk)
        splits = {}
        for split in range(1, min(8, stages) + 1):
            kblk = -(-stages // split) * bk
            tile = runtime.SkinnyTile(split=-(-k // kblk), kblk=kblk)
            if tile.split == split:
                splits[split] = device_ms(
                    torch, lambda t=tile: fn(a, b, tiles=t), "skinny_kernel")
        chosen = runtime.gemm_tile(a, b, picked)
        rows.append(dict(site=site, kind=kind, shape=shape, picked=picked,
                         best=best, times={str(t): ms
                                           for t, ms in times.items()},
                         skinny=str(chosen), splits=splits))
        print(f"sweep {kind}{shape} [{site}]: tiled picked {picked} "
              f"{times[picked]:.4f} ms, fastest {best} {times[best]:.4f} ms "
              f"(events); skinny {describe(chosen, kind, shape)}, device ms by "
              f"split {({s: round(v, 4) if v else v for s, v in splits.items()})}",
              flush=True)
        del a, b
    return rows


# ---------------------------------------------------------------------------
# FIR, conv2d and fft2d
# ---------------------------------------------------------------------------

def sp_operands(torch, gen, name, args, dtype):
    """FIR (x [n + t - 1], h [t]) or conv2d (img [h+p-1, w+q-1],
    filt [p, q]) operands for the recurrence extents ``args``."""
    if name == "fir":
        n, t = args
        shapes = ((n + t - 1,), (t,))
    else:
        h, w, p, q = args
        shapes = ((h + p - 1, w + q - 1), (p, q))
    return [draw(torch, gen, s, dtype) for s in shapes]


def sp_kernel(name, args, dtype):
    """The FIR or conv2d wrapper at the tile the runtime picks from the
    planner's plan for this shape: (call, plain version, HopperTiles)."""
    from repro_torch.kernels import conv2d, fir, planned, ref, runtime

    plan = planned.plan_for(name, args, planned.dtype_name(dtype))
    if plan is None:
        fail(f"no feasible plan for {name}{args} {dtype}")
    if name == "fir":
        tiles = runtime.fir_tile(plan, args[0])
        return (lambda a, b: fir.fir(a, b, tiles=tiles.tile)), ref.fir, tiles
    tiles = runtime.conv2d_tile(plan, args[0], args[1])
    return ((lambda a, b: conv2d.conv2d(a, b, tiles=tiles.tile)),
            ref.conv2d, tiles)


def fft_kernel(shape=FFT_MAIN):
    """The fft2d wrapper on the form the runtime routes an fft2d_stage
    plan of ``shape`` to (the fused kernel up to 64 rows), and the
    composition over the GEMMs on the plan's tiled tile: (fused call,
    composition call, the routed tile)."""
    import torch

    from repro_torch.kernels import fft2d, planned, registry, runtime

    plan = planned.plan_for("fft2d_stage", shape, "float32")
    if plan is None:
        fail(f"no feasible plan for fft2d_stage{shape}")
    x = torch.empty(shape, device="cuda")
    tile = registry.get("fft2d_stage").tiles(plan, x, x).tile
    tiled = runtime.hopper_tiles(plan).tile
    return ((lambda re_, im_: fft2d.fft2d(re_, im_, tiles=tile)),
            (lambda re_, im_: fft2d.fft2d(re_, im_, tiles=tiled)), tile)


def sp_parity(torch) -> None:
    """FIR and conv2d against their plain versions in every dtype they
    take, at the frontend and ragged shapes, with every compiled tile
    (the picked one among them); the fused fft2d kernel at ``FFT_SHAPES``
    and the composition at the frontend tile against ``ref.fft2d``."""
    from repro_torch.kernels import build, conv2d, fir, ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    dtypes = (torch.float32, torch.int8, torch.int16, torch.int32)
    n = 0
    for name, fn, plain, tiles in (
            ("fir", fir.fir, ref.fir, [(t,) for t in build.FIR_TILES]),
            ("conv2d", conv2d.conv2d, ref.conv2d, build.CONV2D_TILES)):
        for args in (SP_MAIN[name], *SP_RAGGED[name]):
            for dtype in dtypes:
                a, b = sp_operands(torch, gen, name, args, dtype)
                want = plain(a, b)
                picked = sp_kernel(name, args, dtype)[2].tile
                if picked not in tiles:
                    fail(f"{name}{args}: picked tile {picked} not compiled")
                for tile in tiles:
                    out = fn(a, b, tiles=tile)
                    torch.cuda.synchronize()
                    err, ok = max_error(torch, out, want, dtype)
                    if not ok:
                        fail(f"{name}{args} {dtype} tile {tile}: max |err| "
                             f"{err}")
                    n += 1
    from repro_torch.kernels import runtime

    worst = 0.0
    for shape in FFT_SHAPES:
        fused, composition, tile = fft_kernel(shape)
        if not isinstance(tile, runtime.Fft2dTile):
            fail(f"fft2d{shape} routed to the composition ({tile})")
        re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(2))
        want = ref.fft2d(re_, im_)
        calls = [("fused", fused)]
        if shape == FFT_MAIN:
            calls.append(("composition", composition))
        for form, call in calls:
            got = call(re_, im_)
            torch.cuda.synchronize()
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            if err > 1.0:
                fail(f"fft2d{shape} {form}: max |err| {err} > 1.0")
            if form == "fused":
                worst = max(worst, err)
                again = call(re_, im_)
                if not all(torch.equal(g, a) for g, a in zip(got, again)):
                    fail(f"fft2d{shape} fused {tile}: two runs differ")
            n += 1
    print(f"kernels: FIR/conv2d/fft2d parity ok in {n} cases (FIR and "
          f"conv2d: 4 dtypes x frontend and ragged shapes x every compiled "
          f"tile; integers bit-exact, fp32 <= 1e-3; fft2d: the fused kernel "
          f"at {list(FFT_SHAPES)} and the composition at {FFT_MAIN}, <= "
          f"1.0, the fused kernel's max |err| {worst:.4g}, two runs "
          f"bitwise equal)", flush=True)


def sp_bound_ms(name, args, in_bytes, out_bytes):
    """Least time for one FIR or conv2d call (see ``least_ms``)."""
    if name == "fir":
        n, t = args
        moved = (n + 2 * t - 1) * in_bytes + n * out_bytes
        ops = 2 * n * t
    else:
        h, w, p, q = args
        moved = ((h + p - 1) * (w + q - 1) + p * q) * in_bytes \
            + h * w * out_bytes
        ops = 2 * h * w * p * q
    return least_ms(moved, ops, "float32")


def sp_timings(torch) -> dict:
    """FIR and conv2d at the main-path shape and dtype (the whisper-base
    frontend, int16) and at the registry's bench shape (float32), and
    fft2d at the frontend tile and the pipeline's smoke grid (the fused
    kernel, with the composition's device time beside it): kernel, plain
    version, one PyTorch call and bound.  The library call takes float32
    copies of integer inputs (``F.conv1d``/``F.conv2d`` take no integers
    on the card), with TF32 off."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, conv2d, fir, ref, widesa_mm

    gen = torch.Generator(device="cuda").manual_seed(5)
    kernel_fn = {"fir": fir.fir, "conv2d": conv2d.conv2d}
    compiled = {"fir": [(t,) for t in build.FIR_TILES],
                "conv2d": list(build.CONV2D_TILES)}
    library = {
        "fir": lambda a, b: F.conv1d(a[None, None], b[None, None]),
        "conv2d": lambda a, b: F.conv2d(a[None, None], b[None, None]),
    }
    rows = {}
    for name in ("fir", "conv2d"):
        for where, args, dtype, reps in (
                ("main", SP_MAIN[name], torch.int16, 50),
                ("bench", SP_BENCH[name], torch.float32, 10)):
            a, b = sp_operands(torch, gen, name, args, dtype)
            fn, plain, tiles = sp_kernel(name, args, dtype)
            af, bf = a.float(), b.float()
            out, want = fn(a, b), plain(a, b)
            err, _ = max_error(torch, out, want, dtype)
            row = dict(
                tiles=tiles, max_abs_err=err,
                ms=time_ms(torch, lambda: fn(a, b), reps),
                plain_ms=time_ms(torch, lambda: plain(a, b), reps),
                library_ms=time_ms(torch, lambda: library[name](af, bf),
                                   reps),
            )
            row["bound_ms"], row["bound_by"] = sp_bound_ms(
                name, args, a.element_size(), out.element_size())
            rows[(name, where)] = row
            lib = f"F.{name if name == 'conv2d' else 'conv1d'}"
            per_tile = ", ".join(
                f"{t} {fmt_ms(device_ms(torch, lambda t=t: kernel_fn[name](a, b, tiles=t), name + '_kernel'))}"
                for t in compiled[name])
            print(f"time {name}{args} {str(dtype).removeprefix('torch.')} "
                  f"[{where}] plan block {tiles.plan} -> tile {tiles.tile}: "
                  f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
                  f"ms, {lib} {row['library_ms']:.4f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); device "
                  f"time (profiler): kernel "
                  f"{fmt_ms(device_ms(torch, lambda: fn(a, b), name + '_kernel'))}"
                  f", {lib} "
                  f"{fmt_ms(device_ms(torch, lambda: library[name](af, bf)))}"
                  f"; kernel device time by compiled tile: {per_tile}",
                  flush=True)
            del a, b, af, bf, out, want
    def fft_lib(x_re, x_im):
        return torch.fft.fft2(torch.complex(x_re, x_im))

    for shape in (FFT_MAIN, FFT_PIPELINE):
        fused, composition, tile = fft_kernel(shape)
        re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(2))
        before = dict(widesa_mm.variants)
        composition(re_, im_)
        routes = {v: widesa_mm.variants[v] - before[v] for v in before}
        got, want = fused(re_, im_), ref.fft2d(re_, im_)
        r, c = shape
        n = r * c
        row = dict(
            tiles=tile,
            max_abs_err=max((g - w).abs().max().item()
                            for g, w in zip(got, want)),
            ms=time_ms(torch, lambda: fused(re_, im_)),
            plain_ms=time_ms(torch, lambda: ref.fft2d(re_, im_)),
            library_ms=time_ms(torch, lambda: fft_lib(re_, im_)),
            device_ms=device_ms(torch, lambda: fused(re_, im_),
                                "fft2d_kernel", 20),
            composition_device_ms=device_ms(
                torch, lambda: composition(re_, im_)),
            library_device_ms=device_ms(torch, lambda: fft_lib(re_, im_),
                                        None, 20),
        )
        # the function's least work: two float32 planes in and two out,
        # and an FFT's 5 N log2 N operations over the N = r * c points
        row["bound_ms"], row["bound_by"] = least_ms(
            4 * n * 4, 5 * n * math.log2(n), "float32")
        # the DFT form's (the kernel's design target): F_R's and F_C's
        # planes read once besides X and Z, and its 3 (r c^2 + r^2 c)
        # multiply-adds on the CUDA cores
        row["dft_bound_ms"], _ = least_ms(
            (2 * c * c + 2 * r * r + 4 * n) * 4,
            2 * 3 * (r * c * c + r * r * c), "float32")
        if shape == FFT_MAIN:
            rows[("fft2d", "main")] = row
        print(f"time fft2d{shape} float32 [fused kernel, {tile}]: "
              f"{row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])}), "
              f"the composition (6 mm launches by kernel {routes} and its "
              f"elementwise kernels) device "
              f"{fmt_ms(row['composition_device_ms'])}, torch.fft.fft2 "
              f"{row['library_ms']:.4f} ms (device "
              f"{fmt_ms(row['library_device_ms'])}), plain (torch.fft.fft2) "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.7f} ms "
              f"({row['bound_by']}, FFT form) and {row['dft_bound_ms']:.5f} "
              f"ms (bytes, the DFT form); max |err| {row['max_abs_err']:.4g}",
              flush=True)
        del re_, im_, got, want
    return rows


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def serve(torch, device_name: str) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import planned
    from repro_torch.serve import make_engine

    cfg = get_config(ARCH)
    eng = make_engine(cfg, kind="slot", max_slots=SLOTS, max_seq=MAX_SEQ,
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = eng.api.init(gen)
    eng.load(params)
    torch.cuda.synchronize()
    print(f"serve: {ARCH} at full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}) loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 17)))
               for _ in range(REQUESTS)]
    for p in prompts:
        eng.submit_text(p, max_new_tokens=MAX_NEW)

    # the main path: counts start at 0 here and are read right after
    planned.planned_report_clear()
    reset_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    variants = read_variants()
    report = planned.planned_report()

    if len(done) != REQUESTS or any(len(r.output) != MAX_NEW for r in done):
        fail(f"requests did not finish with their budget: "
             f"{[(r.rid, len(r.output)) for r in done]}")

    bad = {s: (st["planned"], st["fallback"], st["reasons"])
           for s, st in report.items()
           if st["planned"] == 0 or st["fallback"] != 0}
    if bad or not report:
        fail(f"planned sites that fell back or never planned: {bad}")
    if min(launches["widesa_mm"], launches["bmm"]) == 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    tokens = sum(len(r.output) for r in done)
    routes = check_routes("serve", report, variants)
    print(f"serve: {len(done)} requests / {tokens} tokens in {dt:.3f} s = "
          f"{tokens / dt:.1f} tok/s on {device_name}; launches {launches}; "
          f"GEMM launches by kernel {variants} ({routes}); {len(report)} "
          f"sites all planned: {sorted(report)}", flush=True)
    drain_parity(torch, report, "serve")

    # prefill logits through the kernels vs an explicit plain-version run
    worst = scale = 0.0
    by_rid = {r.rid: r for r in done}
    with torch.no_grad():
        for rid, p in enumerate(prompts):
            tokens = torch.as_tensor(p[None], device="cuda")
            logits, _ = eng.api.prefill(params, {"tokens": tokens}, MAX_SEQ)
            with planned.override(enabled=False):
                want, _ = eng.api.prefill(params, {"tokens": tokens},
                                          MAX_SEQ)
            if logits.shape != (1, cfg.vocab) or not torch.isfinite(
                    logits).all():
                fail(f"request {rid}: bad prefill logits {logits.shape}")
            err = (logits.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            scale = max(scale, want.float().abs().max().item())
            if err > LOGIT_ATOL:
                fail(f"request {rid}: prefill logits differ by {err} > "
                     f"{LOGIT_ATOL} from the plain versions")
            if by_rid[rid].output[0] != int(torch.argmax(logits[0])):
                fail(f"request {rid}: engine's first token is not the "
                     "argmax of its prefill logits")
    print(f"serve: prefill logits of {len(prompts)} prompts match the "
          f"plain versions, max |diff| {worst:.4f} <= {LOGIT_ATOL} (max "
          f"|logit| {scale:.3f})", flush=True)
    profile_decode(torch, eng)
    return launches, variants


#: device time of the hand GEMM kernels in one 4-lane qwen decode step
#: when all of them ran on the tiled kernel (NVIDIA H100 80GB HBM3,
#: 700 W; PERF.md), printed beside the step's time by kernel
TILED_STEP_GEMM_MS = 22.82


def profile_decode(torch, eng) -> None:
    """Host time of one 4-lane decode step, and the card's busy time in it
    by kernel (``torch.profiler``; device events only): the skinny and the
    tiled GEMM kernels apart, and everything else."""
    from torch.profiler import ProfilerActivity, profile

    cache = eng.api.init_cache(SLOTS, MAX_SEQ)
    tokens = torch.zeros((SLOTS, 1), dtype=torch.int32, device="cuda")

    def step():
        with torch.no_grad():
            eng.api.decode(eng.params, cache, tokens)
        torch.cuda.synchronize()

    step()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    per_step = f"GEMM launches by kernel {read_variants()}"
    ms = device_by_kernel(prof)
    wall = sorted(walls)[len(walls) // 2]
    busy = sum(ms.values())
    if busy == 0:
        print(f"profile: decode step {wall:.2f} ms on the host clock "
              f"(median of 5), {per_step}; device busy time not measured "
              "(the profiler recorded no device events)", flush=True)
        return
    hand = sum(ms[k] for k in GEMM_KERNELS)
    print(f"profile: decode step {wall:.2f} ms on the host clock (median "
          f"of 5), {per_step}; device busy {busy:.2f} ms in the traced "
          f"step: hand GEMM kernels {hand:.3f} ms (skinny "
          f"{ms['skinny']:.3f} ms, wgmma {ms['wgmma']:.3f} ms, tiled "
          f"{ms['tiled']:.3f} ms; {TILED_STEP_GEMM_MS} ms when all ran "
          f"tiled), other kernels {ms['other']:.2f} ms; device idle "
          f"{max(0.0, 1 - busy / wall):.0%} of the step", flush=True)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

#: the profiler's name of each GEMM kernel (``variants`` keys)
GEMM_KERNELS = {"skinny": "skinny_kernel", "wgmma": "gemm_tc_kernel",
                "tiled": "gemm_kernel"}


def device_by_kernel(prof) -> dict:
    """Device time (ms) of a ``torch.profiler`` trace by GEMM kernel, and
    of everything else under ``other``."""
    us = dict.fromkeys([*GEMM_KERNELS, "other"], 0.0)
    for evt in prof.key_averages():
        name = next((v for v, k in GEMM_KERNELS.items() if k in evt.key),
                    "other")
        us[name] += getattr(evt, "self_device_time_total", 0.0)
    return {k: v / 1e3 for k, v in us.items()}


def prefill_phase(torch, device_name: str) -> tuple[dict, dict]:
    """Full-width qwen1.5-0.5b on the slot engine (4 slots, max_seq
    ``PREFILL_MAX_SEQ``) serving prompts of ``PREFILL_PROMPTS`` tokens, 8
    new tokens each: every prefill GEMM above 16 rows on the tensor-core
    kernel (``check_routes``), then the drain's GEMM shapes against the
    plain versions, each prompt's prefill logits against the plain
    versions, and one prefill of the longest prompt timed and traced."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import planned
    from repro_torch.serve import make_engine

    cfg = get_config(ARCH)
    eng = make_engine(cfg, kind="slot", max_slots=SLOTS,
                      max_seq=PREFILL_MAX_SEQ, device="cuda")
    params = eng.api.init(torch.Generator(device="cuda").manual_seed(0))
    eng.load(params)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, p) for p in PREFILL_PROMPTS]
    for p in prompts:
        eng.submit_text(p, max_new_tokens=MAX_NEW)

    # the prefill path: counts start at 0 here and are read right after
    planned.planned_report_clear()
    reset_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    variants = read_variants()
    report = planned.planned_report()

    if len(done) != len(prompts) or any(len(r.output) != MAX_NEW
                                        for r in done):
        fail(f"prefill requests did not finish with their budget: "
             f"{[(r.rid, len(r.output)) for r in done]}")
    bad = {s: (st["planned"], st["fallback"], st["reasons"])
           for s, st in report.items()
           if st["planned"] == 0 or st["fallback"] != 0}
    if bad or not report:
        fail(f"prefill sites that fell back or never planned: {bad}")
    if min(variants["widesa_mm"]["wgmma"], variants["bmm"]["wgmma"]) == 0:
        fail(f"the tensor-core kernel was not launched on the prefill path: "
             f"{variants}")
    routes = check_routes("prefill", report, variants)
    tokens = sum(len(r.output) for r in done)
    print(f"prefill: {ARCH} full width, prompts of {PREFILL_PROMPTS} tokens "
          f"(max_seq {PREFILL_MAX_SEQ}): {len(done)} requests / {tokens} "
          f"tokens in {dt:.3f} s on {device_name}; launches {launches}; GEMM "
          f"launches by kernel {variants} ({routes}); {len(report)} sites all "
          f"planned", flush=True)
    drain_parity(torch, report, "prefill")

    worst = 0.0
    by_rid = {r.rid: r for r in done}
    with torch.no_grad():
        for rid, p in enumerate(prompts):
            tok = torch.as_tensor(p[None], device="cuda")
            logits, _ = eng.api.prefill(params, {"tokens": tok},
                                        PREFILL_MAX_SEQ)
            with planned.override(enabled=False):
                want, _ = eng.api.prefill(params, {"tokens": tok},
                                          PREFILL_MAX_SEQ)
            if logits.shape != (1, cfg.vocab) or not torch.isfinite(
                    logits).all():
                fail(f"prefill request {rid}: bad logits {logits.shape}")
            err = (logits.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            if err > LOGIT_ATOL:
                fail(f"prefill request {rid} ({len(p)} tokens): logits differ "
                     f"by {err} > {LOGIT_ATOL} from the plain versions")
            if by_rid[rid].output[0] != int(torch.argmax(logits[0])):
                fail(f"prefill request {rid}: engine's first token is not the "
                     "argmax of its prefill logits")
    print(f"prefill: logits of the {len(prompts)} prompts match the plain "
          f"versions, max |diff| {worst:.4f} <= {LOGIT_ATOL}; first tokens "
          f"match", flush=True)
    profile_prefill(torch, eng, prompts[-1])
    return launches, variants


def profile_prefill(torch, eng, prompt) -> None:
    """Host time of one prefill of ``prompt`` (median of 5), and the card's
    busy time in it by GEMM kernel (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    tok = torch.as_tensor(prompt[None], device="cuda")

    def run():
        with torch.no_grad():
            eng.api.prefill(eng.params, {"tokens": tok}, PREFILL_MAX_SEQ)
        torch.cuda.synchronize()

    run()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    wall = sorted(walls)[len(walls) // 2]
    ms = device_by_kernel(prof)
    busy = sum(ms.values())
    gemm = ", ".join(f"{k} {ms[k]:.3f} ms" for k in GEMM_KERNELS)
    print(f"profile: prefill of {len(prompt)} tokens {wall:.2f} ms on the "
          f"host clock (median of 5), GEMM launches by kernel "
          f"{read_variants()}; device busy {busy:.3f} ms in the traced "
          f"prefill: GEMM kernels {gemm}, other kernels {ms['other']:.3f} ms; "
          f"device idle {max(0.0, 1 - busy / wall):.0%} of the prefill"
          if busy else
          f"profile: prefill of {len(prompt)} tokens {wall:.2f} ms on the "
          f"host clock (median of 5); device busy time not measured (the "
          f"profiler recorded no device events)", flush=True)


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

def stream_serve(torch, device_name: str) -> dict:
    """Phase 5: whisper-base serving streamed audio (module docstring)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import planned, runtime
    from repro_torch.models import encdec
    from repro_torch.models.transformer import cache_dtype_of
    from repro_torch.serve import make_engine, synth_samples

    cfg = get_config(STREAM_ARCH)
    eng = make_engine(cfg, kind="slot", max_slots=SLOTS, max_seq=MAX_SEQ,
                      device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = eng.api.init(gen)
    eng.load(params)
    torch.cuda.synchronize()
    fc = eng.frontend.cfg
    print(f"stream: {STREAM_ARCH} at full width ({cfg.n_enc_layers}+"
          f"{cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
          f"{cfg.dtype}) loaded in {time.perf_counter() - t0:.1f} s; "
          f"frontend {fc.dtype} chunks of {fc.chunk_samples} samples "
          f"({fc.rows}x{fc.cols} tile) -> {fc.frames_per_chunk} frames",
          flush=True)

    streams = [synth_samples(fc, 1 + i % 8, seed=i) for i in range(REQUESTS)]
    for samples in streams:
        eng.submit_audio_stream(samples, max_new_tokens=MAX_NEW)

    # the streaming path: counts start at 0 here and are read right after
    planned.planned_report_clear()
    reset_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    variants = read_variants()
    report = planned.planned_report()

    if len(done) != REQUESTS or any(len(r.output) != MAX_NEW for r in done):
        fail(f"stream requests did not finish with their budget: "
             f"{[(r.rid, len(r.output)) for r in done]}")
    routes = check_routes("stream", report, variants)
    if any(r.fed != len(r.chunks) for r in done):
        fail(f"chunks left unfed: {[(r.rid, r.fed, len(r.chunks)) for r in done]}")
    bad = {s: (st["planned"], st["fallback"], st["reasons"])
           for s, st in report.items()
           if st["planned"] == 0 or st["fallback"] != 0}
    if bad or not report:
        fail(f"stream sites that fell back or never planned: {bad}")
    stamps = {"frontend.fir": "pallas", "frontend.conv2d": "pallas",
              "frontend.fft2d": "xla", "mlp.pair": "xla"}
    for site, backend in stamps.items():
        if site not in report or set(report[site]["backends"]) != {backend}:
            fail(f"{site} did not run its {backend} plan: "
                 f"{report.get(site)}")
    chunks = sum(r.fed for r in done)
    if min(launches[k] for k in ("widesa_mm", "bmm", "fir", "conv2d")) == 0:
        fail(f"a kernel was not launched on the streaming path: {launches}")
    if launches["fir"] != chunks or launches["conv2d"] != chunks:
        fail(f"{chunks} chunks fed but fir/conv2d launched "
             f"{launches['fir']}/{launches['conv2d']} times")
    tokens = sum(len(r.output) for r in done)
    tiles = {k: (t.plan, t.tile) for k, t in runtime.last_tiles.items()
             if k in ("fir", "conv2d")}
    print(f"stream: {len(done)} requests / {tokens} tokens / {chunks} audio "
          f"chunks in {dt:.3f} s = {tokens / dt:.1f} tok/s on {device_name}; "
          f"launches {launches} (fir and conv2d: one each per chunk), GEMM "
          f"launches by kernel {variants} ({routes}); plan "
          f"block -> compiled tile {tiles}; {len(report)} sites all planned: "
          f"{sorted(report)}", flush=True)
    drain_parity(torch, report, "stream")

    # one request's features and stream-prefill logits through the
    # kernels vs an explicit run through the plain versions
    rid = REQUESTS - 1
    req = {r.rid: r for r in done}[rid]
    samples, c = streams[rid], fc.frames_per_chunk
    tokens = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    cache_dtype = cache_dtype_of(cfg)

    def prefill(feats):
        return encdec.prefill_streaming(params, cfg, feats[None], tokens,
                                        MAX_SEQ, c, cache_dtype)[0]

    with torch.no_grad():
        feats = eng.frontend.offline_features(samples)
        logits = prefill(feats)
        first = prefill(feats[:c])
        with planned.override(enabled=False):
            want_feats = eng.frontend.offline_features(samples)
            want = prefill(want_feats)
    if not torch.equal(feats, want_feats):
        fail(f"request {rid}: frontend features differ from the plain "
             f"versions by {(feats - want_feats).abs().max().item()}")
    if logits.shape != (1, cfg.vocab) or not torch.isfinite(logits).all():
        fail(f"request {rid}: bad stream-prefill logits {logits.shape}")
    err = (logits.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if err > LOGIT_ATOL:
        fail(f"request {rid}: stream-prefill logits differ by {err} > "
             f"{LOGIT_ATOL} from the plain versions")
    if req.output[0] != int(torch.argmax(first[0])):
        fail(f"request {rid}: engine's first token is not the argmax of the "
             "stream prefill over its first chunk")
    print(f"stream: request {rid} ({len(req.chunks)} chunks): features "
          f"{tuple(feats.shape)} equal the plain versions bitwise (int16 "
          f"frontend); stream-prefill logits max |diff| {err:.4f} <= "
          f"{LOGIT_ATOL} (max |logit| {scale:.3f}); first token matches",
          flush=True)
    return launches, variants


# ---------------------------------------------------------------------------
# recurrences: the mapper -> kernel pipeline, B6 and B7
# ---------------------------------------------------------------------------

#: B6 and B7 at the registry's bench sizes and at ragged ones (outputs not
#: multiples of any compiled tile), as builder arguments
HPC_BENCH = {"jacobi2d": (10238, 10238), "jacobi2d_9pt": (10236, 10236),
             "jacobi2d_ms": (4094, 4094, 8), "mttkrp": (4096, 400, 256, 256)}
HPC_RAGGED = {"jacobi2d": (61, 59), "jacobi2d_9pt": (61, 59),
              "jacobi2d_ms": (61, 59, 3), "mttkrp": (37, 45, 7, 5)}
#: the shapes and dtypes timed, the first of each kernel its kernels-line row
HPC_TIMED = (("jacobi2d", "float32"), ("jacobi2d", "int8"),
             ("jacobi2d_9pt", "float32"), ("jacobi2d_ms", "float32"),
             ("mttkrp", "float32"), ("mttkrp", "int8"), ("mttkrp", "int16"),
             ("mttkrp", "int32"))
#: int8 products a product of the tensor-core MTTKRP: the limb pairs p,
#: q with p + q < 4
LIMB_PRODUCTS = {"int8": 1, "int16": 4, "int32": 10}
#: the profiler's name of each MTTKRP kernel (``mttkrp.variants`` keys)
MTTKRP_KERNELS = {"tensor_core": "mttkrp_tc_kernel",
                  "cuda_core": "mttkrp_kernel"}


def mttkrp_variant(tile) -> str:
    """The MTTKRP kernel a tile launches (a key of ``mttkrp.variants``)."""
    from repro_torch.kernels import runtime

    return "tensor_core" if isinstance(tile, runtime.MttkrpTile) \
        else "cuda_core"


def mttkrp_expected(args, dtype) -> str:
    """The kernel MTTKRP must run on at ``args`` in ``dtype``: the tensor
    cores where the rows of X and B allow 4-byte copies (every float32 and
    int32 shape; int8 with J and L multiples of 4; int16 with J and L
    even) and C's tile fits in shared memory, else the CUDA cores."""
    import torch

    from repro_torch.kernels import runtime

    nj, nl = args[1], args[3]
    unit = {"float32": 1, "int32": 1, "int16": 2, "int8": 4}[dtype]
    fits = runtime.mttkrp_smem(nl, getattr(torch, dtype)) \
        <= runtime.MTTKRP_TC_MAX_SMEM
    return "tensor_core" if fits and nj % unit == 0 and nl % unit == 0 \
        else "cuda_core"


def hpc_call(name, args, dtype):
    """The B6 / B7 wrapper at the tile the runtime maps the single-chip
    plan onto: (call, spec, recurrence, HopperTiles)."""
    from repro_torch.core import Target, best_plan
    from repro_torch.kernels import jacobi2d, mttkrp, registry

    spec = registry.get(name)
    rec = spec.builder(*args, dtype)
    plan = best_plan(rec, Target(name="single_chip", mesh_shape=(1, 1)))
    fn = mttkrp.mttkrp if name == "mttkrp" else getattr(jacobi2d, name)
    return fn, spec, rec, plan


def hpc_parity(torch) -> None:
    """B6 and B7 against their plain versions at the bench and ragged
    sizes, in every dtype they take (the multi-sweep form on its int32
    state too), at the compiled tile the runtime maps the plan onto; then
    a TF32 control, which ``recurrences.compare`` must reject."""
    from repro_torch.kernels import build, registry
    from repro_torch.launch import recurrences

    gen = torch.Generator(device="cuda").manual_seed(7)
    n, worst, routes = 0, {}, {}
    for name in HPC_BENCH:
        for args in (HPC_RAGGED[name], HPC_BENCH[name]):
            for dtype in ("float32", "int8", "int16", "int32"):
                fn, spec, rec, plan = hpc_call(name, args, dtype)
                ops = registry.operands(rec, gen, "cuda")
                tile = spec.tiles(plan, *ops).tile
                if name == "mttkrp":
                    kernel = mttkrp_variant(tile)
                    if kernel != mttkrp_expected(args, dtype):
                        fail(f"mttkrp{args} {dtype}: routed to {kernel} "
                             f"({tile})")
                    routes[(args, dtype)] = kernel
                elif tile != build.STENCIL_TILE:
                    fail(f"{name}{args}: tile {tile} is not the compiled "
                         f"{build.STENCIL_TILE}")
                want = spec.ref(*ops)
                out = fn(*ops, tiles=tile)
                torch.cuda.synchronize()
                err, ok = recurrences.compare(spec, rec, ops, out, want)
                if not ok:
                    fail(f"{name}{args} {dtype}: max |err| {err} outside "
                         "tolerance")
                worst[(name, dtype)] = max(worst.get((name, dtype), 0.0),
                                           err)
                n += 1
                del ops, want, out
                torch.cuda.empty_cache()
    floats = {k[0]: f"{v:.4g}" for k, v in worst.items() if k[1] == "float32"}
    routed = {f"{args} {dtype}": kernel
              for (args, dtype), kernel in routes.items()}
    print(f"recurrences: B6/B7 parity ok in {n} cases (4 specs x bench and "
          f"ragged sizes x 4 dtypes; integers bit-exact; float32 max |err| "
          f"{floats} within recurrences.float_bound); mttkrp kernels "
          f"{routed}", flush=True)
    tf32_control(torch, gen)


def tf32_control(torch, gen) -> None:
    """The float32 bound must catch a precision loss at MTTKRP's bench
    size: the plain version with TF32 GEMMs (10-bit significands) held
    against the fp32 plain version fails ``recurrences.compare``."""
    from repro_torch.kernels import registry
    from repro_torch.launch import recurrences

    _, spec, rec, _ = hpc_call("mttkrp", HPC_BENCH["mttkrp"], "float32")
    ops = registry.operands(rec, gen, "cuda")
    want = spec.ref(*ops)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = spec.ref(*ops)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err, ok = recurrences.compare(spec, rec, ops, control, want)
    bound = recurrences.float_bound(spec, rec, ops)
    print(f"recurrences: TF32 control of mttkrp{HPC_BENCH['mttkrp']} "
          f"float32: max |err| {err:.4g} against float_bound "
          f"{bound.min().item():.4g}-{bound.max().item():.4g} "
          f"({'ok' if ok else 'not ok'}: the bound "
          f"{'MISSES' if ok else 'catches'} a TF32 rounding)", flush=True)
    if ok:
        fail("recurrences.float_bound accepts the TF32 control")
    del ops, want, control, bound
    torch.cuda.empty_cache()


def hpc_bound_ms(name, rec, in_bytes, out_bytes, rate="float32",
                 passes=1):
    """Least time for one call (``least_ms``): each operand read once and
    the result written once, or the folded operations at the peak rate
    of ``rate`` (the fp32 CUDA-core rate unless asked otherwise), each
    done ``passes`` times (3 for 3xTF32).  For jacobi2d_ms that is the
    whole function (grid in, result out, 2 S T operations an output);
    mttkrp counts 2 I J K L operations (one multiply-add per (i, j, k, l)
    once B C is folded), not the IR's ops_per_point = 3."""
    e = {loop: rec.extent(loop) for loop in rec.loops}
    if name == "mttkrp":
        moved = (e["i"] * e["k"] * e["l"] + (e["k"] + e["l"]) * e["j"]) \
            * in_bytes + e["i"] * e["j"] * out_bytes
        ops = 2 * e["i"] * e["j"] * e["k"] * e["l"] * passes
        return least_ms(moved, ops, rate)
    pad = 4 if name == "jacobi2d_9pt" else 2
    sweeps = e.get("t", 1)
    moved = ((e["i"] + pad) * (e["j"] + pad) + sweeps * e["s"]) * in_bytes \
        + e["i"] * e["j"] * out_bytes
    return least_ms(moved, 2 * e["s"] * sweeps * e["i"] * e["j"], rate)


def hpc_library(torch, name, ops):
    """One PyTorch call computing the same function on float32 copies, TF32
    off (yardstick only), or None: ``F.conv2d`` with the star as a
    zero-padded (2r+1)^2 filter, ``torch.einsum`` for mttkrp; the
    multi-sweep stencil has no one call."""
    import torch.nn.functional as F

    from repro_torch.core.recurrence import (JACOBI2D_9PT_OFFSETS,
                                             JACOBI2D_OFFSETS)

    if name == "mttkrp":
        x, b, c = (o.float() for o in ops)
        return lambda: torch.einsum("ikl,kj,lj->ij", x, b, c)
    if name == "jacobi2d_ms":
        return None
    offsets = JACOBI2D_9PT_OFFSETS if name == "jacobi2d_9pt" \
        else JACOBI2D_OFFSETS
    size = max(max(pt) for pt in offsets) + 1
    grid, weights = ops[0].float()[None, None], ops[1].float()
    filt = torch.zeros((1, 1, size, size), device="cuda")
    for s, (di, dj) in enumerate(offsets):
        filt[0, 0, di, dj] = weights[s]
    return lambda: F.conv2d(grid, filt)


def hpc_timings(torch) -> dict:
    """B6 and B7 at the bench sizes (``HPC_TIMED``): kernel (CUDA events
    and ``torch.profiler`` device time), plain version, library call and
    bound.  MTTKRP rows on the tensor cores also give the CUDA-core
    kernel's device time on the same operands, and their bound at the
    tensor-core rate (3xTF32: three TF32 products a product; int16 and
    int32: 4 and 10 int8 limb products) beside the fp32 CUDA-core one."""
    from repro_torch.kernels import build, registry

    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = {}
    for name, dtype in HPC_TIMED:
        fn, spec, rec, plan = hpc_call(name, HPC_BENCH[name], dtype)
        ops = registry.operands(rec, gen, "cuda")
        tiles = spec.tiles(plan, *ops)
        reps = 5 if name == "mttkrp" else 10
        out = fn(*ops, tiles=tiles.tile)
        want = spec.ref(*ops)
        err = (out.double() - want.double()).abs().max().item()
        lib = hpc_library(torch, name, ops)
        kname = MTTKRP_KERNELS[mttkrp_variant(tiles.tile)] \
            if name == "mttkrp" else "star_kernel"
        per_call = rec.extent("t") if name == "jacobi2d_ms" else 1
        row = dict(
            tiles=tiles, max_abs_err=err,
            ms=time_ms(torch, lambda: fn(*ops, tiles=tiles.tile), reps, 2),
            plain_ms=time_ms(torch, lambda: spec.ref(*ops), reps, 2),
            library_ms=None if lib is None else time_ms(torch, lib, reps, 2),
            device_ms=device_ms(torch, lambda: fn(*ops, tiles=tiles.tile),
                                kname, reps, per_call),
            library_device_ms=None if lib is None
            else device_ms(torch, lib, None, reps),
        )
        row["bound_ms"], row["bound_by"] = hpc_bound_ms(
            name, rec, ops[0].element_size(), out.element_size())
        rate = ", fp32 CUDA-core rate" \
            if row["bound_by"] == "operations" else ""
        extra = ""
        if name == "mttkrp" and mttkrp_variant(tiles.tile) == "tensor_core":
            row["cuda_core_device_ms"] = device_ms(
                torch, lambda: fn(*ops, tiles=build.MTTKRP_TILE),
                MTTKRP_KERNELS["cuda_core"], reps)
            # 3xTF32: three TF32 products a product; the integers one int8
            # product a pair of limbs (1, 4 and 10 in int8, int16, int32)
            tc_rate, passes = ("tfloat32", 3) if dtype == "float32" \
                else ("int8", LIMB_PRODUCTS[dtype])
            tc_ms, tc_by = hpc_bound_ms(
                name, rec, ops[0].element_size(), out.element_size(),
                rate=tc_rate, passes=passes)
            # the kernels line's bound: the tensor-core rate its work runs at
            row["cuda_core_bound_ms"] = row["bound_ms"]
            row["bound_ms"], row["bound_by"] = tc_ms, tc_by
            rate = (f", {'3xTF32' if dtype == 'float32' else 'int8'} "
                    f"tensor-core rate, {passes} product(s) a product"
                    if tc_by == "operations" else "")
            extra = (f"; fp32 CUDA-core bound "
                     f"{row['cuda_core_bound_ms']:.4f} ms; CUDA-core kernel "
                     f"device time {fmt_ms(row['cuda_core_device_ms'])}")
        rows[(name, dtype)] = row
        if name == "jacobi2d_ms":
            sweeps = rec.extent("t")
            floor = sweeps * hpc_bound_ms(
                "jacobi2d", registry.get("jacobi2d").builder(
                    rec.extent("i"), rec.extent("j"), dtype), 4, 4)[0]
            extra = (f"; {sweeps} launches a call, floor of {sweeps} "
                     f"separate passes {floor:.4f} ms")
        library = ("none (no one call)" if lib is None else
                   f"{row['library_ms']:.4f} ms (device "
                   f"{fmt_ms(row['library_device_ms'])})")
        print(f"time {name}{HPC_BENCH[name]} {dtype} plan block "
              f"{tiles.plan} -> tile {tiles.tile}: kernel {row['ms']:.4f} "
              f"ms (kernel device time {fmt_ms(row['device_ms'])}), plain "
              f"{row['plain_ms']:.4f} ms, library {library}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}{rate}){extra}; "
              f"max |err| {err:.4g}", flush=True)
        del ops, out, want, lib
        torch.cuda.empty_cache()
    return rows


#: the integer GEMMs above 16 rows the recurrence pipeline runs on the
#: tiled kernel: the registry's mm and bmm smoke shapes
INT_GEMMS = (("mm", (256, 256, 256)), ("bmm", (4, 128, 128, 64)))


def int_gemm_timings(torch) -> None:
    """The integer GEMMs of ``INT_GEMMS`` in int8, int16 and int32 on the
    kernel the runtime routes them to (the tiled kernel), held bitwise to
    the plain version: profiler device time beside the bound (the int8
    tensor-core rate for int8, the fp32 CUDA-core rate for the wider
    integers, which no tensor-core instruction takes whole), the plain
    version and, where PyTorch has one call for it on the card,
    ``torch._int_mm`` (int8 mm; none for bmm, int16 or int32)."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(13)
    for kind, shape in INT_GEMMS:
        plain = ref.mm if kind == "mm" else ref.bmm
        for dtype in (torch.int8, torch.int16, torch.int32):
            a, b = operands(torch, gen, kind, shape, dtype, False)
            call, tiles = kernel_call(kind, shape, dtype, a, b)
            kernel = describe(tiles.tile).split()[0]
            if kernel != "tiled":
                fail(f"{kind}{shape} {dtype}: routed to {kernel}")
            want = plain(a, b)
            if not torch.equal(call(a, b), want):
                fail(f"{kind}{shape} {dtype}: the tiled kernel is not "
                     "bit-exact")
            lib, lib_text = None, "none on the card"
            if kind == "mm" and dtype == torch.int8:
                # a yardstick only: a PyTorch build without it is noted
                try:
                    same = torch.equal(torch._int_mm(a, b), want)
                except RuntimeError as err:
                    same, lib_text = None, f"torch._int_mm refused ({err})"
                if same is False:
                    fail(f"{kind}{shape} int8: torch._int_mm differs")
                if same:
                    lib = device_ms(torch, lambda: torch._int_mm(a, b), None)
                    lib_text = f"torch._int_mm device {fmt_ms(lib)}"
            bound, by = bound_ms(kind, shape, a.element_size(), 4,
                                 "int8" if dtype == torch.int8
                                 else "float32")
            name = str(dtype).removeprefix("torch.")
            print(f"time {kind}{shape} {name} -> int32 [tiled {tiles.tile}, "
                  f"the recurrence pipeline]: device "
                  f"{fmt_ms(device_ms(torch, lambda: call(a, b), 'gemm_kernel'))}"
                  f", bound {bound:.5f} ms ({by}), plain "
                  f"{time_ms(torch, lambda: plain(a, b), 10):.4f} ms, library "
                  f"{lib_text}", flush=True)
            del a, b, want


def mttkrp_sweep(torch) -> list[dict]:
    """The tensor-core MTTKRP at the bench size in float32, int8, int16
    and int32 with every split of K over a cluster (1 to 8), each held to
    the plain version, beside the CUDA-core kernel and ``torch.einsum``
    (profiler device time)."""
    from repro_torch.kernels import build, mttkrp, registry, runtime
    from repro_torch.launch import recurrences

    gen = torch.Generator(device="cuda").manual_seed(9)
    args = HPC_BENCH["mttkrp"]
    rows = []
    for dtype in ("float32", "int8", "int16", "int32"):
        _, spec, rec, plan = hpc_call("mttkrp", args, dtype)
        ops = registry.operands(rec, gen, "cuda")
        want = spec.ref(*ops)
        picked = spec.tiles(plan, *ops).tile
        splits = {}
        for split in range(1, runtime.MTTKRP_TC_MAX_CLUSTER + 1):
            tile = runtime.MttkrpTile(split=split, copy=picked.copy)
            err, ok = recurrences.compare(
                spec, rec, ops, mttkrp.mttkrp(*ops, tiles=tile), want)
            if not ok:
                fail(f"mttkrp{args} {dtype} split {split}: max |err| {err}")
            splits[split] = device_ms(
                torch, lambda t=tile: mttkrp.mttkrp(*ops, tiles=t),
                MTTKRP_KERNELS["tensor_core"], 5)
        cuda_core = device_ms(
            torch, lambda: mttkrp.mttkrp(*ops, tiles=build.MTTKRP_TILE),
            MTTKRP_KERNELS["cuda_core"], 3)
        library = device_ms(torch, hpc_library(torch, "mttkrp", ops), None, 3)
        rows.append(dict(dtype=dtype, picked=str(picked), splits=splits,
                         cuda_core=cuda_core, library=library))
        print(f"sweep mttkrp{args} {dtype}: picked {picked}; tensor-core "
              f"device ms by split "
              f"{({k: round(v, 4) if v else v for k, v in splits.items()})}; "
              f"CUDA-core kernel {fmt_ms(cuda_core)}; torch.einsum "
              f"{fmt_ms(library)}", flush=True)
        del ops, want
        torch.cuda.empty_cache()
    return rows


def fft_sweep(torch) -> list[dict]:
    """The fused fft2d kernel at ``FFT_SHAPES``' frontend, wide and
    pipeline grids with every split of K it takes (1-8), each held to
    ``ref.fft2d``, beside the composition and ``torch.fft.fft2`` (profiler
    device time)."""
    from repro_torch.kernels import fft2d, ref, runtime

    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = []
    for shape in (FFT_MAIN, (16, 1024), FFT_PIPELINE):
        _, composition, picked = fft_kernel(shape)
        re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                    for _ in range(2))
        want = ref.fft2d(re_, im_)
        splits = {}
        for split in range(1, runtime.FFT2D_MAX_CLUSTER + 1):
            if not runtime.fft2d_allows(*shape, split):
                continue
            tile = runtime.Fft2dTile(split)
            got = fft2d.fft2d(re_, im_, tiles=tile)
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            if err > 1.0:
                fail(f"fft2d{shape} split {split}: max |err| {err}")
            splits[split] = device_ms(
                torch, lambda t=tile: fft2d.fft2d(re_, im_, tiles=t),
                "fft2d_kernel", 20)
        comp = device_ms(torch, lambda: composition(re_, im_))
        library = device_ms(
            torch, lambda: torch.fft.fft2(torch.complex(re_, im_)), None, 20)
        rows.append(dict(shape=shape, picked=str(picked), splits=splits,
                         composition=comp, library=library))
        print(f"sweep fft2d{shape}: picked {picked}; fused device ms by split "
              f"{ {k: round(v, 4) if v else v for k, v in splits.items()} }; "
              f"composition {fmt_ms(comp)}; torch.fft.fft2 {fmt_ms(library)}",
              flush=True)
    return rows


#: the prompt lengths ``--tc-sweep`` times
TC_SWEEP_PROMPTS = (512, 127, 64)


def tc_sweep(torch) -> list[dict]:
    """The tensor-core GEMM at every prefill shape of ``TC_SWEEP_PROMPTS``
    tokens (bf16; the scores flush to fp32, read K column-major; the
    values' A in padded rows) and quickstart's float32 1024^3, with every
    compiled tile of the dtype, split of K over 1-4 blocks (each rank a
    k-tile) and ring of 2 or 4 stages, each held to the plain version;
    profiler device time beside the runtime's pick and the library call
    (weight GEMMs over a rotation of ``COLD_BYTES``)."""
    from repro_torch.kernels import ref, runtime

    gen = torch.Generator(device="cuda").manual_seed(12)
    cases = [(site, kind, shape, col, "bfloat16")
             for p in TC_SWEEP_PROMPTS
             for site, kind, shape, col, _ in prefill_shapes(p)]
    cases.append(("quickstart", *QUICKSTART, False, "float32"))
    rows = []
    for site, kind, shape, col, dname in cases:
        dtype = getattr(torch, dname)
        out_dtype = torch.float32 if "scores" in site else None
        a, bs = rotation(torch, gen, kind, shape, col, dtype)
        if padded_site(site):
            a = padded(torch, a)
        fn, plain = gemm_fn(kind), ref.mm if kind == "mm" else ref.bmm
        want = plain(a, bs[0], out_dtype)
        picked = runtime.gemm_tile(a, bs[0], (64, 32, 32))
        ktiles = -(-shape[-1] * dtype.itemsize // runtime.TC_ROW_BYTES)
        times = {}
        for bm, bn in runtime.TC_TILES[dtype]:
            for split in range(1, runtime.TC_MAX_SPLIT + 1):
                if (split - 1) * -(-ktiles // split) >= ktiles:
                    continue
                for stages in (2, runtime.TC_MAX_STAGES):
                    tile = runtime.TcTile(bm, bn, stages, split)
                    err, ok = max_error(torch, fn(a, bs[0], tiles=tile,
                                                  out_dtype=out_dtype),
                                        want, want.dtype)
                    if not ok:
                        fail(f"{kind}{shape} {dname} {tile}: max |err| {err}")
                    times[tile] = device_ms(
                        torch, cycling(lambda x, y, t=tile: fn(
                            x, y, tiles=t, out_dtype=out_dtype), a, bs),
                        "gemm_tc_kernel", max(10, len(bs)))
        lib = torch.matmul if kind == "mm" else torch.bmm
        library = device_ms(torch, cycling(
            lambda x, y: lib(x, y) if out_dtype is None
            else lib(x, y, out_dtype), a, bs), None, max(10, len(bs)))
        best = min((t for t in times if times[t]), key=times.get)
        rows.append(dict(site=site, kind=kind, shape=shape, dtype=dname,
                         picked=str(picked), best=str(best),
                         times={str(t): ms for t, ms in times.items()},
                         library=library))
        by = ", ".join(f"{t.bm}x{t.bn}/{t.split}/{t.stages} "
                       f"{fmt_ms(ms).removesuffix(' ms')}"
                       for t, ms in times.items())
        print(f"sweep {kind}{shape} {dname} [{site}]: picked "
              f"{describe(picked, kind, shape)} {fmt_ms(times.get(picked))}, "
              f"fastest {describe(best, kind, shape)} {fmt_ms(times[best])}, "
              f"library {fmt_ms(library)}; device ms by tile/split/stages: "
              f"{by}", flush=True)
        del a, bs, want
    return rows


def recurrences_phase(torch) -> tuple[dict, dict, dict]:
    """Phase 6 (module docstring): the launches of the pipeline run (all
    and the GEMMs' by kernel), and the B6 / B7 time rows."""
    from repro_torch.launch import recurrences

    # the recurrence path: counts start at 0 here and are read right after
    reset_counts()
    t0 = time.perf_counter()
    rows = recurrences.run("cuda", "bench")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    variants = read_variants()
    if min(launches.values()) == 0:
        fail(f"a kernel was not launched on the recurrence path: {launches}")
    # every mttkrp case on the kernel its dtype and shape call for, and
    # each of its launches counted under that kernel
    cases = {}
    for row in rows:
        if row["name"] != "mttkrp":
            continue
        kernel = mttkrp_variant(row["tiles"].tile)
        if kernel != mttkrp_expected(row["args"], row["dtype"]):
            fail(f"recurrences: mttkrp {row['dtype']} ran on {kernel}")
        cases[row["dtype"]] = kernel
    by_kernel = variants["mttkrp"]
    if sum(by_kernel.values()) != launches["mttkrp"] or any(
            by_kernel[k] == 0 for k in set(cases.values())):
        fail(f"recurrences: mttkrp launches {launches['mttkrp']} by kernel "
             f"{by_kernel} do not match its cases {cases}")
    # the fft2d_stage case (64 x 64) on the fused kernel, and each of its
    # launches counted there
    from repro_torch.kernels import runtime
    ffts = [row for row in rows if row["name"] == "fft2d_stage"]
    if not ffts or any(not isinstance(row["tiles"].tile, runtime.Fft2dTile)
                       for row in ffts) \
            or variants["fft2d"] != {"fused": launches["fft2d"],
                                     "composition": 0}:
        fail(f"recurrences: fft2d off the fused kernel: "
             f"{[(r['args'], r['tiles'].tile) for r in ffts]}, launches "
             f"by form {variants['fft2d']}")
    # every float32 mm / bmm above 16 rows on the tensor-core kernel
    floats = [row for row in rows if row["name"] in ("mm", "bmm")
              and row["dtype"] == "float32"
              and row["args"][-3] > runtime.SKINNY_ROWS]
    off = [(row["name"], row["args"], row["tiles"].tile) for row in floats
           if not isinstance(row["tiles"].tile, runtime.TcTile)]
    if off or not floats or 0 in (variants["widesa_mm"]["wgmma"],
                                  variants["bmm"]["wgmma"]):
        fail(f"recurrences: float32 GEMMs above 16 rows off the tensor-core "
             f"kernel: {off} (launches by kernel {variants})")
    print(f"recurrences: {len(rows)} cases through lower_plan(plan, "
          f"'pallas') within tolerance in {dt:.1f} s; launches {launches}; "
          f"launches by kernel {variants} (GEMMs: the skinny kernel for at "
          f"most 16 rows of A, the tensor-core one above in float32 "
          f"({len(floats)} cases: {[(r['name'], r['args']) for r in floats]}) "
          f"and bf16, the tiled one for the integers; mttkrp cases {cases}; "
          f"fft2d {[(r['args'], str(r['tiles'].tile)) for r in ffts]})",
          flush=True)
    torch.cuda.empty_cache()
    hpc_parity(torch)
    hpc_rows = hpc_timings(torch)
    int_gemm_timings(torch)
    def below(dtype, other):
        row = hpc_rows[("mttkrp", dtype)]
        if None in (row["device_ms"], row.get(other)):
            return "not measured"
        return row["device_ms"] < row[other]

    dtypes = ("float32", "int8", "int16", "int32")
    print(f"recurrences: mttkrp device time below torch.einsum's: "
          f"{ {d: below(d, 'library_device_ms') for d in dtypes} }; below "
          f"the CUDA-core kernel's: "
          f"{ {d: below(d, 'cuda_core_device_ms') for d in dtypes} }",
          flush=True)
    return launches, variants, hpc_rows


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

#: element types of the mangled template arguments of the kernels the
#: build line lists one by one
MANGLED_TYPES = {"f": "float32", "a": "int8", "s": "int16", "i": "int32"}


def kernel_resources(log: str) -> list[str]:
    """Registers and spill stores of each instantiation of the fused fft2d
    kernel and of the tensor-core MTTKRP kernel, from ``ptxas -v``'s
    lines in the build log."""
    found, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and spill:
            found.append([name, None, int(spill.group(1))])
        elif name and regs and found and found[-1][0] == name:
            found[-1][1] = int(regs.group(1))
    out = []
    for mangled, regs, spill in found:
        tc = re.search(r"mttkrp_tc_kernelI(\w)\wLi(\d+)E", mangled)
        if tc:
            label = (f"mttkrp_tc_kernel<{MANGLED_TYPES[tc.group(1)]}, copy "
                     f"{tc.group(2)}>")
        elif "fft2d_kernel" in mangled:
            label = "fft2d_kernel"
        else:
            continue
        out.append(f"{label} {regs} registers, {spill} B spill")
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke of the port.")
    ap.add_argument("--tile-sweep", action="store_true",
                    help="only time every sweep tile at the main-path "
                         "shapes")
    ap.add_argument("--mttkrp-sweep", action="store_true",
                    help="only time the tensor-core MTTKRP with every split "
                         "of K at the bench size")
    ap.add_argument("--fft-sweep", action="store_true",
                    help="only time the fused fft2d kernel with every split "
                         "of K at the frontend and pipeline grids")
    ap.add_argument("--tc-sweep", action="store_true",
                    help="only time the tensor-core GEMM with every tile, "
                         "split and ring depth at the prefill shapes")
    ap.add_argument("--out", help="with a sweep: write the times here as "
                                  "JSON")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    # the plain versions run PyTorch's fp32 GEMMs: keep them in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"device: {name} [{smi}], {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    paths = build.build(("widesa_hpc",) if args.mttkrp_sweep
                        else ("widesa_mm",) if args.tc_sweep
                        else ("widesa_mm", "widesa_sp") if args.fft_sweep
                        else tuple(build.SOURCES))
    for lib in paths:
        build.library(lib)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                       build.build_log)]
    spills = re.findall(r"(\d+) bytes spill stores", build.build_log)
    print(f"build: {', '.join(p.name for p in paths.values())} ready in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} "
          f"s on the wall clock, one process per source; {len(regs)} "
          f"kernels, at most {max(regs, default=0)} registers a thread, "
          f"{sum(int(x) for x in spills)} bytes of spill stores; "
          f"{'; '.join(kernel_resources(build.build_log))})", flush=True)

    if args.mttkrp_sweep or args.tc_sweep or args.fft_sweep:
        rows = (mttkrp_sweep(torch) if args.mttkrp_sweep
                else tc_sweep(torch) if args.tc_sweep else fft_sweep(torch))
        if args.out:
            Path(args.out).write_text(json.dumps(rows, indent=1))
        return 0
    if args.tile_sweep:
        t0 = time.perf_counter()
        build.library("widesa_mm", sweep=True)
        print(f"build: sweep library ({len(build.SWEEP_TILES)} tiles) ready "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        rows = tile_sweep(torch)
        if args.out:
            Path(args.out).write_text(json.dumps(rows, indent=1))
        return 0
    parity(torch)
    tc_parity(torch)
    sp_parity(torch)
    rows = timings(torch)
    tc_rows = tc_timings(torch)
    rows.update(sp_timings(torch))
    print("kernels: widesa_mm (B1, widesa_mm.py mm_kernel -> cuda), bmm "
          "(B2, bmm.py bmm_kernel -> cuda) in " + SOURCE + " (skinny_kernel "
          "for M <= 16, gemm_tc_kernel on wgmma above in bf16 and float32, "
          "gemm_kernel tiled for the rest); fir (B3, fir.py fir_kernel "
          "-> cuda), conv2d (B5, conv2d.py conv_kernel -> cuda) in "
          + SP_SOURCE + "; fft2d (B4, fft2d.py fft2d/_cmul_mm -> cuda, "
          "fft2d_kernel in " + SP_SOURCE + " up to 64 rows, the composition "
          "over the GEMMs above); jacobi2d (B6, jacobi2d.py jacobi_kernel -> "
          "cuda), mttkrp (B7, mttkrp.py mttkrp_kernel -> cuda: "
          "mttkrp_tc_kernel on wgmma, float32 as 3xTF32, int8, int16 and "
          "int32 as int8 limbs; mttkrp_kernel on the CUDA cores for the "
          "rest) in " + HPC_SOURCE,
          flush=True)
    torch.cuda.empty_cache()

    launches, variants = serve(torch, name)
    torch.cuda.empty_cache()
    prefill_launches, prefill_variants = prefill_phase(torch, name)
    torch.cuda.empty_cache()
    stream_launches, stream_variants = stream_serve(torch, name)
    torch.cuda.empty_cache()
    rec_launches, rec_variants, hpc_rows = recurrences_phase(torch)
    rows.update({(kname, "main"): hpc_rows[(kname, "float32")]
                 for kname in ("jacobi2d", "mttkrp")})

    summary = []
    for kname, k in KERNELS.items():
        row = rows[(k["kind"], k["shape"], k["col_major"])] if "kind" in k \
            else rows[(kname, "main")]
        entry = {
            "name": kname, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": {"qwen": launches[kname],
                         "qwen_prefill": prefill_launches[kname],
                         "whisper_stream": stream_launches[kname],
                         "recurrences": rec_launches[kname]},
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        }
        if kname in variants:
            # launches by kernel per path, and device times: the GEMMs'
            # (the tiled kernel's beside) with the host time of a wrapper
            # call, mttkrp's (the CUDA-core kernel's beside), fft2d's (the
            # composition's beside)
            entry["launches_by_kernel"] = {
                "qwen": variants[kname],
                "qwen_prefill": prefill_variants[kname],
                "whisper_stream": stream_variants[kname],
                "recurrences": rec_variants[kname]}
            keys = {"mttkrp": ("device_ms", "cuda_core_device_ms",
                               "library_device_ms", "cuda_core_bound_ms"),
                    "fft2d": ("device_ms", "composition_device_ms",
                              "library_device_ms", "dft_bound_ms")}.get(
                kname, ("device_ms", "tiled_device_ms", "library_device_ms",
                        "host_us", "facade_us"))
            entry.update({key: row[key] for key in keys})
        if kname in WGMMA_SHAPES:
            # the tensor-core kernel at its prefill shape, the tiled
            # kernel and the library call beside it
            kind, shape, col = WGMMA_SHAPES[kname]
            tc = tc_rows[(kind, shape, col)]
            entry["wgmma"] = {"shape": f"{kind}{shape}",
                              **{key: tc[key] for key in (
                                  "device_ms", "tiled_device_ms",
                                  "library_device_ms", "plain_ms",
                                  "bound_ms", "host_us")}}
        summary.append(entry)
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
