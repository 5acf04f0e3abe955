#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --tile-sweep [--out sweep.json]

Needs one CUDA card and the CUDA toolkit.  It imports only the port, never
JAX nor the JAX package, and runs seven phases, each printing its own
line(s); any failure exits non-zero:

1. device — the card's name and power limit, torch and CUDA versions;
2. build  — compiles the port's three CUDA sources from ``src/`` (one
   ``nvcc`` each, started together; set-up time);
3. kernels — every hand-written kernel against its plain PyTorch version
   on the card: the mm/bmm GEMM in all five dtypes at every serving shape,
   at ragged ones and with every compiled tile; FIR and conv2d in every
   dtype they take, at the whisper-base frontend shapes and at ragged
   ones, with the tile the runtime picks and every compiled tile; the
   fft2d composition over the GEMM against ``torch.fft.fft2``.  Then each
   is timed beside its plain version, one PyTorch call computing the same
   function (``torch.matmul``/``torch.bmm``, ``F.conv1d``, ``F.conv2d``,
   ``torch.fft.fft2``: yardsticks only) and its memory/compute bound, at
   the main-path shapes and, for FIR and conv2d, at the registry's
   bandwidth-sized bench shapes; FIR, conv2d, the fft2d composition and
   their library calls also get their device time from ``torch.profiler``
   (the launch overhead left out), FIR and conv2d with every compiled
   tile;
4. serve  — full-width qwen1.5-0.5b (bf16, 24 layers, vocab 151936,
   random weights from a ``torch.Generator`` seeded with 0) on the slot
   engine: 4 slots, max_seq 128, 8 requests of 4-16 prompt tokens and 8
   new tokens each.  Checks every request's budget, that every planned
   site planned and never fell back, that both GEMM kernels launched
   during the drain, that every GEMM shape the drain gave a site matches
   the plain version (``drain_parity``), and that each prompt's prefill
   logits match a second, explicit prefill through the plain versions.
   One 4-lane decode step
   is then timed on the host clock and traced with ``torch.profiler``
   for the card's busy time and the hand kernels' share of it;
5. stream — full-width whisper-base (bf16, 6+6 layers, d 512, vocab
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
6. recurrences — the WideSA mapper -> kernel pipeline,
   ``repro_torch.launch.recurrences.run`` (the entry point's function):
   the Table II compiler report, quickstart's 1024^3 MM, and every
   registered recurrence planned on one chip and run through
   ``lower_plan(plan, "pallas")`` against its plain version, the stencils
   and mttkrp at their paper-scale bench sizes in every parity dtype.
   Checks that the star-stencil (B6) and MTTKRP (B7) kernels launched.
   Then holds B6 (5-point, 9-point, and the multi-sweep form on its
   int32 state) and B7 against their plain versions at the bench sizes
   and at ragged ones, in float32, int8, int16 and int32, checks that
   the float32 bound rejects a TF32 control (the plain MTTKRP with TF32
   GEMMs on), and times them beside their plain versions, one
   PyTorch call (``F.conv2d`` with the star as a zero-padded filter,
   ``torch.einsum``; yardsticks only) and their bounds, with
   ``torch.profiler`` device time;
7. summary — a JSON line of the kernels, the ``nvidia-smi`` name and
   power limit, and the result line.

Every wrapper's launch count is set to 0 just before each serving drain
and before the recurrence pipeline, and read just after; the kernels
line gives each path's counts apart (``"launches": {"qwen": n,
"whisper_stream": m, "recurrences": k}``).  The comparison and timing
launches of phases 3 and 6 and of ``drain_parity`` do not count.

``--tile-sweep`` runs only the device and build phases, then times the
GEMM in bf16 with each of the 24 tiles of ``build.SWEEP_TILES`` (a second
library holds those not compiled for the main path) at every main-path
shape and prints, per shape, the tile ``runtime.hopper_tiles`` picks and
the fastest one (``--out`` writes all times as JSON).

Tolerances: integer results are bit-exact (wrapping int32, as XLA);
float32 results within the kernel registry's atol 1e-3 (1.0 for the
fft2d composition, the registry's fft2d_stage atol: fp32 sums of 515
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
#: and bf16 / fp32 operations per second.  FIR and conv2d run on the CUDA
#: cores in every dtype, and the data sheet gives no integer rate for
#: them, so their operations count at the fp32 rate (a bound that is low
#: for integers; the bytes bound them at every shape timed here anyway)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

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
    ("attn.decode_scores", "bmm", (64, 1, 128, 64), False, 24),
    ("attn.decode_values", "bmm", (64, 1, 64, 128), False, 24),
    ("attn.scores, prefill", "bmm", (16, 12, 12, 64), False, 0),
    ("attn.values, prefill", "bmm", (16, 12, 64, 12), False, 0),
)
RAGGED_SHAPES = (("mm", (61, 126, 37)), ("mm", (1, 300, 77)),
                 ("bmm", (3, 61, 126, 37)), ("bmm", (5, 7, 33, 130)))

#: the kernel row of each ported TPU kernel: its main-path shape for the
#: timing columns, what it replaces and where its source is
SOURCE = "src/repro_torch/kernels/csrc/widesa_mm.cu"
SP_SOURCE = "src/repro_torch/kernels/csrc/widesa_sp.cu"
HPC_SOURCE = "src/repro_torch/kernels/csrc/widesa_hpc.cu"
KERNELS = {
    "widesa_mm": dict(kind="mm", shape=(4, 151936, 1024), col_major=True,
                      replaces="src/repro/kernels/widesa_mm.py:31",
                      source=SOURCE),
    "bmm": dict(kind="bmm", shape=(64, 1, 128, 64), col_major=False,
                replaces="src/repro/kernels/bmm.py:24", source=SOURCE),
    "fir": dict(replaces="src/repro/kernels/fir.py:25", source=SP_SOURCE),
    "conv2d": dict(replaces="src/repro/kernels/conv2d.py:32",
                   source=SP_SOURCE),
    # no CUDA of its own: six launches of the GEMM above
    "fft2d": dict(replaces="src/repro/kernels/fft2d.py:34",
                  source="src/repro_torch/kernels/fft2d.py"),
    # one kernel for jacobi2d, jacobi2d_9pt and each sweep of jacobi2d_ms
    "jacobi2d": dict(replaces="src/repro/kernels/jacobi2d.py:31",
                     source=HPC_SOURCE),
    "mttkrp": dict(replaces="src/repro/kernels/mttkrp.py:29",
                   source=HPC_SOURCE),
}

#: the frontend shapes of whisper-base (FrontendConfig(d_model=512): a
#: 12 x 515 tile of 6180 samples, 15 taps, a 5 x 4 filter, int16), ragged
#: shapes, and the registry's bandwidth-sized bench shapes (float32)
SP_MAIN = {"fir": (6180, 15), "conv2d": (8, 512, 5, 4)}
SP_RAGGED = {"fir": ((1000, 7), (70001, 15)),
             "conv2d": ((37, 70, 3, 5), (130, 333, 4, 4))}
SP_BENCH = {"fir": (1048576, 15), "conv2d": (10240, 10240, 4, 4)}
FFT_MAIN = (12, 515)


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


def read_counts() -> dict:
    return {name: mod.launches for name, mod in wrappers().items()}


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
    if kind == "mm":
        m, n, k = shape
        a = draw(torch, gen, (m, k), dtype)
        b = (draw(torch, gen, (n, k), dtype).t() if col_major
             else draw(torch, gen, (k, n), dtype))
    else:
        z, m, n, k = shape
        a = draw(torch, gen, (z, m, k), dtype)
        b = draw(torch, gen, (z, k, n), dtype)
    return a, b


def kernel_call(kind, shape, dtype, col_major, out_dtype=None):
    """The hand kernel at the tile the planner picks for this shape."""
    from repro_torch.kernels import bmm, planned, runtime, widesa_mm

    plan = planned.plan_for(kind, shape, planned.dtype_name(dtype))
    if plan is None:
        fail(f"no feasible plan for {kind}{shape} {dtype}")
    tiles = runtime.hopper_tiles(plan, b_col_major=col_major).tile
    fn = widesa_mm.matmul if kind == "mm" else bmm.bmm
    return (lambda a, b: fn(a, b, tiles=tiles, out_dtype=out_dtype)), tiles


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


def parity(torch) -> None:
    """Every kernel against its plain version, all dtypes and shapes."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = (torch.float32, torch.bfloat16, torch.int8, torch.int16,
              torch.int32)
    cases = [(kind, shape, col) for _, kind, shape, col, _ in MAIN_SHAPES]
    cases += [(kind, shape, False) for kind, shape in RAGGED_SHAPES]
    cases += [("mm", (61, 126, 37), True)]
    n = 0
    for dtype in dtypes:
        for kind, shape, col in cases:
            a, b = operands(torch, gen, kind, shape, dtype, col)
            fn, tiles = kernel_call(kind, shape, dtype, col)
            plain = ref.mm if kind == "mm" else ref.bmm
            out, want = fn(a, b), plain(a, b)
            torch.cuda.synchronize()
            err, ok = max_error(torch, out, want, dtype)
            if not ok:
                fail(f"{kind}{shape} {dtype} tile {tiles}: max |err| {err}")
            n += 1
    # every compiled tile, including those no serving plan picks, on a
    # ragged mm (column-major B) and a ragged bmm
    from repro_torch.kernels import bmm, build, widesa_mm

    for tiles in build.COMPILED_TILES:
        for dtype in dtypes:
            for kind, shape, col in (("mm", (61, 126, 37), True),
                                     ("bmm", (3, 61, 126, 37), False)):
                a, b = operands(torch, gen, kind, shape, dtype, col)
                fn, plain = ((widesa_mm.matmul, ref.mm) if kind == "mm"
                             else (bmm.bmm, ref.bmm))
                out, want = fn(a, b, tiles=tiles), plain(a, b)
                torch.cuda.synchronize()
                err, ok = max_error(torch, out, want, dtype)
                if not ok:
                    fail(f"{kind}{shape} {dtype} tile {tiles}: max |err| "
                         f"{err}")
                n += 1
    # attention scores: bf16 operands, the fp32 accumulator flushed as is
    for _, kind, shape, *_ in MAIN_SHAPES:
        if kind != "bmm":
            continue
        a, b = operands(torch, gen, kind, shape, torch.bfloat16, False)
        fn, tiles = kernel_call(kind, shape, torch.bfloat16, False,
                                torch.float32)
        out, want = fn(a, b), ref.bmm(a, b, torch.float32)
        torch.cuda.synchronize()
        err, ok = max_error(torch, out, want, torch.float32)
        if not ok:
            fail(f"bmm{shape} bf16->fp32 tile {tiles}: max |err| {err}")
        n += 1
    print(f"kernels: parity ok in {n} cases (5 dtypes x {len(cases)} "
          f"serving/ragged shapes, 5 dtypes x every compiled tile x 2 "
          f"ragged shapes, bf16->fp32 bmm): integers bit-exact, "
          f"fp32 <= 1e-3, bf16 <= 2^-7|ref| + 1e-3", flush=True)


#: report sites whose shapes are not one GEMM: the frontend's FIR, conv2d
#: and fft2d chain (held in phase 3) and the MLP pair's ``xla`` stamp
NON_GEMM_SITES = ("frontend.", "mlp.pair")


def drain_parity(torch, report, path: str) -> None:
    """Every GEMM shape a serving drain gave a site (``planned_report``),
    through the hand kernel at the tile the planner picks against the
    plain version, in bf16 (the serving dtype): the lm_head reads its B
    column-major, as the tied head does; the score sites flush to fp32.
    Run after the drain's counts are read, so these launches count for
    no path."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = sorted({(site, ast.literal_eval(key))
                    for site, st in report.items()
                    if not site.startswith(NON_GEMM_SITES)
                    for key in st["shapes"]})
    worst = 0.0
    for site, shape in cases:
        kind = "mm" if len(shape) == 3 else "bmm"
        col = site == "lm_head"
        out_dtype = torch.float32 if "scores" in site else None
        a, b = operands(torch, gen, kind, shape, torch.bfloat16, col)
        fn, tiles = kernel_call(kind, shape, torch.bfloat16, col, out_dtype)
        plain = ref.mm if kind == "mm" else ref.bmm
        out, want = fn(a, b), plain(a, b, out_dtype)
        torch.cuda.synchronize()
        err, ok = max_error(torch, out, want, out.dtype)
        if not ok:
            fail(f"{path}: {site} {kind}{shape} bf16 tile {tiles}: max "
                 f"|err| {err}")
        worst = max(worst, err)
        del a, b, out, want
    print(f"{path}: the {len(cases)} GEMM (site, shape) pairs of the drain "
          f"match the plain versions in bf16 at the planned tiles (bf16 "
          f"<= 2^-7|ref| + 1e-3, fp32 scores <= 1e-3; max |err| "
          f"{worst:.4g}): {sorted({s for s, _ in cases})}", flush=True)


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
    calls; None if the profiler recorded nothing.  With ``kernel``: the
    mean time of the CUDA kernel records whose name holds ``kernel``,
    times ``launches`` (those kernels a call), since the profiler can drop
    device records and each record it keeps is one launch's time.
    Without: every device event of the trace, over ``reps``.  Unlike
    ``time_ms`` this leaves out the host's launch overhead, which back-to-
    back launches of a short kernel measure instead of the kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evts = [evt for evt in prof.key_averages()
            if kernel is None or kernel in evt.key]
    us = sum(getattr(evt, "self_device_time_total", 0.0) for evt in evts)
    if not us:
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


def timings(torch) -> dict:
    """Kernel, plain version, library call and bound at the main-path
    shapes, in bf16 (the serving dtype; scores flush to fp32)."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for site, kind, shape, col, _ in MAIN_SHAPES:
        out_dtype = torch.float32 if "scores" in site else None
        a, b = operands(torch, gen, kind, shape, torch.bfloat16, col)
        fn, tiles = kernel_call(kind, shape, torch.bfloat16, col, out_dtype)
        plain = ref.mm if kind == "mm" else ref.bmm
        lib = torch.matmul if kind == "mm" else torch.bmm
        out, want = fn(a, b), plain(a, b, out_dtype)
        err, _ = max_error(torch, out, want, out.dtype)
        row = dict(
            tiles=tiles,
            ms=time_ms(torch, lambda: fn(a, b)),
            plain_ms=time_ms(torch, lambda: plain(a, b, out_dtype)),
            # torch.bmm's out_dtype is the same fp32 flush of bf16 inputs
            library_ms=time_ms(torch, lambda: lib(a, b) if out_dtype is None
                               else lib(a, b, out_dtype)),
            max_abs_err=err,
        )
        row["bound_ms"], row["bound_by"] = bound_ms(
            kind, shape, 2, out.element_size(), "bfloat16")
        rows[(kind, shape)] = row
        print(f"time {kind}{shape} bf16 [{site}] tile={tiles}: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"torch.{lib.__name__} {row['library_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        del a, b, out, want
    # the GEMM share of one decode step, from the per-shape times
    step = {key: sum(n * rows[(kind, shape)][key]
                     for _, kind, shape, _, n in MAIN_SHAPES)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"time: the {sum(s[-1] for s in MAIN_SHAPES)} GEMMs of a 4-lane "
          f"decode step, summed from the lines above: kernel "
          f"{step['ms']:.4f} ms, plain {step['plain_ms']:.4f} ms, library "
          f"{step['library_ms']:.4f} ms, bound {step['bound_ms']:.4f} ms",
          flush=True)
    return rows


def tile_sweep(torch) -> list[dict]:
    """Every sweep tile at every main-path shape, bf16."""
    from repro_torch.kernels import bmm, build, planned, runtime, widesa_mm

    gen = torch.Generator(device="cuda").manual_seed(3)
    tiles = build.SWEEP_TILES
    rows = []
    for site, kind, shape, col, _ in MAIN_SHAPES:
        a, b = operands(torch, gen, kind, shape, torch.bfloat16, col)
        fn = widesa_mm.matmul if kind == "mm" else bmm.bmm
        times = {t: time_ms(torch, lambda t=t: fn(a, b, tiles=t))
                 for t in tiles}
        picked = runtime.hopper_tiles(
            planned.plan_for(kind, shape, "bfloat16"), b_col_major=col).tile
        best = min(times, key=times.get)
        rows.append(dict(site=site, kind=kind, shape=shape, picked=picked,
                         best=best, times={str(t): ms
                                           for t, ms in times.items()}))
        print(f"sweep {kind}{shape} [{site}]: picked {picked} "
              f"{times[picked]:.4f} ms, fastest {best} {times[best]:.4f} ms",
              flush=True)
        del a, b
    return rows


# ---------------------------------------------------------------------------
# FIR, conv2d and the fft2d composition
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


def fft_kernel():
    """The fft2d composition at the GEMM tile of the fft2d_stage plan."""
    from repro_torch.kernels import fft2d, planned, runtime

    plan = planned.plan_for("fft2d_stage", FFT_MAIN, "float32")
    if plan is None:
        fail(f"no feasible plan for fft2d_stage{FFT_MAIN}")
    tiles = runtime.hopper_tiles(plan).tile
    return (lambda re_, im_: fft2d.fft2d(re_, im_, tiles=tiles)), tiles


def sp_parity(torch) -> None:
    """FIR and conv2d against their plain versions in every dtype they
    take, at the frontend and ragged shapes, with every compiled tile
    (the picked one among them); the fft2d composition against
    ``ref.fft2d``."""
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
    call, tiles = fft_kernel()
    re_, im_ = (torch.randn(FFT_MAIN, generator=gen, device="cuda")
                for _ in range(2))
    got, want = call(re_, im_), ref.fft2d(re_, im_)
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if err > 1.0:
        fail(f"fft2d{FFT_MAIN} composition tile {tiles}: max |err| {err} "
             "> 1.0")
    n += 1
    print(f"kernels: FIR/conv2d parity ok in {n} cases (4 dtypes x "
          f"frontend and ragged shapes x every compiled tile; integers "
          f"bit-exact, fp32 <= 1e-3; fft2d composition <= 1.0)", flush=True)


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
    frontend, int16) and at the registry's bench shape (float32), and the
    fft2d composition at the frontend tile: kernel, plain version, one
    PyTorch call and bound.  The library call takes float32 copies of
    integer inputs (``F.conv1d``/``F.conv2d`` take no integers on the
    card), with TF32 off."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, conv2d, fir, ref

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
    call, tiles = fft_kernel()
    re_, im_ = (torch.randn(FFT_MAIN, generator=gen, device="cuda")
                for _ in range(2))
    got, want = call(re_, im_), ref.fft2d(re_, im_)

    def fft_lib(x_re, x_im):
        return torch.fft.fft2(torch.complex(x_re, x_im))

    r, c = FFT_MAIN
    row = dict(
        tiles=tiles,
        max_abs_err=max((g - w).abs().max().item()
                        for g, w in zip(got, want)),
        ms=time_ms(torch, lambda: call(re_, im_)),
        plain_ms=time_ms(torch, lambda: ref.fft2d(re_, im_)),
        library_ms=time_ms(torch, lambda: fft_lib(re_, im_)),
    )
    # the function's least work, not the composition's: two float32
    # planes in and two out, and an FFT's 5 N log2 N operations over the
    # N = r * c complex points
    n = r * c
    row["bound_ms"], row["bound_by"] = least_ms(
        4 * n * 4, 5 * n * math.log2(n), "float32")
    rows[("fft2d", "main")] = row
    print(f"time fft2d{FFT_MAIN} float32 [composition, 6 mm launches at "
          f"tile {tiles}]: {row['ms']:.4f} ms, plain (torch.fft.fft2) "
          f"{row['plain_ms']:.4f} ms, torch.fft.fft2 "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}); device time (profiler): composition "
          f"{fmt_ms(device_ms(torch, lambda: call(re_, im_)))}, "
          f"torch.fft.fft2 {fmt_ms(device_ms(torch, lambda: fft_lib(re_, im_)))}",
          flush=True)
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
    print(f"serve: {len(done)} requests / {tokens} tokens in {dt:.3f} s = "
          f"{tokens / dt:.1f} tok/s on {device_name}; launches {launches}; "
          f"{len(report)} sites all planned: {sorted(report)}", flush=True)
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
    return launches


def profile_decode(torch, eng) -> None:
    """Host time of one 4-lane decode step, and the card's busy time in it
    by kernel family (``torch.profiler``; device events only)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import bmm, widesa_mm

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
    widesa_mm.launches = bmm.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    per_step = (f"launches widesa_mm {widesa_mm.launches}, "
                f"bmm {bmm.launches}")
    hand = other = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0.0)
        if "gemm_kernel" in evt.key:
            hand += us
        else:
            other += us
    wall = sorted(walls)[len(walls) // 2]
    if hand + other == 0:
        print(f"profile: decode step {wall:.2f} ms on the host clock "
              f"(median of 5), {per_step}; device busy time not measured "
              "(the profiler recorded no device events)", flush=True)
        return
    busy = (hand + other) / 1e3
    print(f"profile: decode step {wall:.2f} ms on the host clock (median "
          f"of 5), {per_step}; device busy {busy:.2f} ms in the traced "
          f"step: hand kernels {hand / 1e3:.2f} ms, other kernels "
          f"{other / 1e3:.2f} ms; device idle "
          f"{max(0.0, 1 - busy / wall):.0%} of the step", flush=True)


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
    report = planned.planned_report()

    if len(done) != REQUESTS or any(len(r.output) != MAX_NEW for r in done):
        fail(f"stream requests did not finish with their budget: "
             f"{[(r.rid, len(r.output)) for r in done]}")
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
          f"launches {launches} (fir and conv2d: one each per chunk); plan "
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
    return launches


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
             ("mttkrp", "float32"), ("mttkrp", "int8"))


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
    n, worst = 0, {}
    for name in HPC_BENCH:
        compiled = build.MTTKRP_TILE if name == "mttkrp" \
            else build.STENCIL_TILE
        for args in (HPC_RAGGED[name], HPC_BENCH[name]):
            for dtype in ("float32", "int8", "int16", "int32"):
                fn, spec, rec, plan = hpc_call(name, args, dtype)
                ops = registry.operands(rec, gen, "cuda")
                tile = spec.tiles(plan, *ops).tile
                if tile != compiled:
                    fail(f"{name}{args}: tile {tile} is not the compiled "
                         f"{compiled}")
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
    print(f"recurrences: B6/B7 parity ok in {n} cases (4 specs x bench and "
          f"ragged sizes x 4 dtypes; integers bit-exact; float32 max |err| "
          f"{floats} within recurrences.float_bound)", flush=True)
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


def hpc_bound_ms(name, rec, in_bytes, out_bytes, rate="float32"):
    """Least time for one call (``least_ms``): each operand read once and
    the result written once, or the folded operations at the peak rate
    of ``rate`` (the fp32 CUDA-core rate unless asked otherwise).  For
    jacobi2d_ms that is the whole function (grid in, result out, 2 S T
    operations an output); mttkrp counts 2 I J K L operations (one
    multiply-add per (i, j, k, l) once B C is folded), not the IR's
    ops_per_point = 3."""
    e = {loop: rec.extent(loop) for loop in rec.loops}
    if name == "mttkrp":
        moved = (e["i"] * e["k"] * e["l"] + (e["k"] + e["l"]) * e["j"]) \
            * in_bytes + e["i"] * e["j"] * out_bytes
        return least_ms(moved, 2 * e["i"] * e["j"] * e["k"] * e["l"], rate)
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
    bound (for int8 mttkrp also at the int8 tensor-core rate)."""
    from repro_torch.kernels import registry

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
        kname = "mttkrp_kernel" if name == "mttkrp" else "star_kernel"
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
        rows[(name, dtype)] = row
        extra = ""
        if name == "jacobi2d_ms":
            sweeps = rec.extent("t")
            floor = sweeps * hpc_bound_ms(
                "jacobi2d", registry.get("jacobi2d").builder(
                    rec.extent("i"), rec.extent("j"), dtype), 4, 4)[0]
            extra = (f"; {sweeps} launches a call, floor of {sweeps} "
                     f"separate passes {floor:.4f} ms")
        if name == "mttkrp" and dtype == "int8":
            tc_ms, tc_by = hpc_bound_ms(name, rec, 1, 4, rate="int8")
            extra = f"; int8 tensor-core bound {tc_ms:.4f} ms ({tc_by})"
        rate = ", fp32 CUDA-core rate" \
            if row["bound_by"] == "operations" else ""
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


def recurrences_phase(torch) -> tuple[dict, dict]:
    """Phase 6 (module docstring): the launches of the pipeline run, and
    the B6 / B7 time rows."""
    from repro_torch.launch import recurrences

    # the recurrence path: counts start at 0 here and are read right after
    reset_counts()
    t0 = time.perf_counter()
    rows = recurrences.run("cuda", "bench")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    if min(launches.values()) == 0:
        fail(f"a kernel was not launched on the recurrence path: {launches}")
    print(f"recurrences: {len(rows)} cases through lower_plan(plan, "
          f"'pallas') within tolerance in {dt:.1f} s; launches {launches}",
          flush=True)
    torch.cuda.empty_cache()
    hpc_parity(torch)
    return launches, hpc_timings(torch)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke of the port.")
    ap.add_argument("--tile-sweep", action="store_true",
                    help="only time every sweep tile at the main-path "
                         "shapes")
    ap.add_argument("--out", help="with --tile-sweep: write the times here "
                                  "as JSON")
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
    paths = build.build()
    for lib in paths:
        build.library(lib)
    regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                       build.build_log)]
    spills = re.findall(r"(\d+) bytes spill stores", build.build_log)
    print(f"build: {', '.join(p.name for p in paths.values())} ready in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} "
          f"s on the wall clock, one process per source; {len(regs)} "
          f"kernels, at most {max(regs, default=0)} registers a thread, "
          f"{sum(int(x) for x in spills)} bytes of spill stores)", flush=True)

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
    sp_parity(torch)
    rows = timings(torch)
    rows.update(sp_timings(torch))
    print("kernels: widesa_mm (B1, widesa_mm.py mm_kernel -> cuda), bmm "
          "(B2, bmm.py bmm_kernel -> cuda) in " + SOURCE + "; fir (B3, "
          "fir.py fir_kernel -> cuda), conv2d (B5, conv2d.py conv_kernel -> "
          "cuda) in " + SP_SOURCE + "; fft2d (B4, fft2d.py _cmul_mm -> six "
          "widesa_mm launches); jacobi2d (B6, jacobi2d.py jacobi_kernel -> "
          "cuda), mttkrp (B7, mttkrp.py mttkrp_kernel -> cuda) in "
          + HPC_SOURCE, flush=True)
    torch.cuda.empty_cache()

    launches = serve(torch, name)
    torch.cuda.empty_cache()
    stream_launches = stream_serve(torch, name)
    torch.cuda.empty_cache()
    rec_launches, hpc_rows = recurrences_phase(torch)
    rows.update({(kname, "main"): hpc_rows[(kname, "float32")]
                 for kname in ("jacobi2d", "mttkrp")})

    summary = []
    for kname, k in KERNELS.items():
        row = rows[(k["kind"], k["shape"])] if "kind" in k \
            else rows[(kname, "main")]
        summary.append({
            "name": kname, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": {"qwen": launches[kname],
                         "whisper_stream": stream_launches[kname],
                         "recurrences": rec_launches[kname]},
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
