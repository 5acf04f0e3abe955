#!/usr/bin/env python3
"""On-card smoke of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --tile-sweep [--out sweep.json]

Needs one CUDA card and the CUDA toolkit.  It imports only the port, never
JAX nor the JAX package, and runs five phases, each printing its own
line(s); any failure exits non-zero:

1. device — the card's name and power limit, torch and CUDA versions;
2. build  — compiles the port's CUDA kernels from ``src/`` (set-up time);
3. kernels — every hand-written kernel against its plain PyTorch version
   on the card, in all five dtypes, at every serving shape and at ragged
   ones, and with every compiled tile; then timed beside its plain
   version, ``torch.matmul`` / ``torch.bmm`` (yardsticks only) and its
   memory/compute bound;
4. serve  — full-width qwen1.5-0.5b (bf16, 24 layers, vocab 151936,
   random weights from a ``torch.Generator`` seeded with 0) on the slot
   engine: 4 slots, max_seq 128, 8 requests of 4-16 prompt tokens and 8
   new tokens each.  Checks every request's budget, that every planned
   site planned and never fell back, that both kernels launched during
   the drain, and that each prompt's prefill logits match a second,
   explicit prefill through the plain versions.  One 4-lane decode step
   is then timed on the host clock and traced with ``torch.profiler`` for
   the card's busy time and the hand kernels' share of it;
5. summary — a JSON line of the kernels, the ``nvidia-smi`` name and
   power limit, and the result line.

``--tile-sweep`` runs only the device and build phases, then times the
hand kernel in bf16 with each of the 24 tiles of ``build.SWEEP_TILES``
(a second library holds those not compiled for the main path) at every
main-path shape and prints, per shape, the tile ``runtime.hopper_tiles``
picks and the fastest one (``--out`` writes all times as JSON).

Tolerances: integer results are bit-exact (wrapping int32, as XLA);
float32 results within the kernel registry's atol 1e-3; bf16 results
within ``2^-7 * |ref| + 1e-3``, one bf16 rounding step of the output
(8-bit significand) on top of fp32 sums taken in another order.  The
prefill logits of the whole bf16 model are held to ``LOGIT_ATOL`` (see
there).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: peak rates of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s
#: and bf16 / fp32 operations per second
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

#: prefill logits of the 24-layer bf16 model, hand kernels vs the plain
#: versions: every GEMM output rounds to bf16 (2^-8 relative) and the two
#: paths sum in different orders, so roundings flip between them and the
#: flips propagate through 24 residual layers; logits are O(1) here
LOGIT_ATOL = 0.25

ARCH = "qwen1.5-0.5b"
SLOTS, MAX_SEQ, REQUESTS, MAX_NEW = 4, 128, 8, 8

#: the serving GEMMs of the main path (prefill of a 12-token prompt and a
#: 4-lane decode step), as (site, kind, shape, B column-major, launches
#: in one decode step of the 24-layer model)
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
#: timing columns, and what it replaces
KERNELS = {
    "widesa_mm": dict(kind="mm", shape=(4, 151936, 1024), col_major=True,
                      replaces="src/repro/kernels/widesa_mm.py:31"),
    "bmm": dict(kind="bmm", shape=(64, 1, 128, 64), col_major=False,
                replaces="src/repro/kernels/bmm.py:24"),
}
SOURCE = "src/repro_torch/kernels/csrc/widesa_mm.cu"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


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


def bound_ms(kind, shape, in_bytes, out_bytes, dtype_name):
    """Least time for the work: each input read once and the output
    written once at the HBM rate, or the multiply-adds at the peak rate
    of the operand type, whichever is larger."""
    if kind == "mm":
        (m, n, k), z = shape, 1
    else:
        z, m, n, k = shape
    moved = z * ((m * k + k * n) * in_bytes + m * n * out_bytes)
    ops = 2 * z * m * n * k
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
# serve
# ---------------------------------------------------------------------------

def serve(torch, device_name: str) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import bmm, planned, widesa_mm
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
    widesa_mm.launches = 0
    bmm.launches = 0
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"widesa_mm": widesa_mm.launches, "bmm": bmm.launches}
    report = planned.planned_report()

    if len(done) != REQUESTS or any(len(r.output) != MAX_NEW for r in done):
        fail(f"requests did not finish with their budget: "
             f"{[(r.rid, len(r.output)) for r in done]}")
    bad = {s: (st["planned"], st["fallback"], st["reasons"])
           for s, st in report.items()
           if st["planned"] == 0 or st["fallback"] != 0}
    if bad or not report:
        fail(f"planned sites that fell back or never planned: {bad}")
    if min(launches.values()) == 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    tokens = sum(len(r.output) for r in done)
    print(f"serve: {len(done)} requests / {tokens} tokens in {dt:.3f} s = "
          f"{tokens / dt:.1f} tok/s on {device_name}; launches {launches}; "
          f"{len(report)} sites all planned: {sorted(report)}", flush=True)

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
    path = build.library_path()
    build.library()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                       build.build_log)]
    spills = re.findall(r"(\d+) bytes spill stores", build.build_log)
    print(f"build: {path.name} ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s; {len(regs)} kernels, at most "
          f"{max(regs, default=0)} registers a thread, "
          f"{sum(int(x) for x in spills)} bytes of spill stores)", flush=True)

    if args.tile_sweep:
        t0 = time.perf_counter()
        build.library(sweep=True)
        print(f"build: sweep library ({len(build.SWEEP_TILES)} tiles) ready "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        rows = tile_sweep(torch)
        if args.out:
            Path(args.out).write_text(json.dumps(rows, indent=1))
        return 0
    parity(torch)
    rows = timings(torch)
    print("kernels: widesa_mm (B1, widesa_mm.py mm_kernel -> cuda), bmm "
          "(B2, bmm.py bmm_kernel -> cuda); both in " + SOURCE, flush=True)
    torch.cuda.empty_cache()

    launches = serve(torch, name)

    summary = []
    for kname, k in KERNELS.items():
        row = rows[(k["kind"], k["shape"])]
        summary.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": k["replaces"], "launches": launches[kname],
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
