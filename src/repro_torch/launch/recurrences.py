"""The WideSA mapper -> kernel pipeline of the port, for every registered
recurrence: uniform recurrence -> space-time schedule -> partition -> PLIO
assignment -> ``ExecutionPlan`` -> kernel.

    PYTHONPATH=src python -m repro_torch.launch.recurrences \\
        [--device cuda|cpu] [--size bench|smoke]

The port's counterpart of ``examples/map_paper_benchmarks.py``,
``examples/quickstart.py`` and the execute step of
``benchmarks/bench_recurrences.py``, in three parts:

1. the Table II compiler report: ``best_plan`` on the VCK5000 target
   (``AIE_TARGET``) and ``predict_bounds`` for every ``PAPER_BENCHMARKS``
   entry (the target's model, in TOPS; no device runs);
2. quickstart's MM: float32 1024^3 planned on the 16 x 16 ``Target()``,
   run through ``lower_plan(plan, "pallas")`` and held against its plain
   version;
3. every registered recurrence, planned on the single-chip
   ``Target(mesh_shape=(1, 1))``, run through ``lower_plan(plan,
   "pallas")`` on operands drawn by ``registry.operands`` from a seeded
   generator, and held against its plain version.  As in the reference's
   quickstart and bench, the plan runs whatever its ``feasible`` reads:
   every single-chip plan of the stencils and mttkrp is infeasible on the
   modelled TPU, which says nothing of the card.

On ``cuda`` (the default) the plans run on the hand-written kernels.  The
stencils, mttkrp, mm, bmm, conv2d, fir and fft2d_stage run at their
registry ``bench_cases`` (``--size bench``, the default there:
paper-scale 10238^2 and 10236^2 grids, a 4094^2 grid for 8 sweeps, mttkrp
at (4096, 400, 256, 256), the paper's MM table (float32 8192^3, int8
10240^3, int16 9600^3, int32 8192^3), BMM table (64 x 4096^3 in float32,
int8 and int16), conv2d table (10240^2 outputs: float32, int16 and int32
with a 4 x 4 filter, int8 with an 8 x 8 one), FIR table (1048576 outputs
of 15 taps in float32, int8, int16 and cfloat) and fft2d_stage's "cfloat"
and "cint16" grids of 8192^2).  The cfloat FIR case runs as the
reference's ``execute_plan`` runs it: the cfloat plan on the float32
planes ``registry.operands`` draws, one real FIR launch (its line says
so); the complex arithmetic is
``fir.fir_complex``, which ``chip_smoke.py`` times.  Both packages'
registries draw fft2d_stage's two cases as two float32 planes, the
operands the port's kernel takes, so no complex lowering is missing; at
8192 rows, above the fused kernel's 64, they run the FFT kernel
(``csrc/widesa_fft.cu``: a row pass and a column pass of Stockham FFTs).
bmm's plain version runs one batch entry at a time (``BATCHED``): at 64
x 4096^3 a whole one would need ~70 GB of exact-integer temporaries.
``--device cpu`` runs the plain versions (the wrappers' CPU path) at
``smoke`` sizes.  Each recurrence case prints one line: the plan, the
compiled tile, the max error against its bound and the time.

Tolerances: integers are bit-exact (int32 wraparound).  Floats are held
to ``float_bound``: the registry's atol plus ``8 sqrt(n) u`` times the
root of the sum of the squared terms of each output (the plain version
on squared operands), where u = 2^-24 and n is the number of terms each
output sums.  The operands are zero-mean draws, and then the rounding
error of an fp32 sum grows like ``sqrt(n) u sqrt(sum t^2)``: a
sequential sum's rms error is at most ``u sqrt((n + 1) / 3)`` times
``sqrt(sum t^2)``, and the factor 8 covers the largest of up to 1.7e7
outputs (about 6 rms) with both sides rounding.  A bound on the sum of
the absolute terms instead would be ``sqrt(n)`` times looser: at the
bench sizes mttkrp sums 65536 products of three N(0, 1) draws, where
``sqrt(sum t^2)`` is ~256 and the bound ~0.03, below the ~0.1 rms error
of operands rounded to TF32.  The registry's atol (1e-3, meant for smoke
sizes) alone is below fp32's resolution there.  fft2d's
two planes keep the registry's atol 1.0 alone.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

#: the recurrences run at their bench cases on ``--size bench``; the rest
#: run at their smoke sizes (module docstring)
BENCH_SPECS = ("mm", "bmm", "conv2d", "fir", "fft2d_stage", "jacobi2d",
               "jacobi2d_9pt", "jacobi2d_ms", "mttkrp")
#: the recurrences whose operands and output lead with a batch dimension:
#: they are held to the plain version one batch entry at a time
BATCHED = ("bmm",)

#: timed calls of each case, after the one held against the plain version
TIMED_CALLS = 3

#: the unit roundoff of float32
U32 = 2.0 ** -24

#: the seed of the operands' generator
SEED = 0


def time_ms(fn, device, reps: int = 3) -> float:
    """Time of one call of ``fn``: CUDA events around ``reps`` calls on
    the card, the host clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def summed_terms(rec) -> int:
    """Terms each output of ``rec`` sums: the product of the extents of
    the loops its output access does not index (k for mm, p x q for
    conv2d, k x l for mttkrp, s x t for the multi-sweep stencil)."""
    out = next(a for a in rec.accesses if a.kind == "accum")
    indexed = {loop for loop, _ in out.index}
    return math.prod(rec.extent(loop) for loop in rec.loops
                     if loop not in indexed)


def float_bound(spec, rec, operands) -> torch.Tensor | float:
    """The float tolerance of ``spec``'s outputs on ``operands`` (module
    docstring): a tensor of per-output bounds, or the registry atol for
    a multi-plane output."""
    if spec.n_outputs > 1:
        return spec.atol
    rms = spec.ref(*(o * o for o in operands)).sqrt()
    return spec.atol + 8 * math.sqrt(summed_terms(rec)) * U32 * rms


def compare(spec, rec, operands, out, want) -> tuple[float, bool]:
    """(max |out - want|, whether every output is within tolerance):
    integers bit-exact, floats within ``float_bound``."""
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    exact = rec.dtype.startswith("int")
    bound = 0.0 if exact else float_bound(spec, rec, operands)
    err, ok = 0.0, True
    for o, w in zip(outs, wants):
        if o.shape != w.shape or o.dtype != w.dtype:
            return float("inf"), False
        diff = (o.double() - w.double()).abs()
        err = max(err, diff.max().item())
        ok = ok and bool((diff <= bound).all())
    return err, ok


def held(spec, rec, operands, out) -> tuple[float, bool]:
    """``compare`` of ``out`` against the plain version on ``operands``,
    batch entry by batch entry for the ``BATCHED`` recurrences (so that a
    bench case never holds more than one entry's plain temporaries)."""
    if spec.name not in BATCHED:
        return compare(spec, rec, operands, out, spec.ref(*operands))
    err, ok = 0.0, True
    for z in range(out.shape[0]):
        entry = tuple(o[z:z + 1] for o in operands)
        e, o = compare(spec, rec, entry, out[z:z + 1], spec.ref(*entry))
        err, ok = max(err, e), ok and o
    return err, ok


def compiler_report() -> None:
    """Part 1: the Table II designs on the VCK5000 target."""
    from repro_torch.core import AIE_TARGET, PAPER_BENCHMARKS, best_plan
    from repro_torch.core import predict_bounds

    for name, (builder, sizes) in PAPER_BENCHMARKS.items():
        for dtype, dims in sizes.items():
            rec = builder(*dims, dtype)
            plan = best_plan(rec, AIE_TARGET)
            bounds = predict_bounds(rec, plan.partition, AIE_TARGET)
            print(f"table2 {name:7s} {dtype:8s} {str(dims):28s} "
                  f"space={plan.schedule.space_loops} "
                  f"array={plan.partition.array_tiles} "
                  f"K2={plan.partition.thread_factor} "
                  f"util={plan.predicted_utilization:.3f} "
                  f"bound={bounds['array_level']:.2f} TOPS "
                  f"(VCK5000 model) feasible={plan.feasible}", flush=True)


def run_case(spec, rec, target, generator, device) -> dict:
    """Plan ``rec`` on ``target``, run the plan through ``lower_plan(plan,
    "pallas")`` on seeded operands and hold it against the plain
    version."""
    from repro_torch.core import best_plan, lower_plan
    from repro_torch.kernels import registry, runtime

    plan = best_plan(rec, target)
    ops = registry.operands(rec, generator, device)
    fn = lower_plan(plan, "pallas")
    runtime.last_tiles.pop(spec.name, None)
    out = fn(*ops)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    tiles = runtime.last_tiles.get(spec.name)
    err, ok = held(spec, rec, ops, out)
    ms = time_ms(lambda: fn(*ops), device, TIMED_CALLS)
    row = dict(name=spec.name, dtype=rec.dtype, args=rec.extents, rec=rec,
               block=dict(plan.partition.block), feasible=plan.feasible,
               tiles=tiles, max_abs_err=err, ok=ok, ms=ms)
    if tiles is None:
        compiled = "the plain version"
    elif spec.name == "fft2d_stage" and isinstance(tiles.tile,
                                                   runtime.FftTile):
        compiled = f"the FFT kernel's row and column passes on {tiles.tile}"
    elif spec.name == "fft2d_stage" and not isinstance(tiles.tile,
                                                       runtime.Fft2dTile):
        compiled = (f"the composition: six GEMMs a transform on the "
                    f"runtime's configuration (the tiled tile {tiles.tile} "
                    "its fallback)")
    else:
        compiled = f"compiled tile {tiles.tile}"
    if rec.dtype.startswith("c"):
        # as the reference's execute_plan: the plan on the float32 planes
        # registry.operands draws, not complex arithmetic
        compiled += (f" ({rec.dtype} plan on float32 planes"
                     + (": one real launch" if spec.name == "fir" else "")
                     + ", as the reference's execute_plan)")
    print(f"{spec.name:12s} {rec.dtype:8s} {str(rec.extents):26s} plan "
          f"block {row['block']} feasible={plan.feasible} -> {compiled}: "
          f"max |err| {err:.4g} ({'ok' if ok else 'MISMATCH'}), "
          f"{ms:.4f} ms", flush=True)
    del ops, out
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return row


def registry_cases(size: str):
    """(spec, dtype, builder args) of every registered recurrence at
    ``size`` (module docstring)."""
    from repro_torch.kernels import registry

    for spec in registry.specs():
        if size == "bench" and spec.name in BENCH_SPECS:
            yield from ((spec, dtype, args)
                        for dtype, args in spec.bench_cases)
        else:
            yield from ((spec, dtype, spec.smoke_args)
                        for dtype in spec.parity_dtypes)


def run(device: str = "cuda", size: str = "bench") -> list[dict]:
    """All three parts; returns the rows of parts 2 and 3 and raises if
    any result is outside its tolerance."""
    from repro_torch.core import Target, matmul
    from repro_torch.kernels import registry

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card (pass --device "
                           "cpu for the plain versions)")
    compiler_report()
    generator = torch.Generator(device=device).manual_seed(SEED)
    rows = [run_case(registry.get("mm"), matmul(1024, 1024, 1024, "float32"),
                     Target(), generator, device)]
    single_chip = Target(name="single_chip", mesh_shape=(1, 1))
    for spec, dtype, args in registry_cases(size):
        rows.append(run_case(spec, spec.builder(*args, dtype), single_chip,
                             generator, device))
    bad = [(r["name"], r["dtype"], r["args"]) for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"outside tolerance: {bad}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--size", choices=["bench", "smoke"],
                    help="bench (the default on cuda) or smoke (on cpu)")
    args = ap.parse_args(argv)
    size = args.size or ("bench" if args.device == "cuda" else "smoke")
    if args.device == "cpu" and size == "bench":
        ap.error("the bench sizes run on the card only")
    rows = run(args.device, size)
    print(f"recurrences: {len(rows)} cases on {args.device} ({size}) "
          "within tolerance")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
