"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``; its traffic's
``kind`` names the driver (``drivers/<kind>.py``).  With ``--trace 0``
the line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics (one short traced sub-window once the window has
closed).  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, and with a trace
``breakdown``; the numbers compared for ``correct`` come last, under
``checks``); the same numbers end standard error.  It exits non-zero,
printing no result, without a CUDA card, with fewer cards than the cell
asks for, or when the JAX package or JAX is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import harness  # noqa: E402
import trace  # noqa: E402

harness.set_cache_dirs()


class Context:
    """What a driver is given: the cell, the seed and the window's
    length, the device, and the run's clocks and notes."""

    def __init__(self, torch, cell, seed, seconds, trace, device="cuda",
                 fault=None, control=False):
        self.torch, self.cell, self.seed = torch, cell, seed
        self.seconds, self.trace, self.device = seconds, trace, device
        # a fault planted in the timed path, and whether to read the
        # control too (``control.py``; the benchmark's own runs do neither)
        self.fault, self.control = fault, control
        self.result_extra: dict = {}
        self.setup_s = None

    def note(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def setup_end(self, t: float) -> float:
        """Set-up's length: process start to ``t`` (the window's start)."""
        self.setup_s = t - T_START
        return self.setup_s

    def steady(self) -> None:
        """Before the window: one CPU thread for torch, and every object
        set-up made moved out of the garbage collector's reach, so that
        collections in the window walk only what the window makes."""
        self.torch.set_num_threads(1)
        gc.collect()
        gc.freeze()

    def release(self) -> None:
        """After the window: collect what the program dropped (set-up's
        objects too) and hand the card's cached blocks back, so that the
        reference finds the memory the program held."""
        gc.unfreeze()
        gc.collect()
        if self.device != "cpu":
            self.torch.cuda.empty_cache()

    def memory_peak(self) -> int:
        if self.device == "cpu":
            return 0
        return int(self.torch.cuda.max_memory_allocated())


def measure(ctx) -> dict:
    """The driver's record of one run of the cell."""
    return harness.driver(ctx.cell["traffic"]["kind"]).run(ctx)


def result(ctx, rec: dict, device: dict) -> dict:
    """The result line: the metrics the cell reports under this mode, read
    from the run's record by their readers."""
    metrics = {}
    for m in ctx.cell["per_layer" if ctx.trace else "end_to_end"]:
        value = harness.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = rec["checks"]
    out = {"correct": bool(checks) and all(c["ok"] for c in checks),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    if ctx.trace and rec.get("trace"):
        t = rec["trace"]
        out["device"] = dict(device, busy_s=t["busy_s"],
                             window_s=t["window_s"])
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    ctx = Context(torch, cell, args.seed, args.seconds, bool(args.trace))
    info = harness.device_info(torch)
    rec = measure(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": info["kind"],
              "count": cell["chips"],
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = result(ctx, rec, device)
    notes = {"card": info, "setup_s": rec["setup_s"], **rec.get("notes", {}),
             **{k: rec[k] for k in ("attempted", "plan_misses", "steps")
                if k in rec and not isinstance(rec[k], list)}}
    if rec.get("trace"):
        g = rec["trace"]["gemm"]
        notes["gemm_launches"] = {"trace": rec["trace"]["gemm_records"],
                                  "shapes": g["launches"],
                                  "tries": rec["trace"].get("tries")}
        if not trace.complete(rec["trace"]):
            notes["trace_incomplete"] = trace.shortfall(rec["trace"])
    if "readings" in ctx.result_extra:
        notes["readings"] = ctx.result_extra["readings"]
    print(json.dumps(notes), file=sys.stderr)
    for c in rec["checks"]:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}"
              f"{' at ' + c['where'] if c.get('where') else ''}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
