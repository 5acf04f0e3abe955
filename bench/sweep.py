"""Find an open-loop cell's knee on the card: the highest offered rate at
which the queue at the end of a run is no longer than at its first
quarter.

    python3 bench/sweep.py --workload olmoe-chat --rates 1.5,2,2.5,3 \
        --seconds 40 [--seed 1]

One process loads the cell's engine once (``serving.setup``) and offers
each rate in turn for ``--seconds`` from an empty engine, with the
traffic's own lengths and gaps scaled to the rate.  It prints a line a
rate (queue at the first quarter and at the end, requests sent and
answered, TTFT and TPOT percentiles) and the knee; the traffic file's
``rate_per_s`` is then set by hand to 0.8 of it.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import harness

harness.set_cache_dirs()

import run  # noqa: E402
import serving  # noqa: E402
import traffic as T  # noqa: E402
from stats import percentile  # noqa: E402


def offer(ctx, eng, tr, rate: float, seconds: float, seed: int) -> dict:
    """One rate for ``seconds``: the queue waiting in the engine at the
    first quarter and at the end, and the latencies of what was due."""
    tr = dict(tr, rate_per_s=rate)
    n = int(seconds * rate * 1.5) + tr["block"]
    reqs = collections.deque(T.requests(tr, seed, ctx.cell["config"]["port"]
                                        ["vocab"], n))
    live, recs = {}, []
    t0 = time.perf_counter()
    q_quarter = None
    while True:
        t = time.perf_counter() - t0
        if t >= seconds:
            break
        if q_quarter is None and t >= seconds / 4:
            q_quarter = len(eng.queue)
        while reqs and reqs[0].due <= t:
            r = reqs.popleft()
            eng.submit(r.prompt, r.max_new)
            rec = {"due": r.due, "first": None, "last": None, "n": 0,
                   "done": None}
            live[id(eng.queue[-1])] = (eng.queue[-1], rec)
            recs.append(rec)
        if not eng.queue and all(x is None for x in eng.lanes):
            time.sleep(max(0.0, min(reqs[0].due if reqs else seconds,
                                    seconds) - (time.perf_counter() - t0)))
            continue
        eng.step()
        s = time.perf_counter() - t0
        for k in list(live):
            ereq, rec = live[k]
            if len(ereq.output) > rec["n"]:
                if rec["n"] == 0:
                    rec["first"] = s
                rec["n"], rec["last"] = len(ereq.output), s
            if ereq.done:
                rec["done"] = s
                del live[k]
    q_end = len(eng.queue)
    ttft = [(r["first"] if r["first"] is not None else seconds) - r["due"]
            for r in recs]
    tpot = [(r["last"] - r["first"]) / (r["n"] - 1) for r in recs
            if r["done"] is not None and r["n"] > 1]
    eng.queue.clear()
    eng.run_until_drained(max_steps=100000)
    eng.finished.clear()
    return {"rate": rate, "queue_quarter": q_quarter, "queue_end": q_end,
            "sent": len(recs), "done": len(tpot),
            "ttft_p50_ms": percentile(ttft, 50) * 1e3,
            "ttft_p95_ms": percentile(ttft, 95) * 1e3,
            "tpot_p50_ms": (percentile(tpot, 50) or 0) * 1e3,
            "tpot_p95_ms": (percentile(tpot, 95) or 0) * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    ctx = run.Context(torch, cell, args.seed, args.seconds, False)
    st = serving.setup(ctx)
    info = harness.device_info(torch)
    print(json.dumps({"card": info}), flush=True)
    rows = []
    for rate in (float(x) for x in args.rates.split(",")):
        row = offer(ctx, st["eng"], st["traffic"], rate, args.seconds,
                    args.seed)
        rows.append(row)
        print(json.dumps(row), flush=True)
    ok = [r["rate"] for r in rows if r["queue_end"] <= r["queue_quarter"]]
    print(json.dumps({"knee": max(ok) if ok else None,
                      "rate_at_0.8": 0.8 * max(ok) if ok else None}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
