#!/usr/bin/env python
"""Host time of one eager qwen1.5-0.5b decode step on the card, for a
checkout of the port given by its ``src`` directory.

    python3 tools/step_host_time.py --src SRC [--src SRC2 ...]

qwen1.5-0.5b at its published width (random weights, seed 0), 4 lanes,
a cache of 128 positions, the same step as ``chip_smoke.py``'s eager
profile line, called directly through ``api.decode``.  Each ``--src``
runs in a process of its own (its kernels built from its own checkout),
in the order given, so two versions are compared inside one call:
``--src parent/src --src src --src src --src parent/src``.  Prints one
JSON line a run (host ms of each timed step, their median and minimum,
the GEMM wrappers' launches a step) and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

LANES, MAX_SEQ = 4, 128
WARM, RUNS = 5, 50


def one(src: str) -> dict:
    sys.path.insert(0, src)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import bmm, widesa_mm
    from repro_torch.models.model import build_model

    api = build_model(get_config("qwen1.5-0.5b"), device="cuda")
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    cache = api.init_cache(LANES, MAX_SEQ)
    tokens = torch.zeros((LANES, 1), dtype=torch.int32, device="cuda")

    def step():
        with torch.no_grad():
            api.decode(params, cache, tokens)
        torch.cuda.synchronize()

    for _ in range(WARM):
        step()
    before = widesa_mm.launches + bmm.launches
    walls = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    return {"src": src, "host_ms": walls,
            "median_ms": statistics.median(walls), "min_ms": min(walls),
            "gemm_launches_a_step":
                (widesa_mm.launches + bmm.launches - before) / RUNS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(one(args.src[0])), flush=True)
        return 0
    for src in args.src:
        out = subprocess.run([sys.executable, __file__, "--child", "--src",
                              src], capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({k: v for k, v in row.items() if k != "host_ms"}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
