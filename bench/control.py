"""Read a cell's numbers beside its control's, for setting its limits.

    python3 bench/control.py --workload <cell> --seed <n> --seconds <s> \
        [--fault half|unchanged|token]

One run of the cell as ``run.py`` makes it (a short window at the cell's
own load and sizes), then, on the same sample or the same steps, the
control: the reference computed with float8 operands in the program's
place.  With ``--fault`` the timed path is broken as named.  Prints one
JSON line: the cell's numbers and the control's.  The benchmark's own
runs never do this.
"""

from __future__ import annotations

import argparse
import json
import sys

import harness

harness.set_cache_dirs()

import run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.cell(args.workload)
    ctx = run.Context(torch, cell, args.seed, args.seconds, False,
                      fault=args.fault, control=args.fault is None)
    rec = run.measure(ctx)
    out = {"workload": args.workload, "seed": args.seed, "fault": args.fault,
           "numbers": {c["name"]: c["value"] for c in rec["checks"]},
           "control": rec.get("control") or ctx.result_extra.get("control")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
