#!/usr/bin/env python
"""The dry-run grid as a Markdown table, one row an arch.

    python3 tools/dryrun_table.py results/dryrun_torch

Reads the cells' JSON that ``launch/dryrun.py`` (or ``chip_smoke.py
--dryrun``) wrote and prints one row an arch, its shapes one under
another in each column (``<br>``), each figure as "16x16 / 2x16x16"
where the two meshes differ: the accounting, argument bytes a device,
the global FLOPs and bytes, the ideal per-chip activation peak, ``fits``,
the binding roofline term with the three terms at 16x16 (the card's
published peaks, ``core/roofline.py``) and the GEMM launches by
kernel/variant.  A failed cell shows its error's first line.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import roofline as RL  # noqa: E402

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
GIB = 2**30


def both(one: dict, two: dict | None, fmt) -> str:
    a = fmt(one)
    if two is None or not two["ok"]:
        return f"{a} / failed"
    b = fmt(two)
    return a if a == b else f"{a} / {b}"


def terms(r: dict) -> tuple[str, float, float, float]:
    row = RL.analyze(arch=r["arch"], shape=r["shape"], mesh_name=r["mesh"],
                     chips=r["chips"],
                     cost={"flops": r["flops"],
                           "bytes accessed": r["bytes_accessed"]},
                     coll=r["coll"], model_flops=r["model_flops"])
    return (row.bottleneck, row.t_compute * 1e3, row.t_memory * 1e3,
            row.t_collective * 1e3)


def cell(one: dict, two: dict | None) -> list[str]:
    if not one["ok"]:
        err = one["error"].splitlines()[0][:100]
        both_failed = two is None or not two["ok"]
        return [f"failed{' (both meshes)' if both_failed else ''}: {err}"] \
            + [""] * 7
    bound, tc, tm, tl = terms(one)
    return [
        one["accounting"],
        both(one, two, lambda r: f"{r['memory']['argument_bytes'] / GIB:.3f}"),
        both(one, two, lambda r: f"{r['flops_global']:.4e}"),
        both(one, two, lambda r: f"{r['bytes_global']:.4e}"),
        both(one, two, lambda r: f"{r['memory']['temp_bytes'] / GIB:.2f}"),
        both(one, two, lambda r: "yes" if r["fits"] else "no"),
        f"{bound}: {tc:.2f} / {tm:.2f} / {tl:.2f}",
        ", ".join(f"{k} {v}" for k, v in sorted(one["kernels"].items())),
    ]


def main(argv: list[str]) -> int:
    cells: dict = defaultdict(dict)
    order: list[str] = []
    for path in sorted(glob.glob(os.path.join(argv[0], "*.json"))):
        with open(path) as f:
            r = json.load(f)
        cells[(r["arch"], r["shape"])][r["mesh"]] = r
        if r["arch"] not in order:
            order.append(r["arch"])
    from repro_torch.configs import ARCHS
    order.sort(key=lambda a: ARCHS.index(a) if a in ARCHS else len(ARCHS))
    print("| arch | shapes | acct. | args / dev GiB | FLOPs global | "
          "bytes global | peak / chip GiB | fits | bound (16x16: compute / "
          "memory / collective ms) | GEMM launches |")
    print("| --- " * 10 + "|")
    for arch in order:
        shapes = [s for s in SHAPES if (arch, s) in cells]
        cols = [cell(cells[(arch, s)]["16x16"], cells[(arch, s)].get("2x16x16"))
                for s in shapes]
        joined = ["<br>".join(c[i] or "—" for c in cols) for i in range(8)]
        print(f"| {arch} | {'<br>'.join(shapes)} | " + " | ".join(joined)
              + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
