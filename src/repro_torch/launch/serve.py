"""Serving launcher CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --requests 8 --max-new 8 [--full] [--device cuda]

``--full`` serves the published full-width configuration instead of the
reduced smoke one; weights are drawn from a ``torch.Generator`` seeded
with 0 on ``--device``.  The slot engine is the only one ported so far.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--engine", default="slot", choices=["slot", "paged"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of the smoke config")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import planned
    from repro_torch.serve import make_engine

    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    eng = make_engine(cfg, kind=args.engine, max_slots=args.slots,
                      max_seq=args.max_seq, device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(0)
    eng.load(eng.api.init(gen))

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        plen = int(rng.integers(4, 16))
        eng.submit_text(rng.integers(0, cfg.vocab, plen),
                        max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s) on {eng.device}")
    print("planned GEMM call sites (site: planned/fallback calls, "
          "backends):")
    rows = planned.planned_report()
    for site, st in rows.items():
        mix = ",".join(f"{b}={n}" for b, n in sorted(st["backends"].items()))
        print(f"  {site}: {st['planned']}/{st['fallback']}  [{mix or '-'}]")
    if planned.planned_enabled() and not any(
            st["planned"] for st in rows.values()):
        raise SystemExit("serving executed no planned GEMMs")
    return done


if __name__ == "__main__":
    main()
