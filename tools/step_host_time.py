#!/usr/bin/env python
"""Host time of one step on the card, for a checkout of the port given
by its ``src`` directory.

    python3 tools/step_host_time.py --src SRC [--src SRC2 ...] \
        [--step decode|whisper-train]

``decode`` (the default): one eager qwen1.5-0.5b decode step at its
published width (random weights, seed 0), 4 lanes, a cache of 128
positions, the same step as ``chip_smoke.py``'s eager profile line,
called directly through ``api.decode``.  ``whisper-train``: one
whisper-base training step at its published width, bf16, remat full, 4
utterances of 1500 frames and 64 text tokens, grad_accum 1 (the batch
of ``chip_smoke.py``'s whisper_train phase), through the ``Trainer``'s
step function, the loss read back each step.  Each ``--src`` runs in a
process of its own (its kernels built from its own checkout), in the
order given, so two versions are compared inside one call: ``--src
parent/src --src src --src src --src parent/src``.  Prints one JSON line
a run (host ms of each timed step, their median and minimum, the GEMM
wrappers' launches a step by kernel) and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time

LANES, MAX_SEQ = 4, 128
#: warm and timed steps of each kind
STEPS = {"decode": (5, 50), "whisper-train": (2, 10)}
#: whisper-base's training batch: text tokens, utterances
TRAIN_SEQ, TRAIN_BATCH = 64, 4


def decode_step(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    api = build_model(get_config("qwen1.5-0.5b"), device="cuda")
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    cache = api.init_cache(LANES, MAX_SEQ)
    tokens = torch.zeros((LANES, 1), dtype=torch.int32, device="cuda")

    def step(i):
        with torch.no_grad():
            api.decode(params, cache, tokens)
        torch.cuda.synchronize()

    return step


def train_step(torch, ckpt: str):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import batch_tensors

    cfg = dataclasses.replace(get_config("whisper-base"), grad_accum=1)
    trainer = Trainer(cfg, ShapeSpec("card", "train", TRAIN_SEQ, TRAIN_BATCH),
                      ckpt_dir=ckpt, tcfg=TrainConfig(total_steps=100),
                      device="cuda")
    state = list(trainer.init_state())
    batch = batch_tensors(trainer.data.batch(0), "cuda")

    def step(i):
        params, opt, metrics = trainer.step_fn(state[0], state[1], batch, i)
        float(metrics["loss"])
        state[:2] = params, opt

    return step


def one(src: str, kind: str) -> dict:
    sys.path.insert(0, src)
    import torch

    from repro_torch.kernels import bmm, widesa_mm

    with tempfile.TemporaryDirectory(dir=src) as ckpt:
        step = decode_step(torch) if kind == "decode" \
            else train_step(torch, ckpt)
        warm, runs = STEPS[kind]
        for i in range(warm):
            step(i)
        torch.cuda.synchronize()
        before = {w: dict(mod.variants) for w, mod in
                  (("widesa_mm", widesa_mm), ("bmm", bmm))}
        walls = []
        for i in range(runs):
            t0 = time.perf_counter()
            step(warm + i)
            walls.append((time.perf_counter() - t0) * 1e3)
    launches = {w: {v: (mod.variants[v] - before[w][v]) / runs
                    for v in mod.variants if mod.variants[v] - before[w][v]}
                for w, mod in (("widesa_mm", widesa_mm), ("bmm", bmm))}
    return {"src": src, "step": kind, "host_ms": walls,
            "median_ms": statistics.median(walls), "min_ms": min(walls),
            "gemm_launches_a_step": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--step", choices=sorted(STEPS), default="decode")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(one(args.src[0], args.step)), flush=True)
        return 0
    for src in args.src:
        out = subprocess.run([sys.executable, __file__, "--child", "--src",
                              src, "--step", args.step], capture_output=True,
                             text=True, timeout=900)
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
