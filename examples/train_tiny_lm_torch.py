"""End-to-end driver of the PyTorch port: train a ~100M-parameter
qwen-style LM (the port's counterpart of ``examples/train_tiny_lm.py``).

Exercises the port's training stack: the synthetic data pipeline, the
model on the planned facade (every GEMM on the hand kernels on the card,
in both directions), AdamW, asynchronous atomic checkpoints, restart
(``resume=True``: a second run given the same ``--ckpt`` trains
``--steps`` more from its latest checkpoint) and the straggler watchdog.
The loss decreases on the synthetic Markov stream.

    PYTHONPATH=src python examples/train_tiny_lm_torch.py [--steps 300] \
        [--ckpt DIR] [--device cpu]

It runs on the card unless ``--device cpu`` is given (the plain PyTorch
versions there).  Without ``--ckpt`` each run checkpoints into a fresh
temporary directory.
"""

import argparse
import dataclasses
import subprocess
import tempfile
import time

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.train import TrainConfig, Trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a fresh one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="widesa_tiny_lm_torch_")

    # ~100M params: qwen1.5-0.5b shrunk, its QKV bias and tied embeddings
    # kept (the reference example's configuration)
    cfg = dataclasses.replace(
        get_config("qwen1.5-0.5b"), n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=2304, vocab=32000, remat="none",
        dtype="float32")
    shape = ShapeSpec("tiny", "train", seq_len=128, global_batch=4)
    tcfg = TrainConfig(base_lr=3e-4, warmup=20, total_steps=args.steps,
                       ckpt_every=100, log_every=10)
    trainer = Trainer(cfg, shape, ckpt_dir=ckpt, tcfg=tcfg,
                      device=args.device)
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(f"device: {card}")
    trainer.install_signal_handlers()
    t0 = time.perf_counter()
    params, _, hist = trainer.run(args.steps, resume=True)
    wall = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"model: {n_params / 1e6:.1f}M params on {args.device}")

    first = sum(hist[:10]) / max(len(hist[:10]), 1)
    last = sum(hist[-10:]) / max(len(hist[-10:]), 1)
    print(f"\nloss: first-10 avg {first:.4f} -> last-10 avg {last:.4f}")
    print(f"{len(hist)} steps in {wall:.1f} s "
          f"({wall / max(len(hist), 1) * 1e3:.1f} ms a step, checkpoints "
          f"included)")
    print(f"straggler events: {trainer.straggler_events}")
    if not last < first:
        raise SystemExit("loss must decrease")
    print("OK")


if __name__ == "__main__":
    main()
