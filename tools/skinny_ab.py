#!/usr/bin/env python
"""The skinny GEMM kernel's device time at serving shapes, for a
checkout of the port given by its ``src`` directory, so that two
versions are compared inside one call on the card.

    python3 tools/skinny_ab.py --src parent/src --src src --src src \\
        --src parent/src

Each ``--src`` runs in a process of its own (its kernels built from its
own checkout, into that checkout's ``build/``), in the order given.  The
shapes: the untied lm_heads at decode (qwen3-32b, deepseek-v2,
codeqwen1.5-7b, B row-major), deepseek-v2's expert stack at decode,
qwen1.5-0.5b's tied lm_head (B column-major), qwen3-32b's MLP at decode
and its down projection of a 16-token prompt, deepseek-v2's MLA
projections at decode (q_up: 768 blocks; k_rope), and small decode
products (qwen's gate/up, whisper's projections, the MoE router in
float32, the attention scores and values).  Each on the runtime's
configuration of that checkout: CUDA events over 20 calls after 3 (the
host's launch rate below ~0.05 ms), and ``torch.profiler``'s device time
of the skinny kernel's records over the same calls (``<shape> device``);
and, where the run compiled its checkout's kernels, the registers ptxas
gave each skinny instantiation (``registers``, by its mangled template
arguments: they bound the blocks an SM holds).  Prints the card's name
and power limit, then one JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys

SHAPES = (("mm", (4, 151936, 5120), False, "bfloat16"),
          ("mm", (4, 102400, 5120), False, "bfloat16"),
          ("mm", (4, 92416, 4096), False, "bfloat16"),
          ("bmm", (160, 1, 1536, 5120), False, "bfloat16"),
          ("mm", (4, 151936, 1024), True, "bfloat16"),
          ("mm", (4, 5120, 25600), False, "bfloat16"),
          ("mm", (16, 5120, 25600), False, "bfloat16"),
          ("mm", (4, 25600, 5120), False, "bfloat16"),
          ("mm", (4, 24576, 1536), False, "bfloat16"),
          ("mm", (4, 64, 5120), False, "bfloat16"),
          ("mm", (4, 2816, 1024), False, "bfloat16"),
          ("mm", (4, 512, 512), False, "bfloat16"),
          ("mm", (4, 64, 2048), False, "float32"),
          ("bmm", (64, 1, 528, 64), True, "bfloat16"),
          ("bmm", (64, 1, 64, 8448), False, "bfloat16"))


def one(src: str) -> dict:
    sys.path.insert(0, src)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import bmm, build, runtime, widesa_mm

    gen = torch.Generator(device="cuda").manual_seed(0)
    row = {"src": src}
    for kind, shape, col, dname in SHAPES:
        dtype = getattr(torch, dname)
        *z, m, n, k = shape
        a = torch.randn((*z, m, k), generator=gen, device="cuda").to(dtype)
        b = torch.randn((*z, n, k) if col else (*z, k, n), generator=gen,
                        device="cuda").to(dtype)
        if col:
            b = b.transpose(-1, -2)
        fn = widesa_mm.matmul if kind == "mm" else bmm.bmm
        tile = runtime.gemm_tile(a, b, (4, 32, 32))
        for _ in range(3):
            fn(a, b, tiles=tile)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn(a, b, tiles=tile)
        end.record()
        torch.cuda.synchronize()
        row[f"{kind}{shape}"] = start.elapsed_time(end) / 20
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn(a, b, tiles=tile)
            torch.cuda.synchronize()
        records = [(e.self_device_time_total, e.count)
                   for e in prof.key_averages() if "skinny_kernel" in e.key]
        row[f"{kind}{shape} device"] = (
            sum(us for us, _ in records) / sum(n for _, n in records) / 1e3
            if records else None)
    row["registers"] = dict(re.findall(
        r"skinny_kernelI(\w+?)EEv\w*' for \S+\nptxas info\s*: Function "
        r"properties[^\n]*\n[^\n]*\nptxas info\s*: Used (\d+) registers",
        build.build_log))
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", action="append", required=True)
    parser.add_argument("--one", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        print(json.dumps(one(args.one)), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    for src in args.src:
        done = subprocess.run([sys.executable, __file__, "--src", src,
                               "--one", src])
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
