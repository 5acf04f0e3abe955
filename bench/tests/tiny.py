"""Tiny cells for the CPU tests: a real cell of BENCHMARK.json with its
configuration cut to a toy size and its traffic to a few short requests,
driven on the CPU by the same drivers (the port runs its plain versions
there)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import harness  # noqa: E402

harness.set_cache_dirs()

TINY_MOE = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
            "d_ff": 128, "moe_d_ff": 128, "moe_num_experts": 8,
            "moe_top_k": 2, "vocab": 256, "dtype": "float32",
            "kv_cache_dtype": "float32", "remat": "none"}
TINY_DENSE = {"n_layers": 2, "d_model": 64, "n_heads": 8, "n_kv_heads": 2,
              "d_ff": 128, "vocab": 256, "dtype": "float32",
              "kv_cache_dtype": "float32", "remat": "none"}


def tiny_cell(name: str, capacity_factor=None) -> dict:
    cell = copy.deepcopy(harness.cell(name))
    port = cell["config"]["port"]
    port.update(TINY_MOE if port.get("moe_num_experts") else TINY_DENSE)
    if capacity_factor is not None:
        port["moe_capacity_factor"] = capacity_factor
    elif port.get("moe_num_experts") and port["moe_capacity_factor"] > 2:
        # dropless: an expert holds every token (experts / top_k)
        port["moe_capacity_factor"] = port["moe_num_experts"] / port["moe_top_k"]
    tr = cell["traffic"]
    if tr["kind"] == "train":
        tr.update(batch=2, seq=16)
    else:
        tr.update(block=8, trace_steps=3)
        tr["prompt"] = {"dist": "lognormal", "median": 12, "sigma": 0.5,
                        "min": 4, "max": 24}
        tr["output"] = {"dist": "lognormal", "median": 6, "sigma": 0.5,
                        "min": 4, "max": 12}
        tr["engine"] = {"kind": "paged", "max_lanes": 4, "block_size": 8,
                        "max_seq": 40}
        tr["check"] = {"served_tokens": 30, "max_requests": 4}
        if tr["kind"] == "open":
            tr.update(rate_per_s=40.0, lead_in_s=0.3)
        else:
            tr["lead_in_max_s"] = 1.0
    return cell


def run_tiny(name: str, seed: int = 5, seconds: float = 1.0, fault=None,
             **kw):
    import torch

    import run

    cell = tiny_cell(name, **kw)
    ctx = run.Context(torch, cell, seed, seconds, False, device="cpu",
                      fault=fault)
    rec = run.measure(ctx)
    out = run.result(ctx, rec, {"platform": "cpu"})
    return rec, out
