"""stablelm-12b [dense]: 40L d=5120 32H GQA kv=8, ff 13824, vocab 100352.
[hf:stabilityai/stablelm-2-12b]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    remat="full",
    seq_parallel=True,  # §Perf memfit
    grad_accum=2,  # §Perf memfit
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, seq_parallel=False, moe_ep=False,
    causal_block_skip=False, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    vocab=256, dtype="float32", remat="none",
)
