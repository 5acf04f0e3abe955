"""olmoe-1b-7b [moe]: 16L d=2048 16H, expert ff 1024, 64 experts top-8,
vocab 50304.  [arXiv:2409.02060]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    moe_num_experts=64,
    moe_top_k=8,
    moe_d_ff=1024,
    qk_norm=True,
    remat="full",
    seq_parallel=True,  # §Perf memfit
    grad_accum=2,  # §Perf memfit
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, seq_parallel=False, moe_ep=False,
    causal_block_skip=False, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    moe_d_ff=128, moe_num_experts=8, moe_top_k=2, vocab=256,
    dtype="float32",
)
