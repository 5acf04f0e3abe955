"""qwen3-32b [dense]: 64L d=5120 64H GQA kv=8, ff 25600, vocab 151936,
qk_norm.  [hf:Qwen/Qwen3-32B]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    head_dim=128,
    remat="full",
    logit_chunk=512,
    seq_parallel=True,  # §Perf memfit: 16x smaller scan carry
    grad_accum=2,  # §Perf memfit
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, seq_parallel=False, moe_ep=False,
    causal_block_skip=False, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    head_dim=8, vocab=256, dtype="float32", remat="none", logit_chunk=0,
)
