"""codeqwen1.5-7b [dense]: 32L d=4096 32H, ff 13440, vocab 92416,
QKV bias (qwen1.5 arch).  [hf:Qwen/CodeQwen1.5-7B]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    remat="full",
    seq_parallel=True,  # §Perf memfit
    kv_cache_dtype="float8_e4m3fn",  # §Perf cell C: 1.6x t_mem
)

SMOKE = dataclasses.replace(
    CONFIG, seq_parallel=False, moe_ep=False,
    causal_block_skip=False, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, dtype="float32", remat="none",
)
