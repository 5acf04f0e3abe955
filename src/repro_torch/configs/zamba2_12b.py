"""zamba2-1.2b [hybrid]: 38 Mamba2 blocks (d=2048, state 64) + one shared
attention(32H)+FFN(8192) block applied every 6 SSM blocks (weight-shared;
per-invocation LoRA omitted — DESIGN.md §5), vocab 32000.
[arXiv:2411.15242]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_conv=4,
    attn_every=6,
    remat="full",
    fsdp=False,  # §Perf cell B: FSDP on sub-2B models costs activation
    # redistribution (a2a) far exceeding the weight traffic it saves
    seq_parallel=True,  # §Perf memfit
)

SMOKE = dataclasses.replace(
    CONFIG, seq_parallel=False, moe_ep=False,
    causal_block_skip=False, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, ssm_state=16, ssm_headdim=16, ssm_chunk=8, attn_every=2,
    dtype="float32",
)
