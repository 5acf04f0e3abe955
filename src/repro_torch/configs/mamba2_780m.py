"""mamba2-780m [ssm]: 48L d=1536 attn-free, vocab 50280, state 128.
[arXiv:2405.21060]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_conv=4,
    attn_every=0,
    remat="full",
    fsdp=False,  # §Perf cell B: FSDP on sub-2B models costs activation
    # redistribution (a2a) far exceeding the weight traffic it saves
    seq_parallel=True,  # §Perf memfit
    grad_accum=2,  # §Perf memfit (SSD chunk intermediates)
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, seq_parallel=False, moe_ep=False,
    causal_block_skip=False, n_layers=2, d_model=64, vocab=256, ssm_state=16,
    ssm_headdim=16, ssm_chunk=8, dtype="float32",
)
