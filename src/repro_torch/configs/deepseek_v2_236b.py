"""deepseek-v2-236b [moe+mla]: 60L d=5120 128H, MLA kv_lora 512,
160 routed experts top-6 + 2 shared, expert ff 1536, vocab 102400.
[arXiv:2405.04434]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,          # dense ff of the first layer
    vocab=102400,
    moe_num_experts=160,
    moe_top_k=6,
    moe_shared_experts=2,
    moe_d_ff=1536,
    moe_first_dense=1,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    remat="full",
    logit_chunk=512,
    seq_parallel=True,  # §Perf memfit
    moe_ep=True,  # §Perf cell A1: 1.9x t_mem, dedup routing
    causal_block_skip=True,  # §Perf cell A2: ~halves attn flops
    grad_accum=8,  # §Perf memfit: 236B needs microbatching on 256 chips
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, seq_parallel=False, moe_ep=False,
    causal_block_skip=False, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=256,
    moe_d_ff=64, moe_num_experts=8, moe_top_k=2, moe_shared_experts=1,
    moe_first_dense=1, kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
    nope_head_dim=16, v_head_dim=16, vocab=256, dtype="float32",
    remat="none", logit_chunk=0,
)
