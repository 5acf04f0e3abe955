"""llava-next-mistral-7b [vlm]: mistral-7b backbone (32L d=4096 32H GQA
kv=8, ff 14336, vocab 32000) + anyres patch frontend STUB (precomputed
patch embeddings, 576 base patches).  [hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    vlm_patches=576,
    rope_theta=1000000.0,
    remat="full",
    seq_parallel=True,  # §Perf memfit
)

SMOKE = dataclasses.replace(
    CONFIG, seq_parallel=False, moe_ep=False,
    causal_block_skip=False, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    vocab=256, vlm_patches=16, dtype="float32", remat="none",
)
