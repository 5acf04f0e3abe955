"""whisper-base [audio enc-dec]: 6L enc + 6L dec, d=512, 8H, ff 2048,
vocab 51865.  Frame embeddings come from the planned audio frontend
(``serve/frontend.py``).  [arXiv:2212.04356]"""

import dataclasses

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    is_encdec=True,
    enc_frames=1500,
    norm="layer",
    act="gelu",
    mlp_glu=False,
    use_rope=False,
    qkv_bias=True,
    max_positions=32768,
    remat="full",
    grad_accum=4,
)

SMOKE = dataclasses.replace(
    CONFIG, grad_accum=1, seq_parallel=False, moe_ep=False,
    causal_block_skip=False, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, enc_frames=32, max_positions=64, dtype="float32",
)
