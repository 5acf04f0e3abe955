"""Config schema: ModelConfig, a field-for-field copy of
``repro.configs.base.ModelConfig`` so configurations match the reference."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"
    norm: str = "rms"            # rms | layer
    mlp_glu: bool = True         # GLU (silu/gelu-glu) vs classic 2-matrix
    use_rope: bool = True        # rotary (False: learned/sinusoidal pos)
    dtype: str = "bfloat16"
    remat: str = "none"          # none | dots | full
    logit_chunk: int = 0         # chunked loss (0 = off)
    scan_unroll: bool = False    # unroll layer scans (exact HLO accounting)
    max_positions: int = 4096    # learned-pos table size (encdec)
    # --- perf levers (§Perf hillclimb) ---
    moe_ep: bool = False         # EP all-to-all MoE vs TP-MoE psum
    seq_parallel: bool = False   # Megatron-SP residual sharding
    causal_block_skip: bool = False  # triangular blockwise attention
    kv_cache_dtype: str = "bfloat16"  # decode cache storage dtype
    fsdp: bool = True            # shard weights over the data axis
    grad_accum: int = 1          # microbatched gradient accumulation
    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_first_dense: int = 0     # leading dense layers (deepseek: 1)
    moe_capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # --- hybrid (zamba2) ---
    attn_every: int = 0          # shared attn block every k SSM blocks
    # --- enc-dec (whisper) ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500       # stub frontend: precomputed frame embeds
    # --- vlm (llava) ---
    vlm_patches: int = 0         # stub frontend: patch embeds per image

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim
