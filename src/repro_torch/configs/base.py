"""Config schema: ModelConfig, a field-for-field copy of
``repro.configs.base.ModelConfig`` so configurations match the reference
(with its analytic ``param_count`` / ``active_param_count``), and the
reference's workload cells (``ShapeSpec``, ``SHAPES``, ``cells_for``:
``long_500k`` only for the sub-quadratic ``LONG_CONTEXT_ARCHS``)."""

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

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline accounting)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        def attn_params() -> int:
            if self.use_mla:
                qh = self.n_heads * (self.nope_head_dim + self.rope_head_dim)
                p = 0
                if self.q_lora_rank:
                    p += d * self.q_lora_rank + self.q_lora_rank * qh
                else:
                    p += d * qh
                p += d * (self.kv_lora_rank + self.rope_head_dim)
                p += self.kv_lora_rank * self.n_heads * (
                    self.nope_head_dim + self.v_head_dim)
                p += self.n_heads * self.v_head_dim * d
                return p
            hq = self.n_heads * self.hd
            hkv = self.n_kv_heads * self.hd
            return d * hq + 2 * d * hkv + hq * d

        def mlp_params(ff: int) -> int:
            return (3 if self.mlp_glu else 2) * d * ff

        def ssm_params() -> int:
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * ns + nh)
            conv = self.ssm_conv * (di + 2 * ns)
            out = di * d
            return in_proj + conv + out + 3 * nh + di

        if self.family in ("dense", "vlm"):
            total += L * (attn_params() + mlp_params(self.d_ff) + 2 * d)
        elif self.family == "moe":
            n_moe = L - self.moe_first_dense
            total += L * (attn_params() + 2 * d)
            total += self.moe_first_dense * mlp_params(self.d_ff)
            per_moe = (
                self.moe_num_experts * mlp_params(self.moe_d_ff)
                + self.moe_shared_experts * mlp_params(self.moe_d_ff)
                + d * self.moe_num_experts  # router
            )
            total += n_moe * per_moe
        elif self.family == "ssm":
            total += L * (ssm_params() + d)
        elif self.family == "hybrid":
            total += L * (ssm_params() + d)
            # one shared attention+FFN block
            total += attn_params() + mlp_params(self.d_ff) + 2 * d
        elif self.family == "encdec":
            enc = self.n_enc_layers * (
                attn_params() + mlp_params(self.d_ff) + 2 * d)
            dec = L * (
                2 * attn_params() + mlp_params(self.d_ff) + 3 * d)
            total += enc + dec
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        n_moe = L - self.moe_first_dense
        full = self.param_count()
        inactive = n_moe * (
            (self.moe_num_experts - self.moe_top_k) * 3 * d * self.moe_d_ff
        )
        return full - inactive



@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One workload cell: (kind, seq_len, global_batch)."""

    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs allowed to run long_500k (sub-quadratic sequence mixing);
# all pure full-attention archs skip it, as in the reference
LONG_CONTEXT_ARCHS = {"mamba2-780m", "zamba2-1.2b"}


def cells_for(arch: str) -> list[str]:
    out = []
    for name in SHAPES:
        if name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
            continue
        out.append(name)
    return out
