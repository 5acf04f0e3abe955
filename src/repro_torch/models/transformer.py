"""Decoder-only LM of the dense and MoE families (the port of
``repro.models.transformer`` without MLA).

Parameters are a plain dict: ``embed`` [V, d], ``ln_f``, a ``layers``
list of per-layer dicts (the reference stacks them along a leading L axis
in two groups, ``dense_layers`` and ``moe_layers``, and runs
``lax.scan`` over each; a Python loop over the dense layers, then the MoE
ones, takes its place here) and, for untied heads, ``lm_head`` [d, V].
A dense layer holds ``mlp``, an MoE layer ``moe`` (``models/moe.py``);
an MoE config starts with ``moe_first_dense`` dense layers
(``layer_split``).  ``convert.params_from_jax`` turns the reference's
tree into this form.

The serving cache is ``{"k", "v": [L, B, S, Hkv, hd], "pos": [B] int32}``
and ``decode_step`` updates it in place.  The block-paged engine's pools
are ``{"k", "v": [L, NB + 1, bs, Hkv, hd]}`` (``init_paged_pools``; the
last block is the sink of inactive lanes' writes) and
``decode_step_paged`` writes them in place through per-lane block
tables.

Training: ``loss_fn`` is the reference's masked next-token cross-entropy
(``logit_chunk`` chunks the lm_head and the loss over the sequence) for
the dense family; with ``cfg.remat == "full"`` and grad enabled,
``forward`` runs each layer under ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint`` around its scanned block.  Serving runs
under ``no_grad`` and never takes that path.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.planned import planned_dense

from . import layers as L
from . import moe as MOE

CACHE_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def cache_dtype_of(cfg) -> torch.dtype:
    return CACHE_DTYPES[cfg.kv_cache_dtype]


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe") or cfg.use_mla:
        raise NotImplementedError(
            f"family {cfg.family!r}{' with MLA' if cfg.use_mla else ''} is "
            "not ported; the port runs dense and MoE decoders with GQA "
            "attention")


def layer_split(cfg) -> tuple[int, int]:
    """(dense layers, MoE layers): an MoE config's ``moe_first_dense``
    dense layers come first."""
    if cfg.family == "moe":
        return cfg.moe_first_dense, cfg.n_layers - cfg.moe_first_dense
    return cfg.n_layers, 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random weights at the config's full width, drawn on ``device``
    from ``generator`` with the reference's scales: N(0, 1/d_in) dense
    kernels, N(0, 0.02) embeddings, zero biases, unit norm gains; an MoE
    layer's block from ``moe.init_moe``."""
    _check_family(cfg)
    dt = L.compute_dtype(cfg)
    n_dense, _ = layer_split(cfg)
    layers = []
    for i in range(cfg.n_layers):
        layer = {"ln1": L.init_norm(cfg, device),
                 "attn": L.init_attention(cfg, generator, device),
                 "ln2": L.init_norm(cfg, device)}
        if i < n_dense:
            layer["mlp"] = L.init_glu_mlp(cfg, generator, device)
        else:
            layer["moe"] = MOE.init_moe(cfg, generator, device)
        layers.append(layer)
    p = {"embed": L.normal(generator, (cfg.vocab, cfg.d_model), 0.02, dt,
                           device),
         "ln_f": L.init_norm(cfg, device), "layers": layers}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab, dt,
                                    device)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(p, cfg, tokens):
    """tokens [B, S] -> [B, S, d]."""
    return p["embed"][tokens.long()].to(L.compute_dtype(cfg))


def _ffn(lp, cfg, x):
    """The layer's feed-forward half on its pre-norm input: the MLP of a
    dense layer, the expert block of an MoE one (at decode every lane
    routes, inactive ones too, as in the reference)."""
    if "moe" in lp:
        return MOE.apply_moe(lp["moe"], cfg, x)
    return L.apply_mlp(lp["mlp"], cfg, x)


def _block(lp, cfg, x, positions):
    """One layer over a whole sequence: (x', k, v)."""
    attn, k, v = L.apply_attention(lp["attn"], cfg,
                                   L.apply_norm(lp["ln1"], cfg, x), positions)
    x = x + attn
    x = x + _ffn(lp, cfg, L.apply_norm(lp["ln2"], cfg, x))
    return x, k, v


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def remat(cfg) -> bool:
    """Whether a layer's activations are recomputed in the backward pass
    (``cfg.remat == "full"`` while grad is enabled)."""
    if not torch.is_grad_enabled() or cfg.remat == "none":
        return False
    if cfg.remat != "full":
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported (ROADMAP A8); the port "
            "recomputes whole layers (remat='full') or none")
    return True


def run_layers(cfg, layer, x, stack):
    """``x`` through ``layer(x, lp)`` for each layer's parameters in
    ``stack``, each under ``torch.utils.checkpoint`` where ``remat``
    says."""
    full = remat(cfg)
    for lp in stack:
        x = (checkpoint(layer, x, lp, use_reentrant=False) if full
             else layer(x, lp))
    return x


def forward(p, cfg, tokens):
    """Full-sequence forward -> final-norm hidden states [B, S, d]."""
    _check_family(cfg)
    x = embed_tokens(p, cfg, tokens)
    positions = _positions(x)
    x = run_layers(cfg, lambda x, lp: _block(lp, cfg, x, positions)[0], x,
                   p["layers"])
    return L.apply_norm(p["ln_f"], cfg, x)


def logits_fn(p, cfg, hidden):
    """[..., d] -> [..., V].  The tied head reads the embedding table as
    a transposed [d, V] operand; no copy is made."""
    head = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
    return planned_dense(hidden, head.to(hidden.dtype), site="lm_head")


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------

def xent(logits, labels):
    """Per-position cross-entropy of fp32 logits against labels."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    return lse - picked


def loss_fn(p, cfg, batch):
    """batch: tokens [B, S], labels [B, S] (the next token; a label < 0 is
    masked).  The mean cross-entropy over the unmasked positions, plus
    ``1e-2 * aux`` (0 for the dense family).  With ``cfg.logit_chunk``
    below S, the lm_head and the loss run over chunks of that many
    positions, so the [B, S, V] logits never exist at once."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training of the {cfg.family!r} family is not ported (ROADMAP "
            "A8: the MoE family needs load_balance_loss and its aux term)")
    tokens, labels = batch["tokens"], batch["labels"]
    hidden = forward(p, cfg, tokens)
    lbl = labels.clamp(min=0).long()
    mask = (labels >= 0).float()
    chunk = cfg.logit_chunk
    if chunk and hidden.shape[1] > chunk:
        b, s, d = hidden.shape
        hs = hidden.reshape(b, s // chunk, chunk, d)
        ls = lbl.reshape(b, s // chunk, chunk)
        ms = mask.reshape(b, s // chunk, chunk)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(s // chunk):
            lg = logits_fn(p, cfg, hs[:, c])
            total = total + (xent(lg, ls[:, c]) * ms[:, c]).sum()
    else:
        total = (xent(logits_fn(p, cfg, hidden), lbl) * mask).sum()
    aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    return total / torch.clamp(mask.sum(), min=1.0) + 1e-2 * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device="cuda"):
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def prefill(p, cfg, tokens, max_seq, cache_dtype=torch.bfloat16,
            last_index=None):
    """Run the whole prompt, build its cache, return last-token logits:
    (logits [B, V], cache with ``pos`` = prompt length).

    ``last_index`` ([B] int32, optional) supports *bucketed* prefill:
    ``tokens`` may be right-padded to a bucket length and logits are then
    taken at each lane's last valid token instead of position -1, with
    ``cache["pos"]`` set past it.  Pad rows land in the cache but the
    decode mask (``kpos <= pos``) hides them until overwritten."""
    _check_family(cfg)
    b, s = tokens.shape
    x = embed_tokens(p, cfg, tokens)
    positions = _positions(x)
    cache = init_cache(cfg, b, max_seq, cache_dtype, x.device)
    for i, lp in enumerate(p["layers"]):
        x, k, v = _block(lp, cfg, x, positions)
        cache["k"][i, :, :s] = k.to(cache_dtype)
        cache["v"][i, :, :s] = v.to(cache_dtype)
    x = L.apply_norm(p["ln_f"], cfg, x)
    sel, pos = L.last_rows(x, last_index)
    logits = logits_fn(p, cfg, sel)[:, 0]
    cache["pos"].copy_(pos)
    return logits, cache


def decode_step(p, cfg, cache, tokens):
    """tokens [B, 1] -> (logits [B, V], cache).  The cache is updated in
    place — each layer writes its new K/V row, then ``pos`` advances —
    and returned for symmetry with the reference."""
    pos = cache["pos"]
    x = embed_tokens(p, cfg, tokens)
    for i, lp in enumerate(p["layers"]):
        h = L.apply_norm(lp["ln1"], cfg, x)
        x = x + L.apply_attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                         cache["v"][i], pos)
        x = x + _ffn(lp, cfg, L.apply_norm(lp["ln2"], cfg, x))
    x = L.apply_norm(p["ln_f"], cfg, x)
    logits = logits_fn(p, cfg, x)[:, 0]
    pos += 1
    return logits, cache


# ---------------------------------------------------------------------------
# block-paged serving
# ---------------------------------------------------------------------------

def paged_layout(cfg) -> dict:
    """Leaf kinds for the block-paged serving cache: ``paged`` leaves are
    [L, NB, bs, ...] block pools indexed per-lane through block tables;
    there are no per-lane leaves for this family."""
    del cfg
    return {"k": "paged", "v": "paged"}


def init_paged_pools(cfg, num_blocks, block_size, max_lanes,
                     dtype=torch.bfloat16, device="cuda"):
    del max_lanes  # no per-lane state in this family
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step_paged(p, cfg, pools, tokens, block_tables, pos, active):
    """Block-paged decode: tokens [B,1]; block_tables [B,T] int32; pos
    [B] int32; active [B] bool -> (logits [B,V], pools), the pools
    written in place (each layer's new K/V row; an inactive lane's to the
    sink block).

    ``pos``/tables/``active`` are host-owned inputs that the step never
    changes (the engine advances pos and edits tables between steps), so
    the step's shapes never depend on which requests are in flight."""
    x = embed_tokens(p, cfg, tokens)
    for i, lp in enumerate(p["layers"]):
        h = L.apply_norm(lp["ln1"], cfg, x)
        x = x + L.apply_attention_decode_paged(
            lp["attn"], cfg, h, pools["k"][i], pools["v"][i], block_tables,
            pos, active)
        x = x + _ffn(lp, cfg, L.apply_norm(lp["ln2"], cfg, x))
    x = L.apply_norm(p["ln_f"], cfg, x)
    return logits_fn(p, cfg, x)[:, 0], pools
