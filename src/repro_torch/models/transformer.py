"""Decoder-only LM of the dense family (the port of the dense path of
``repro.models.transformer``).

Parameters are a plain dict: ``embed`` [V, d], ``ln_f``, a ``layers``
list of per-layer dicts (the reference stacks them along a leading L axis
and runs ``lax.scan``; a Python loop takes its place here) and, for
untied heads, ``lm_head`` [d, V].  ``convert.params_from_jax`` turns the
reference's tree into this form.

The serving cache is ``{"k", "v": [L, B, S, Hkv, hd], "pos": [B] int32}``
and ``decode_step`` updates it in place.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.planned import planned_dense

from . import layers as L

CACHE_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def cache_dtype_of(cfg) -> torch.dtype:
    return CACHE_DTYPES[cfg.kv_cache_dtype]


def _check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.use_mla:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; the port runs dense "
            "decoders")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random weights at the config's full width, drawn on ``device``
    from ``generator`` with the reference's scales: N(0, 1/d_in) dense
    kernels, N(0, 0.02) embeddings, zero biases, unit norm gains."""
    _check_family(cfg)
    dt = L.compute_dtype(cfg)

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dt)

    def dense(d_in, d_out, scale=None):
        return normal((d_in, d_out), scale or 1.0 / math.sqrt(d_in))

    def norm():
        p = {"w": torch.ones(cfg.d_model, dtype=dt, device=device)}
        if cfg.norm == "layer":
            p["b"] = torch.zeros(cfg.d_model, dtype=dt, device=device)
        return p

    d, hq, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.d_ff)
    layers = []
    for _ in range(cfg.n_layers):
        attn = {
            "wq": dense(d, hq * hd),
            "wk": dense(d, hkv * hd),
            "wv": dense(d, hkv * hd),
            "wo": dense(hq * hd, d, 1.0 / math.sqrt(hq * hd)),
        }
        if cfg.qkv_bias:
            for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                                ("bv", hkv * hd)):
                attn[name] = torch.zeros(width, dtype=dt, device=device)
        if cfg.qk_norm:
            attn["q_norm"] = torch.ones(hd, dtype=dt, device=device)
            attn["k_norm"] = torch.ones(hd, dtype=dt, device=device)
        mlp = {"wg": dense(d, ff), "wu": dense(d, ff),
               "wd": dense(ff, d, 1.0 / math.sqrt(ff))}
        layers.append({"ln1": norm(), "attn": attn, "ln2": norm(),
                       "mlp": mlp})
    p = {"embed": normal((cfg.vocab, d), 0.02), "ln_f": norm(),
         "layers": layers}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense(d, cfg.vocab)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(p, cfg, tokens):
    """tokens [B, S] -> [B, S, d]."""
    return p["embed"][tokens.long()].to(L.compute_dtype(cfg))


def _block(lp, cfg, x, positions):
    """One layer over a whole sequence: (x', k, v)."""
    attn, k, v = L.apply_attention(lp["attn"], cfg,
                                   L.apply_norm(lp["ln1"], cfg, x), positions)
    x = x + attn
    x = x + L.apply_mlp(lp["mlp"], cfg, L.apply_norm(lp["ln2"], cfg, x))
    return x, k, v


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def forward(p, cfg, tokens):
    """Full-sequence forward -> final-norm hidden states [B, S, d]."""
    _check_family(cfg)
    x = embed_tokens(p, cfg, tokens)
    positions = _positions(x)
    for lp in p["layers"]:
        x, _, _ = _block(lp, cfg, x, positions)
    return L.apply_norm(p["ln_f"], cfg, x)


def logits_fn(p, cfg, hidden):
    """[..., d] -> [..., V].  The tied head reads the embedding table as
    a transposed [d, V] operand; no copy is made."""
    head = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
    return planned_dense(hidden, head.to(hidden.dtype), site="lm_head")


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


def prefill(p, cfg, tokens, max_seq, cache_dtype=torch.bfloat16):
    """Run the whole prompt, build its cache, return last-token logits:
    (logits [B, V], cache with ``pos`` = prompt length)."""
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
    logits = logits_fn(p, cfg, x[:, -1:])[:, 0]
    cache["pos"].fill_(s)
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
        x = x + L.apply_mlp(lp["mlp"], cfg, L.apply_norm(lp["ln2"], cfg, x))
    x = L.apply_norm(p["ln_f"], cfg, x)
    logits = logits_fn(p, cfg, x)[:, 0]
    pos += 1
    return logits, cache
