"""Encoder-decoder transformer (whisper-base backbone) for streamed audio —
the port of the streaming path of ``repro.models.encdec``.

Frame embeddings come from the planned audio frontend
(``serve/frontend.py``: FIR -> fused fft2d chain -> conv2d), one chunk of
``frames_per_chunk`` frames at a time.  Encoder: non-causal
self-attention blocks (layernorm + two-matrix gelu MLP, sinusoidal
positions), run chunk by chunk (``encode_chunk``) with each chunk
attending over the cached K/V of all earlier chunks plus itself.
Decoder: causal self-attention plus cross-attention to the encoder K/V,
masked past ``enc_len`` while an utterance is still streaming in;
learned positions.  No rotary embedding.

Parameters are a plain dict: ``enc_layers`` and ``dec_layers`` lists of
per-layer dicts (the reference stacks them along a leading axis and runs
``lax.scan``; Python loops take its place here), ``embed`` [V, d] (the
tied head reads it transposed), ``pos_dec`` [max_positions, d],
``ln_enc`` and ``ln_f``.

The caches are updated in place (the reference returns updated copies):
``encode_chunk`` writes the chunk's K/V into the encoder cache and
advances its ``len``; ``decode_step`` writes each layer's K/V row and
advances ``pos``.  Offline ``encode``/``prefill`` over precomputed frames,
``loss_fn`` and the paged functions are not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.planned import planned_dense

from . import layers as L


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """[length, channels] float32 sinusoidal positions (sin | cos)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    ang = torch.arange(length, dtype=torch.float32,
                       device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random weights at the config's full width, drawn on ``device``
    from ``generator`` with the reference's scales: N(0, 1/d_in) dense
    kernels, N(0, 0.02) embeddings, N(0, 0.01) decoder positions, zero
    biases, unit norm gains."""
    dt = L.compute_dtype(cfg)
    d, hq, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.d_ff)

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dt)

    def dense(d_in, d_out, scale=None):
        return normal((d_in, d_out), scale or 1.0 / math.sqrt(d_in))

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=device)

    def norm():
        return {"w": torch.ones(d, dtype=dt, device=device), "b": zeros(d)}

    def attention():
        p = {"wq": dense(d, hq * hd), "wk": dense(d, hkv * hd),
             "wv": dense(d, hkv * hd),
             "wo": dense(hq * hd, d, 1.0 / math.sqrt(hq * hd))}
        if cfg.qkv_bias:
            p.update(bq=zeros(hq * hd), bk=zeros(hkv * hd),
                     bv=zeros(hkv * hd))
        return p

    def mlp():
        return {"wu": dense(d, ff), "wd": dense(ff, d, 1.0 / math.sqrt(ff)),
                "bu": zeros(ff), "bd": zeros(d)}

    enc = [{"ln1": norm(), "attn": attention(), "ln2": norm(),
            "mlp": mlp()} for _ in range(cfg.n_enc_layers)]
    dec = [{"ln1": norm(), "attn": attention(), "ln_x": norm(),
            "xattn": attention(), "ln2": norm(), "mlp": mlp()}
           for _ in range(cfg.n_layers)]
    return {
        "enc_layers": enc,
        "dec_layers": dec,
        "embed": normal((cfg.vocab, d), 0.02),
        "pos_dec": normal((cfg.max_positions, d), 0.01),
        "ln_enc": norm(),
        "ln_f": norm(),
    }


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

def _cross_attend(p, cfg, x, enc_k, enc_v, kv_len=None):
    """x [B,Sq,d] queries against precomputed encoder K/V; ``kv_len``
    ([B] int32) masks encoder rows at positions >= kv_len[b]."""
    b, sq, _ = x.shape
    hq, hd = cfg.n_heads, cfg.hd
    q = planned_dense(x, p["wq"], site="xattn.q").reshape(b, sq, hq, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(hq, hd)
    out = L.sdpa(q, enc_k, enc_v, causal=False, kv_len=kv_len)
    return planned_dense(out.reshape(b, sq, hq * hd), p["wo"],
                         site="xattn.out")


def _enc_kv(p, cfg, enc_out):
    b, s, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    k = planned_dense(enc_out, p["wk"], site="xattn.k").reshape(
        b, s, hkv, hd)
    v = planned_dense(enc_out, p["wv"], site="xattn.v").reshape(
        b, s, hkv, hd)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(hkv, hd)
        v = v + p["bv"].reshape(hkv, hd)
    return k, v


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_seq, enc_frames=None, dtype=torch.bfloat16,
               device="cuda"):
    nl, f = cfg.n_layers, enc_frames or cfg.enc_frames

    def zeros(s):
        return torch.zeros((nl, batch, s, cfg.n_kv_heads, cfg.hd),
                           dtype=dtype, device=device)

    return {
        "k": zeros(max_seq), "v": zeros(max_seq),
        "enc_k": zeros(f), "enc_v": zeros(f),
        # valid encoder rows per lane: cross-attention masks rows past
        # this while the utterance streams in
        "enc_len": torch.zeros(batch, dtype=torch.int32, device=device),
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def init_enc_cache(cfg, batch, f_max=None, device="cuda"):
    """Incremental encoder self-attention state for chunked streaming:
    per-enc-layer K/V padded to ``f_max`` frames plus the fill clock."""
    f = f_max or cfg.enc_frames
    shape = (cfg.n_enc_layers, batch, f, cfg.n_kv_heads, cfg.hd)
    dt = L.compute_dtype(cfg)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "len": torch.zeros(batch, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# streaming encoder
# ---------------------------------------------------------------------------

def encode_chunk(p, cfg, ec, frames_chunk):
    """One streaming encoder step: run ``frames_chunk`` [B, C, d] through
    the encoder with each layer attending over its cached K/V of all
    earlier chunks plus this one, write this chunk's K/V into ``ec`` in
    place, advance ``ec["len"]``, and return ``(ec, enc_states
    [B, C, d])``.  Every chunk attends over the same [f_max] keys, masked
    past ``start + C``.  The chunk clock is batch-uniform
    (``ec["len"][0]``): the engine feeds one lane at a time."""
    b, c, _ = frames_chunk.shape
    dt = L.compute_dtype(cfg)
    start = int(ec["len"][0])
    device = frames_chunk.device
    pos_table = sinusoids(start + c, cfg.d_model, device).to(dt)
    x = frames_chunk.to(dt) + pos_table[start:start + c]
    positions = (start + torch.arange(c, device=device)).expand(b, c)
    kv_len = torch.full((b,), start + c, dtype=torch.int32, device=device)
    for i, lp in enumerate(p["enc_layers"]):
        h = L.apply_norm(lp["ln1"], cfg, x)
        q, k, v = L._qkv(lp["attn"], cfg, h, positions)
        ck, cv = ec["k"][i], ec["v"][i]
        ck[:, start:start + c] = k.to(ck.dtype)
        cv[:, start:start + c] = v.to(cv.dtype)
        attn = L.sdpa(q, ck, cv, causal=False, kv_len=kv_len)
        x = x + planned_dense(attn.reshape(b, c, -1), lp["attn"]["wo"],
                              site="attn.out")
        h = L.apply_norm(lp["ln2"], cfg, x)
        x = x + L.apply_mlp(lp["mlp"], cfg, h)
    ec["len"] += c
    return ec, L.apply_norm(p["ln_enc"], cfg, x)


def enc_kv_chunk(p, cfg, enc_out, cache_dtype=torch.bfloat16):
    """Per-decoder-layer cross-attention K/V for a block of encoder
    states: enc_out [B, C, d] -> ([nl, B, C, hkv, hd], same) in the cache
    dtype."""
    ks, vs = [], []
    for lp in p["dec_layers"]:
        ek, ev = _enc_kv(lp["xattn"], cfg, enc_out)
        ks.append(ek.to(cache_dtype))
        vs.append(ev.to(cache_dtype))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# decoder: prompt pass, streaming prefill, decode
# ---------------------------------------------------------------------------

def _embed(p, cfg, tokens):
    return p["embed"][tokens.long()].to(L.compute_dtype(cfg))


def _logits(p, x):
    return planned_dense(x, p["embed"].t().to(x.dtype), site="lm_head")


def prefill_decoder(p, cfg, enc_k, enc_v, enc_len, tokens, max_seq,
                    cache_dtype=torch.bfloat16):
    """Teacher-forced decoder prompt pass against already-built encoder
    K/V ([nl, B, F, hkv, hd], rows past ``enc_len`` masked): (last-token
    logits [B, V], a fresh cache holding the prompt's K/V and these
    encoder K/V)."""
    b, s = tokens.shape
    x = _embed(p, cfg, tokens) + p["pos_dec"][:s]
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_cache(cfg, b, max_seq, enc_k.shape[2], cache_dtype,
                       x.device)
    for i, lp in enumerate(p["dec_layers"]):
        h = L.apply_norm(lp["ln1"], cfg, x)
        q, k, v = L._qkv(lp["attn"], cfg, h, positions)
        x = x + planned_dense(
            L.sdpa(q, k, v, causal=True).reshape(b, s, -1),
            lp["attn"]["wo"], site="attn.out")
        h = L.apply_norm(lp["ln_x"], cfg, x)
        x = x + _cross_attend(lp["xattn"], cfg, h, enc_k[i], enc_v[i],
                              kv_len=enc_len)
        h = L.apply_norm(lp["ln2"], cfg, x)
        x = x + L.apply_mlp(lp["mlp"], cfg, h)
        cache["k"][i, :, :s] = k.to(cache_dtype)
        cache["v"][i, :, :s] = v.to(cache_dtype)
    x = L.apply_norm(p["ln_f"], cfg, x)
    logits = _logits(p, x[:, -1:])[:, 0]
    cache["enc_k"].copy_(enc_k)
    cache["enc_v"].copy_(enc_v)
    cache["enc_len"].copy_(enc_len)
    cache["pos"].fill_(s)
    return logits, cache


def prefill_streaming(p, cfg, frames, tokens, max_seq, chunk,
                      cache_dtype=torch.bfloat16, f_max=None):
    """Whole-utterance prefill through the *streaming* encoder: the same
    per-chunk ``encode_chunk``/``enc_kv_chunk`` computation the engine
    runs one chunk per step, then the decoder prompt pass with
    ``enc_len == F``.  The offline comparator of the streaming tests;
    returns (logits, cache, encoder cache)."""
    b, s = tokens.shape
    f = frames.shape[1]
    if f % chunk:
        raise ValueError(f"frames {f} not a multiple of chunk {chunk}")
    fm = f_max or cfg.enc_frames
    device = frames.device
    ec = init_enc_cache(cfg, b, fm, device)
    shape = (cfg.n_layers, b, fm, cfg.n_kv_heads, cfg.hd)
    enc_k = torch.zeros(shape, dtype=cache_dtype, device=device)
    enc_v = torch.zeros_like(enc_k)
    for i in range(f // chunk):
        ec, enc_out = encode_chunk(p, cfg, ec,
                                   frames[:, i * chunk:(i + 1) * chunk])
        ek, ev = enc_kv_chunk(p, cfg, enc_out, cache_dtype)
        enc_k[:, :, i * chunk:(i + 1) * chunk] = ek
        enc_v[:, :, i * chunk:(i + 1) * chunk] = ev
    enc_len = torch.full((b,), f, dtype=torch.int32, device=device)
    logits, cache = prefill_decoder(p, cfg, enc_k, enc_v, enc_len, tokens,
                                    max_seq, cache_dtype)
    return logits, cache, ec


def decode_step(p, cfg, cache, tokens):
    """tokens [B, 1] -> (logits [B, V], cache), the cache updated in
    place: each layer writes its K/V row, then ``pos`` advances."""
    pos = cache["pos"]
    x = _embed(p, cfg, tokens) + p["pos_dec"][pos.long()][:, None].to(
        L.compute_dtype(cfg))
    for i, lp in enumerate(p["dec_layers"]):
        h = L.apply_norm(lp["ln1"], cfg, x)
        x = x + L.apply_attention_decode(lp["attn"], cfg, h, cache["k"][i],
                                         cache["v"][i], pos)
        h = L.apply_norm(lp["ln_x"], cfg, x)
        x = x + _cross_attend(lp["xattn"], cfg, h, cache["enc_k"][i],
                              cache["enc_v"][i], kv_len=cache["enc_len"])
        h = L.apply_norm(lp["ln2"], cfg, x)
        x = x + L.apply_mlp(lp["mlp"], cfg, h)
    x = L.apply_norm(p["ln_f"], cfg, x)
    logits = _logits(p, x)[:, 0]
    pos += 1
    return logits, cache
