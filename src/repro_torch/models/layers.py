"""Transformer layers of the dense and encdec families: norms, rotary, GQA
attention with the streaming masks, GLU and two-matrix MLPs (the port of
``repro.models.layers``).

Plain functions on tensors and parameter dicts.  Every projection goes
through ``planned_dense`` and the attention score / value contractions
through ``planned_bmm``, so each GEMM of the model runs on a mapper plan —
on the card, the hand-written Hopper kernel; the non-GLU MLP runs as the
planned ``mm+mm`` chain (``planned_mlp_pair``, stamped ``xla``).  Layouts follow the
reference: activations [B, S, d], heads [B, S, H, hd], caches
[B, S, Hkv, hd].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.planned import (planned_bmm, planned_dense,
                                        planned_mlp_pair)

#: the direct attention path materializes [B, H, Sq, Skv] scores; the
#: reference switches to blockwise (flash-style) attention above this
#: length, which the port does not have yet
BLOCKWISE_SEQ_THRESHOLD = 2048

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def apply_norm(p, cfg, x):
    if cfg.norm == "layer":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# rotary embedding
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta):
    """x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs  # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def _qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = planned_dense(x, p["wq"], site="attn.q")
    k = planned_dense(x, p["wk"], site="attn.k")
    v = planned_dense(x, p["wv"], site="attn.v")
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa_scores(qg, k, site):
    """Scores [B, Hkv, G, Sq, Skv] in fp32 as a planned bmm: the operands
    stay in the compute dtype and the kernel flushes its fp32
    accumulator.  qg: [B,Sq,Hkv,G,hd]; k: [B,Skv,Hkv,hd].  B = K^T is
    the column-major view of a [B*Hkv, Skv, hd] copy of K: one key a row
    of hd values (128 bytes at hd 64), which the kernels copy in 16-byte
    units whatever Skv is."""
    b, sq, hkv, group, hd = qg.shape
    skv = k.shape[1]
    qb = qg.permute(0, 2, 3, 1, 4).reshape(b * hkv, group * sq, hd)
    kb = k.transpose(1, 2).contiguous().view(b * hkv, skv, hd).transpose(1, 2)
    s = planned_bmm(qb, kb, site=site, out_dtype=torch.float32)
    return s.reshape(b, hkv, group, sq, skv)


def _gqa_values(w, v, site):
    """Attention readout [B, Sq, Hkv, G, hd] as a planned bmm.
    w: [B,Hkv,G,Sq,Skv] (already in v.dtype); v: [B,Skv,Hkv,hd]."""
    b, hkv, group, sq, skv = w.shape
    hd = v.shape[-1]
    wb = w.reshape(b * hkv, group * sq, skv)
    vb = v.permute(0, 2, 1, 3).reshape(b * hkv, skv, hd)
    out = planned_bmm(wb, vb, site=site)
    return out.reshape(b, hkv, group, sq, hd).permute(0, 3, 1, 2, 4)


def sdpa(q, k, v, *, causal: bool, kv_len=None, chunk=None):
    """q: [B,Sq,Hq,hd]; k/v: [B,Skv,Hkv,hd] (GQA broadcast).

    ``kv_len`` ([B] int32, optional) masks key rows at positions
    ``>= kv_len[b]`` — the streaming cross-attention contract: the
    unwritten tail of a partially filled encoder K/V cache contributes
    exact zeros (a full cache with ``kv_len == Skv`` equals no mask).
    ``chunk`` (int, optional) adds a block-causal mask: query position
    ``qp`` sees key position ``kp`` iff ``qp // chunk >= kp // chunk``.
    """
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if max(sq, skv) > BLOCKWISE_SEQ_THRESHOLD:
        raise NotImplementedError(
            f"sequence {max(sq, skv)} > {BLOCKWISE_SEQ_THRESHOLD} needs "
            "blockwise attention, which the port does not have yet")
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, hd)
    logits = _gqa_scores(qg, k, "attn.scores") / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    if causal:
        logits = torch.where(qpos >= kpos, logits, -1e30)
    if chunk is not None:
        logits = torch.where((qpos // chunk) >= (kpos // chunk), logits,
                             -1e30)
    if kv_len is not None:
        vmask = kpos < kv_len.to(q.device)[:, None]  # [B, Skv]
        logits = torch.where(vmask[:, None, None, None], logits, -1e30)
    w = _padded_rows(torch.softmax(logits, dim=-1), v.dtype)
    out = _gqa_values(w, v, "attn.values")
    return out.reshape(b, sq, hq, hd)


def _padded_rows(x, dtype):
    """``x`` cast to ``dtype`` in rows padded to whole 16-byte units (a
    view of their first ``x.shape[-1]`` columns): the values bmm reads the
    softmax weights as its A, which the GEMM kernels then copy by TMA at
    any key count."""
    n = x.shape[-1]
    unit = 16 // dtype.itemsize
    if n % unit == 0:
        return x.to(dtype)
    rows = torch.empty((*x.shape[:-1], -(-n // unit) * unit), dtype=dtype,
                       device=x.device)[..., :n]
    rows.copy_(x)
    return rows


def apply_attention(p, cfg, x, positions):
    """Causal self-attention over a whole sequence: (output, k, v)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    out = sdpa(q, k, v, causal=True).reshape(b, s, cfg.n_heads * cfg.hd)
    return planned_dense(out, p["wo"], site="attn.out"), k, v


def _masked_decode_attention(p, cfg, q, kseq, vseq, pos, *, sites):
    """One-token GQA decode over a [B,Skv,...] K/V view: masked scores,
    softmax, value readout, output projection.  Rows with kpos > pos are
    masked to -1e30, so unwritten cache rows contribute exact zeros."""
    b = q.shape[0]
    dt = compute_dtype(cfg)
    skv = kseq.shape[1]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qg = q.reshape(b, 1, hkv, hq // hkv, hd)
    logits = _gqa_scores(qg, kseq.to(dt), sites[0]) / math.sqrt(hd)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = kpos <= pos[:, None]
    logits = torch.where(mask[:, None, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(dt)
    out = _gqa_values(w, vseq.to(dt), sites[1])
    return planned_dense(out.reshape(b, 1, hq * hd), p["wo"],
                         site="attn.out")


def apply_attention_decode(p, cfg, x, cache_k, cache_v, pos):
    """One-token decode: x [B,1,d]; cache [B,S,Hkv,hd]; pos [B] int32.

    The new K/V row is written into ``cache_k``/``cache_v`` in place (the
    reference returns updated copies).  Like the reference's
    ``dynamic_update_slice``, the write row clamps at the last one; the
    engine refuses requests that would reach it."""
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    lanes = torch.arange(x.shape[0], device=x.device)
    row = pos.clamp(0, cache_k.shape[1] - 1).long()
    cache_k[lanes, row] = k[:, 0].to(cache_k.dtype)
    cache_v[lanes, row] = v[:, 0].to(cache_v.dtype)
    return _masked_decode_attention(
        p, cfg, q, cache_k, cache_v, pos,
        sites=("attn.decode_scores", "attn.decode_values"))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def apply_mlp(p, cfg, x):
    act_name = "silu" if cfg.act == "silu" else "gelu"
    if not cfg.mlp_glu:
        # up -> bias+act -> down is the registry's mm+mm chain; the output
        # bias stays outside the chain
        out = planned_mlp_pair(x, p["wu"], p["bu"], p["wd"], act=act_name,
                               site="mlp.pair")
        return out + p["bd"]
    if act_name == "silu":
        act = F.silu
    else:  # jax.nn.gelu's default is the tanh approximation
        def act(t):
            return F.gelu(t, approximate="tanh")
    h = act(planned_dense(x, p["wg"], site="mlp.gate")) * planned_dense(
        x, p["wu"], site="mlp.up")
    return planned_dense(h, p["wd"], site="mlp.down")
