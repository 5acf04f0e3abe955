"""Transformer layers of the dense and encdec families: norms, rotary, GQA
attention with the streaming masks, GLU and two-matrix MLPs (the port of
``repro.models.layers``).

Plain functions on tensors and parameter dicts.  Every projection goes
through ``planned_dense`` and the direct attention's score / value
contractions through ``planned_bmm``, so each of those GEMMs runs on a
mapper plan — on the card, the hand-written Hopper kernel; the non-GLU
MLP runs as the planned ``mm+mm`` chain (``planned_mlp_pair``, stamped
``xla``).  Self-attention over more than ``BLOCKWISE_SEQ_THRESHOLD``
rows takes ``blockwise_attention`` instead, whose products are plain
``torch.matmul`` as the reference's are XLA einsums.  Layouts follow the
reference: activations [B, S, d], heads [B, S, H, hd], caches
[B, S, Hkv, hd].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.planned import (padded_rows, planned_bmm,
                                        planned_dense, planned_mlp_pair)

#: the direct attention path materializes [B, H, Sq, Skv] scores; above
#: this length ``attention_core`` switches to blockwise attention over
#: [B, H, Q_CHUNK, K_CHUNK] logits at a time, as the reference does
BLOCKWISE_SEQ_THRESHOLD = 2048
Q_CHUNK = 512
K_CHUNK = 1024

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init helpers: random weights drawn on the device with the reference's
# scales (N(0, 1/d_in) dense kernels, unit norm gains, zero biases)
# ---------------------------------------------------------------------------

def normal(generator, shape, scale, dtype, device):
    """N(0, scale^2) drawn in fp32 on ``device``, cast to ``dtype``.  The
    draw is scaled in place, so a leaf costs one fp32 temporary (3.1 GB
    for qwen3-32b's untied head)."""
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def dense_init(generator, d_in, d_out, dtype, device, scale=None):
    return normal(generator, (d_in, d_out), scale or 1.0 / math.sqrt(d_in),
                  dtype, device)


def init_norm(cfg, device):
    dt = compute_dtype(cfg)
    p = {"w": torch.ones(cfg.d_model, dtype=dt, device=device)}
    if cfg.norm == "layer":
        p["b"] = torch.zeros(cfg.d_model, dtype=dt, device=device)
    return p


def init_attention(cfg, generator, device):
    """wq, wk, wv, wo in that order (the biases and q/k norms draw
    nothing)."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = compute_dtype(cfg)
    p = {name: dense_init(generator, d_in, d_out, dt, device)
         for name, d_in, d_out in (("wq", d, hq * hd), ("wk", d, hkv * hd),
                                   ("wv", d, hkv * hd), ("wo", hq * hd, d))}
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros(width, dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, dtype=dt, device=device)
        p["k_norm"] = torch.ones(hd, dtype=dt, device=device)
    return p


def init_glu_mlp(cfg, generator, device):
    """The GLU MLP's wg, wu, wd in that order."""
    d, ff, dt = cfg.d_model, cfg.d_ff, compute_dtype(cfg)
    return {"wg": dense_init(generator, d, ff, dt, device),
            "wu": dense_init(generator, d, ff, dt, device),
            "wd": dense_init(generator, ff, d, dt, device)}


def attention_specs(cfg) -> dict:
    """GQA attention's logical axes (``init_attention``'s tree)."""
    s = {
        "wq": ("d_model", "heads"),
        "wk": ("d_model", "kv_heads"),
        "wv": ("d_model", "kv_heads"),
        "wo": ("heads", "d_model"),
    }
    if cfg.qkv_bias:
        s |= {"bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)}
    if cfg.qk_norm:
        s |= {"q_norm": (None,), "k_norm": (None,)}
    return s


def mlp_specs(cfg) -> dict:
    """The MLP's logical axes: the GLU's, or the biased pair's."""
    s = {
        "wu": ("d_model", "ff"),
        "wd": ("ff", "d_model"),
    }
    if cfg.mlp_glu:
        s["wg"] = ("d_model", "ff")
    else:
        s |= {"bu": ("ff",), "bd": (None,)}
    return s


def norm_specs(cfg) -> dict:
    if cfg.norm == "layer":
        return {"w": (None,), "b": (None,)}
    return {"w": (None,)}


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
    # the values bmm reads the weights as its A: rows of whole 16-byte
    # units, which the GEMM kernels copy by TMA at any key count
    w = padded_rows(torch.softmax(logits, dim=-1), v.dtype)
    out = _gqa_values(w, v, "attn.values")
    return out.reshape(b, sq, hq, hd)


def blockwise_attention(q, k, v, *, causal: bool, scale=None,
                        q_chunk=Q_CHUNK, k_chunk=K_CHUNK,
                        block_skip: bool = False):
    """Flash-style attention: a loop over q chunks, an inner loop over kv
    chunks with an online softmax, so no more than [B, H, q_chunk,
    k_chunk] logits exist at a time.

    q: [B,Sq,H,dqk]; k: [B,Skv,H,dqk]; v: [B,Skv,H,dv] — heads already
    GQA-expanded (``gqa_expand``).  The reference's arithmetic: q and kv
    are zero-padded to whole chunks and the kv tail is masked; the scores
    are fp32, from fp32 operands (the bf16 inputs widen exactly, so each
    product is the one a bf16 product with an fp32 result gives) times
    ``scale``; masked logits are -1e30, never -inf; ``p`` is cast to
    ``v.dtype`` before the value product, whose result accumulates in
    fp32; the output is ``acc / max(l, 1e-30)`` cast to ``v.dtype``.
    ``block_skip`` (with ``causal``) visits only the kv chunks that hold
    a position some query of the q chunk sees.  The products are
    ``torch.matmul``: the reference's are XLA einsums, not a kernel.
    Without autograd the logit block is scaled, masked and exponentiated
    in place; when a gradient is recorded each step makes a new tensor,
    since the block's max saves the block for its backward.
    """
    b, sq, h, dqk = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dqk)
    q_chunk, k_chunk = min(q_chunk, sq), min(k_chunk, skv)
    nq, nk = -(-sq // q_chunk), -(-skv // k_chunk)
    # [B, H, S, d], zero-padded to whole chunks; the score operands in fp32
    qh = F.pad(q.transpose(1, 2).float(), (0, 0, 0, nq * q_chunk - sq))
    kh = F.pad(k.transpose(1, 2).float(), (0, 0, 0, nk * k_chunk - skv))
    vh = F.pad(v.transpose(1, 2), (0, 0, 0, nk * k_chunk - skv))
    ar_q = torch.arange(q_chunk, device=q.device)
    ar_k = torch.arange(k_chunk, device=q.device)
    out = torch.empty((b, h, nq * q_chunk, dv), dtype=v.dtype,
                      device=q.device)
    inplace = not (torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)))
    for qi in range(nq):
        qc = qh[:, :, qi * q_chunk:(qi + 1) * q_chunk]
        qpos = qi * q_chunk + ar_q
        m = torch.full((b, h, q_chunk), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, q_chunk, dv), dtype=torch.float32,
                          device=q.device)
        hi = nk
        if block_skip and causal:
            hi = min(((qi + 1) * q_chunk + k_chunk - 1) // k_chunk, nk)
        for ki in range(hi):
            kc = kh[:, :, ki * k_chunk:(ki + 1) * k_chunk]
            vc = vh[:, :, ki * k_chunk:(ki + 1) * k_chunk]
            s = torch.matmul(qc, kc.transpose(-1, -2))
            s = s.mul_(scale) if inplace else s * scale
            kpos = ki * k_chunk + ar_k
            mask = None
            if causal and (ki + 1) * k_chunk - 1 > qi * q_chunk:
                mask = qpos[:, None] >= kpos[None, :]
            if (ki + 1) * k_chunk > skv:
                valid = (kpos < skv)[None, :]
                mask = valid if mask is None else mask & valid
            if mask is not None:  # an all-true mask leaves s as it is
                s = (s.masked_fill_(~mask, -1e30) if inplace
                     else s.masked_fill(~mask, -1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            s = (s.sub_(m_new[..., None]).exp_() if inplace
                 else torch.exp(s - m_new[..., None]))
            corr = torch.exp(m - m_new)
            l = l * corr + s.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                s.to(vc.dtype), vc).float()
            m = m_new
        out[:, :, qi * q_chunk:(qi + 1) * q_chunk] = (
            acc / torch.clamp(l, min=1e-30)[..., None]).to(v.dtype)
    return out[:, :, :sq].transpose(1, 2)


def gqa_expand(k, hq):
    """[B,S,Hkv,hd] -> [B,S,Hq,hd] by group repetition."""
    hkv = k.shape[2]
    if hkv == hq:
        return k
    return torch.repeat_interleave(k, hq // hkv, dim=2)


def attention_core(q, k, v, *, causal: bool, block_skip: bool = False,
                   kv_len=None, chunk=None):
    """Direct ``sdpa`` when a streaming mask (``kv_len``/``chunk``) is
    given or when max(Sq, Skv) <= ``BLOCKWISE_SEQ_THRESHOLD``; above it,
    ``blockwise_attention`` over GQA-expanded K/V, as the reference."""
    sq, skv = q.shape[1], k.shape[1]
    if (kv_len is not None or chunk is not None
            or max(sq, skv) <= BLOCKWISE_SEQ_THRESHOLD):
        return sdpa(q, k, v, causal=causal, kv_len=kv_len, chunk=chunk)
    hq = q.shape[2]
    return blockwise_attention(q, gqa_expand(k, hq), gqa_expand(v, hq),
                               causal=causal,
                               block_skip=block_skip and causal)


def apply_attention(p, cfg, x, positions, *, causal=True, chunk=None):
    """Self-attention over a whole sequence through ``attention_core``:
    (output, k, v)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    out = attention_core(q, k, v, causal=causal,
                         block_skip=cfg.causal_block_skip, chunk=chunk)
    out = out.reshape(b, s, cfg.n_heads * cfg.hd)
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


def last_rows(x, last_index, offset: int = 0):
    """The hidden row each lane's logits come from: the last one, or with
    ``last_index`` ([B] int32; a bucketed prefill's last real token) that
    row, ``offset`` rows in (a vlm's prepended patch rows) -> ([B, 1, d],
    cache ``pos`` [B] int32)."""
    b, s = x.shape[:2]
    if last_index is None:
        return x[:, -1:], torch.full((b,), s, dtype=torch.int32,
                                     device=x.device)
    idx = last_index.to(device=x.device, dtype=torch.long) + offset
    sel = x[torch.arange(b, device=x.device), idx][:, None]
    return sel, (idx + 1).to(torch.int32)


# ---------------------------------------------------------------------------
# block-paged KV cache primitives (continuous-batching serving)
# ---------------------------------------------------------------------------

def paged_write(pool, new, block_tables, pos, active):
    """Write one token's K/V row per lane into a block pool, in place.

    pool [NB + 1, bs, ...] (its last block the sink); new [B, ...] (one
    row per lane); block_tables [B, T] int32; pos [B] int32 (the row each
    lane writes); active [B] bool.  Inactive lanes MUST NOT write to a
    live block — their table rows may point at blocks since re-allocated
    to another lane — so their row goes to the sink block, which the
    allocator never hands out.  (The reference forces the index out of
    range and lets its scatter drop it; a PyTorch index out of range is
    a device-side assert, and a clamp would land on a live row.)"""
    sink, bs = pool.shape[0] - 1, pool.shape[1]
    slot = (pos // bs).clamp(0, block_tables.shape[1] - 1).long()
    blk = block_tables.gather(1, slot[:, None])[:, 0].long()
    blk = torch.where(active, blk, sink)
    flat = pool.view(-1, *pool.shape[2:])
    flat[blk * bs + (pos % bs).long()] = new.to(pool.dtype)


def paged_gather(pool, block_tables):
    """Assemble each lane's logical K/V sequence from its block table.

    pool [NB + 1, bs, ...]; block_tables [B, T] -> [B, T*bs, ...].  Rows
    past the lane's ``pos`` are garbage (freed or never-written blocks)
    — the decode mask hides them, exactly like the zero tail of a
    contiguous lane cache."""
    g = pool[block_tables.long()]  # [B, T, bs, ...]
    return g.reshape(block_tables.shape[0], -1, *pool.shape[2:])


def apply_attention_decode_paged(p, cfg, x, pool_k, pool_v, block_tables,
                                 pos, active):
    """Block-paged one-token decode: the math of
    ``apply_attention_decode``, but K/V live in a shared block pool
    indexed through per-lane block tables (written in place), so
    admitting or evicting a lane is a host-side table edit and the
    captured decode step never changes shape.  The gather yields
    ``T * bs`` = ``max_seq`` rows, the slot cache's count, so every GEMM
    runs at the slot engine's shapes."""
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    paged_write(pool_k, k[:, 0], block_tables, pos, active)
    paged_write(pool_v, v[:, 0], block_tables, pos, active)
    return _masked_decode_attention(
        p, cfg, q, paged_gather(pool_k, block_tables),
        paged_gather(pool_v, block_tables), pos,
        sites=("attn.paged_scores", "attn.paged_values"))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def activation(cfg):
    """The GLU's activation: silu, else gelu in the tanh form
    (``jax.nn.gelu``'s default)."""
    if cfg.act == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def apply_mlp(p, cfg, x):
    if not cfg.mlp_glu:
        # up -> bias+act -> down is the registry's mm+mm chain; the output
        # bias stays outside the chain
        act_name = "silu" if cfg.act == "silu" else "gelu"
        out = planned_mlp_pair(x, p["wu"], p["bu"], p["wd"], act=act_name,
                               site="mlp.pair")
        return out + p["bd"]
    act = activation(cfg)
    h = act(planned_dense(x, p["wg"], site="mlp.gate")) * planned_dense(
        x, p["wu"], site="mlp.up")
    return planned_dense(h, p["wd"], site="mlp.down")
