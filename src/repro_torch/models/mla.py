"""Multi-head Latent Attention (DeepSeek-V2) of the port
(``repro.models.mla``): low-rank KV compression.

Prefill and training expand the latent to per-head keys and values
(``apply_mla``); decode runs the *absorbed* form against the compressed
cache (``apply_mla_decode``, ``apply_mla_decode_paged``): a token caches
its latent ``ckv`` [kv_lora_rank] and one rope key ``kr``
[rope_head_dim] shared by every head, (512 + 64) x 2 bytes a token a
layer in bf16 at deepseek-v2's width against 2 x 128 x 128 x 2 for its
128 heads as a GQA cache.

The seven projections go through ``planned_dense`` at the reference's
sites (``mla.q_down``, ``mla.q_up`` or ``mla.q``, ``mla.kv_down``,
``mla.k_rope``, ``mla.k_up``, ``mla.v_up``, ``mla.out``).  The score and
readout products, and the absorbed ones, are ``torch.matmul``: the
reference's are XLA einsums, not Pallas kernels.  Their roundings are
the reference's: the logits are fp32 products of widened operands times
1/sqrt(nope + rope), masked to -1e30 (never -inf); the softmax output is
cast to the values' (prefill) or the cache's (decode) dtype before the
readout; at decode ``q_abs``, ``out_lat`` and the ``wuv`` product keep
their operands' dtype (bf16 at full width).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.planned import planned_dense

from . import layers as L


def init_mla(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random weights drawn on ``device`` with the reference's scales
    (N(0, 1/d_in) kernels, unit norm gains), in the order wdq, wuq (or
    wq), wdkv, wkr, wuk, wuv, wo."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    dt = L.compute_dtype(cfg)
    qh = h * (nope + rope)
    p = {}
    if cfg.q_lora_rank:
        p["wdq"] = L.dense_init(generator, d, cfg.q_lora_rank, dt, device)
        p["q_norm"] = torch.ones(cfg.q_lora_rank, dtype=dt, device=device)
        p["wuq"] = L.dense_init(generator, cfg.q_lora_rank, qh, dt, device)
    else:
        p["wq"] = L.dense_init(generator, d, qh, dt, device)
    p["wdkv"] = L.dense_init(generator, d, cfg.kv_lora_rank, dt, device)
    p["kv_norm"] = torch.ones(cfg.kv_lora_rank, dtype=dt, device=device)
    p["wkr"] = L.dense_init(generator, d, rope, dt, device)
    p["wuk"] = L.dense_init(generator, cfg.kv_lora_rank, h * nope, dt, device)
    p["wuv"] = L.dense_init(generator, cfg.kv_lora_rank, h * vd, dt, device)
    p["wo"] = L.dense_init(generator, h * vd, d, dt, device)
    return p


def mla_specs(cfg) -> dict:
    """MLA's logical axes (``init_mla``'s tree)."""
    s = {
        "wdkv": ("d_model", None),
        "kv_norm": (None,),
        "wkr": ("d_model", None),
        "wuk": (None, "heads"),
        "wuv": (None, "heads"),
        "wo": ("heads", "d_model"),
    }
    if cfg.q_lora_rank:
        s |= {"wdq": ("d_model", None), "q_norm": (None,),
              "wuq": (None, "heads")}
    else:
        s |= {"wq": ("d_model", "heads")}
    return s


def _queries(p, cfg, x, positions):
    """x [B, S, d] -> (qn [B, S, H, nope], qr [B, S, H, rope] roped)."""
    b, s, _ = x.shape
    h, nope, rope = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        cq = L.rmsnorm(planned_dense(x, p["wdq"], site="mla.q_down"),
                       p["q_norm"], cfg.norm_eps)
        q = planned_dense(cq, p["wuq"], site="mla.q_up")
    else:
        q = planned_dense(x, p["wq"], site="mla.q")
    q = q.reshape(b, s, h, nope + rope)
    return q[..., :nope], L.apply_rope(q[..., nope:], positions,
                                       cfg.rope_theta)


def _latent(p, cfg, x, positions):
    """x [B, S, d] -> (ckv [B, S, kv_lora] normed, kr [B, S, rope] roped
    as one head shared by all)."""
    ckv = L.rmsnorm(planned_dense(x, p["wdkv"], site="mla.kv_down"),
                    p["kv_norm"], cfg.norm_eps)
    kr = planned_dense(x, p["wkr"], site="mla.k_rope")[:, :, None, :]
    return ckv, L.apply_rope(kr, positions, cfg.rope_theta)[:, :, 0, :]


def _scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)


def apply_mla(p, cfg, x, positions, *, causal=True):
    """Training / prefill path, the latent expanded to per-head K/V:
    (output [B, S, d], ckv, kr), the last two what the cache holds.

    Above ``BLOCKWISE_SEQ_THRESHOLD`` rows, blockwise attention over
    q_cat = [qn ; qr] and k_cat = [kn ; kr broadcast] (dqk = nope + rope,
    dv = v_head_dim), whose scores equal qn.kn + qr.kr; below it, the two
    fp32 logit terms summed."""
    b, s, _ = x.shape
    h, nope, vd = cfg.n_heads, cfg.nope_head_dim, cfg.v_head_dim
    rope = cfg.rope_head_dim
    qn, qr = _queries(p, cfg, x, positions)
    ckv, kr = _latent(p, cfg, x, positions)
    kn = planned_dense(ckv, p["wuk"], site="mla.k_up").reshape(b, s, h, nope)
    v = planned_dense(ckv, p["wuv"], site="mla.v_up").reshape(b, s, h, vd)
    scale = _scale(cfg)
    if s > L.BLOCKWISE_SEQ_THRESHOLD:
        q_cat = torch.cat([qn, qr], dim=-1)
        k_cat = torch.cat([kn, kr[:, :, None, :].expand(b, s, h, rope)],
                          dim=-1)
        out = L.blockwise_attention(
            q_cat, k_cat, v, causal=causal, scale=scale,
            block_skip=cfg.causal_block_skip and causal)
    else:
        # [B, H, S, S]: qn.kn per head plus qr against the shared kr
        logits = (torch.matmul(qn.transpose(1, 2).float(),
                               kn.permute(0, 2, 3, 1).float())
                  + torch.matmul(qr.transpose(1, 2).float(),
                                 kr.float().transpose(1, 2)[:, None])) * scale
        if causal:
            pos = torch.arange(s, device=x.device)
            logits = torch.where(pos[:, None] >= pos[None, :], logits, -1e30)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(w, v.transpose(1, 2)).transpose(1, 2)
    out = out.reshape(b, s, h * vd)
    return planned_dense(out, p["wo"], site="mla.out"), ckv, kr


def _matmul(a, b):
    """``torch.matmul`` in the operands' promoted dtype, as an XLA einsum
    of two dtypes computes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def _absorbed_decode(p, cfg, qn, qr, ckv_seq, kr_seq, pos):
    """Absorbed scoring and latent readout of one token a lane over a
    [B, Skv, ...] latent view (the lane cache or the block-table gather);
    rows past ``pos`` are masked, so unwritten rows contribute exact
    zeros.  qn [B, 1, H, nope]; qr [B, 1, H, rope]."""
    b = qn.shape[0]
    h, nope, vd = cfg.n_heads, cfg.nope_head_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    # absorb W_uk into the query: q_abs[b, h] = qn[b, h] @ W_uk[:, h]^T
    wuk = p["wuk"].reshape(kvl, h, nope)
    q_abs = _matmul(qn[:, 0].transpose(0, 1),
                    wuk.permute(1, 2, 0)).transpose(0, 1)  # [B, H, kvl]
    logits = (torch.matmul(q_abs.float(), ckv_seq.float().transpose(1, 2))
              + torch.matmul(qr[:, 0].float(),
                             kr_seq.float().transpose(1, 2))) * _scale(cfg)
    kpos = torch.arange(ckv_seq.shape[1], device=qn.device)[None, :]
    mask = kpos <= pos[:, None]
    logits = torch.where(mask[:, None], logits, -1e30)  # [B, H, Skv]
    w = torch.softmax(logits, dim=-1).to(ckv_seq.dtype)
    out_lat = _matmul(w, ckv_seq)  # [B, H, kvl]
    wuv = p["wuv"].reshape(kvl, h, vd)
    out = _matmul(out_lat.transpose(0, 1), wuv.transpose(0, 1))
    out = out.transpose(0, 1).reshape(b, 1, h * vd)
    return planned_dense(out, p["wo"], site="mla.out")


def apply_mla_decode(p, cfg, x, cache_ckv, cache_kr, pos):
    """One-token absorbed decode: x [B, 1, d]; cache_ckv [B, S, kv_lora];
    cache_kr [B, S, rope]; pos [B] int32.  The new latent row is written
    into the caches in place (the reference returns updated copies); like
    the reference's ``dynamic_update_slice``, the write row clamps at the
    last one."""
    qn, qr = _queries(p, cfg, x, pos[:, None])
    ckv_new, kr_new = _latent(p, cfg, x, pos[:, None])
    lanes = torch.arange(x.shape[0], device=x.device)
    row = pos.clamp(0, cache_ckv.shape[1] - 1).long()
    cache_ckv[lanes, row] = ckv_new[:, 0].to(cache_ckv.dtype)
    cache_kr[lanes, row] = kr_new[:, 0].to(cache_kr.dtype)
    return _absorbed_decode(p, cfg, qn, qr, cache_ckv, cache_kr, pos)


def apply_mla_decode_paged(p, cfg, x, pool_ckv, pool_kr, block_tables,
                           pos, active):
    """Block-paged absorbed decode: the latent cache lives in shared block
    pools [NB + 1, bs, ...] indexed through per-lane block tables,
    written in place (an inactive lane's row to the sink block;
    ``layers.paged_write`` / ``paged_gather``)."""
    qn, qr = _queries(p, cfg, x, pos[:, None])
    ckv_new, kr_new = _latent(p, cfg, x, pos[:, None])
    L.paged_write(pool_ckv, ckv_new[:, 0], block_tables, pos, active)
    L.paged_write(pool_kr, kr_new[:, 0], block_tables, pos, active)
    return _absorbed_decode(p, cfg, qn, qr,
                            L.paged_gather(pool_ckv, block_tables),
                            L.paged_gather(pool_kr, block_tables), pos)
