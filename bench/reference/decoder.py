"""A plain decoder-only LM in float32: the dense GLU block and the
top-k mixture-of-experts block, computed layer by layer so that the
program's own weights (bf16, made by the benchmark) are widened one layer
at a time.

It follows the block that the configuration's ``port`` fields describe
(pre-norm RMSNorm, GQA attention with rotary over the whole head, the
per-head RMSNorm of q and k where ``qk_norm`` is set, a SiLU GLU, and
for MoE a float32 router, softmax, top-k by a stable descending sort,
the k weights renormalised and, where a capacity is given, assignments
ranked past it dropped, as the configuration's capacity factor says).
The configuration file lists where that block departs from the
published one.

``precision`` is ``"fp32"`` (the reference) or ``"fp8"`` (the control:
every projection's and expert's operands rounded to float8 e4m3 with a
scale per row of the activation and per column of the weight; the
router and attention stay float32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def strict_fp32() -> None:
    """Float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q8(t, dim):
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim``, back in float32 (straight through for autograd)."""
    amax = t.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


def mm(x, w, precision: str):
    """x [..., K] @ w [K, N] in float32, or with fp8 operands."""
    if precision == "fp8":
        return _q8(x, -1) @ _q8(w, 0)
    return x @ w


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """Rotary embedding over the whole head, halves rotated: x [..., S,
    H, hd], positions [S]."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(lw, cfg, h, precision):
    """Causal GQA self-attention of one batch h [B, S, d] -> [B, S, d]."""
    b, s, _ = h.shape
    nh, nkv = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // nh
    q = mm(h, lw["attn/wq"], precision).view(b, s, nh, hd)
    k = mm(h, lw["attn/wk"], precision).view(b, s, nkv, hd)
    v = mm(h, lw["attn/wv"], precision).view(b, s, nkv, hd)
    if cfg.get("qk_norm"):
        q = rmsnorm(q, lw["attn/q_norm"], cfg["norm_eps"])
        k = rmsnorm(k, lw["attn/k_norm"], cfg["norm_eps"])
    pos = torch.arange(s, device=h.device)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, nh * hd)
    return mm(out, lw["attn/wo"], precision)


def glu(h, wg, wu, wd, precision):
    return mm(F.silu(mm(h, wg, precision)) * mm(h, wu, precision), wd,
              precision)


def moe(lw, cfg, h, precision, capacity=None):
    """The expert block over the flat tokens h [T, d] -> (y [T, d], the
    load-balance term E * sum_e f_e * mean P_e).  ``capacity`` None: no
    assignment is dropped."""
    t = h.shape[0]
    e, k = cfg["moe_num_experts"], cfg["moe_top_k"]
    probs = torch.softmax(h @ lw["moe/router"], dim=-1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, ids = top[:, :k], ids[:, :k]
    weights = top / top.sum(-1, keepdim=True)
    flat = ids.reshape(-1)                       # assignment a = t * k + j
    keep = torch.ones_like(flat, dtype=torch.bool)
    if capacity is not None:
        order = torch.argsort(flat, stable=True)
        ranked = flat[order]
        first = torch.searchsorted(ranked, ranked, side="left")
        rank = torch.empty_like(flat)
        rank[order] = torch.arange(flat.numel(), device=h.device) - first
        keep = rank < capacity
    token = torch.arange(t, device=h.device).repeat_interleave(k)
    wflat = weights.reshape(-1)
    y = torch.zeros_like(h)
    for ex in range(e):
        sel = ((flat == ex) & keep).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        rows = token[sel]
        out = glu(h[rows], lw["moe/wg"][ex], lw["moe/wu"][ex],
                  lw["moe/wd"][ex], precision)
        y = y.index_add(0, rows, out * wflat[sel][:, None])
    counts = torch.bincount(flat, minlength=e).float()
    aux = e * ((counts / counts.sum()) * probs.mean(0)).sum()
    return y, aux


def block(lw, cfg, x, precision, capacity=None):
    """One layer over x [B, S, d] -> (x', load-balance term or 0)."""
    eps = cfg["norm_eps"]
    x = x + attention(lw, cfg, rmsnorm(x, lw["ln1/w"], eps), precision)
    h = rmsnorm(x, lw["ln2/w"], eps)
    if cfg.get("moe_num_experts"):
        b, s, d = h.shape
        cap = None if capacity is None else capacity(b * s)
        y, aux = moe(lw, cfg, h.reshape(b * s, d), precision, cap)
        return x + y.view(b, s, d), aux
    return x + glu(h, lw["mlp/wg"], lw["mlp/wu"], lw["mlp/wd"],
                   precision), x.new_zeros(())


def layer_weights(params, i: int) -> dict:
    """Layer ``i``'s leaves of the port-layout tree, widened to float32,
    keyed by their path inside the layer (``attn/wq``).  A loop, not a
    recursive closure: a closure that refers to itself is a reference
    cycle, and the widened weights in it would stay on the card until
    the garbage collector happened to run."""
    out, todo = {}, [("", params["layers"][i])]
    while todo:
        prefix, node = todo.pop()
        if isinstance(node, dict):
            todo += [(f"{prefix}/{k}" if prefix else k, v)
                     for k, v in node.items()]
        else:
            out[prefix] = node.float()
    return out


@torch.no_grad()
def served_logits(params, cfg, seqs, starts, precision="fp32"):
    """Each sequence's logits at its positions ``start`` .. end: seqs a
    list of int64 token tensors on the card, starts the first position
    read (a prompt's last token).  Layer by layer over every sequence:
    one layer's weights in float32 at a time."""
    xs = [params["embed"][s].float()[None] for s in seqs]
    for i in range(cfg["n_layers"]):
        lw = layer_weights(params, i)
        xs = [block(lw, cfg, x, precision)[0] for x in xs]
        del lw
    head = (params["embed"].t() if cfg.get("tie_embeddings")
            else params["lm_head"]).float()
    out = []
    for x, st in zip(xs, starts):
        h = rmsnorm(x[0, st:], params["ln_f"]["w"].float(), cfg["norm_eps"])
        out.append(mm(h, head, precision))
    return out
