"""Mamba2 block of the port (``repro.models.ssm``): SSD (state-space
duality) in its chunked form for a whole sequence, and the one-token
recurrent step for decode.

Layout: x [B, S, d_model]; d_inner = expand·d, nh = d_inner / headdim
heads, state size N, one group (B and C shared across heads).  The
projections are unpacked (``z_proj``, ``x_proj``, ``b_proj``, ``c_proj``,
``dt_proj``), as in the reference.

None of this runs on a hand kernel: the reference computes the
projections, the depthwise conv, the SSD's einsums and its chunk scan as
XLA ops outside any Pallas kernel, so here they are ``torch.matmul``,
``torch.einsum`` and elementwise ops (the model's planned GEMM is its
``lm_head``, in ``models/hybrid.py``).  The SSD runs in fp32 throughout.

The decode cache of a block is ``{"conv": [B, K-1, d_inner + 2N]`` (the
raw ``[x, B, C]`` projections of the last K-1 tokens, the conv's
window) ``, "ssm": [B, nh, headdim, N] fp32}``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers as L


def init_mamba(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random weights drawn on ``device`` with the reference's scales, in
    its draw order: the five projections at N(0, 1/d), the two conv
    filters [K, C] at N(0, 1/K), ``out_proj`` at N(0, 1/d_inner); zero
    conv biases, a unit norm gain; ``A_log = log(linspace(1, 16, nh))``,
    ``D = 1`` and ``dt_bias = 0`` in fp32."""
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt = L.compute_dtype(cfg)

    def dense(d_in, d_out):
        return L.dense_init(generator, d_in, d_out, dt, device)

    def conv(c):
        return L.normal(generator, (cfg.ssm_conv, c),
                        1.0 / math.sqrt(cfg.ssm_conv), dt, device)

    def zeros(n, dtype=dt):
        return torch.zeros(n, dtype=dtype, device=device)

    p = {"z_proj": dense(d, di), "x_proj": dense(d, di),
         "b_proj": dense(d, ns), "c_proj": dense(d, ns),
         "dt_proj": dense(d, nh),
         "conv_x": conv(di), "conv_bx": zeros(di),
         "conv_bc": conv(2 * ns), "conv_bc_bias": zeros(2 * ns)}
    p["A_log"] = torch.log(torch.linspace(1.0, 16.0, nh, device=device))
    p["D"] = torch.ones(nh, dtype=torch.float32, device=device)
    p["dt_bias"] = zeros(nh, torch.float32)
    p["norm"] = torch.ones(di, dtype=dt, device=device)
    p["out_proj"] = dense(di, d)
    return p


def mamba_specs(cfg) -> dict:
    """The Mamba2 block's logical axes (``init_mamba``'s tree)."""
    del cfg
    return {
        "z_proj": ("d_model", "ssm_heads"),
        "x_proj": ("d_model", "ssm_heads"),
        "b_proj": ("d_model", None),
        "c_proj": ("d_model", None),
        "dt_proj": ("d_model", "ssm_heads"),
        "conv_x": (None, "ssm_heads"),
        "conv_bx": ("ssm_heads",),
        "conv_bc": (None, None),
        "conv_bc_bias": (None,),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": ("ssm_heads",),
        "out_proj": ("ssm_heads", "d_model"),
    }


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    threshold (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(cfg, xbc, w, b):
    """Depthwise causal conv along the sequence: xbc [B, S, C], w [K, C],
    b [C].  fp32 accumulation over the K taps in order, the bias, silu,
    then a cast back to xbc's dtype."""
    k, s = cfg.ssm_conv, xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + pad[:, i:i + s].float() * w[i].float()
    return F.silu(out + b.float()).to(xbc.dtype)


def _ssd_chunked(cfg, x, dt, b_ssm, c_ssm, a, ssm_state=None):
    """The SSD chunked scan.  x [B, S, nh, hp]; dt [B, S, nh] fp32; b/c
    [B, S, N]; a [nh] (negative); ``ssm_state`` [B, nh, hp, N] or None
    (zeros).  Returns y [B, S, nh, hp] and the final state [B, nh, hp, N],
    both fp32.

    Chunks of Q = min(``ssm_chunk``, S) steps; a ragged tail is
    zero-padded (dt = 0 makes a padded step the identity: decay 1, no
    input).  Within a chunk the inclusive cumsum of dt·a gives each
    segment's decay; the masked (future) segments are set to 0 *before*
    ``exp`` and again after it (the reference's double where: their
    exponents are positive and overflow, and inf·0 is NaN).  The chunks'
    states follow the recurrence state' = state·exp(Σ dt·a) + local, a
    Python loop over the chunks."""
    bsz, s_in, nh, hp = x.shape
    n = b_ssm.shape[-1]
    q = min(cfg.ssm_chunk, s_in)
    pad = (-s_in) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_ssm = F.pad(b_ssm, (0, 0, 0, pad))
        c_ssm = F.pad(c_ssm, (0, 0, 0, pad))
    s = s_in + pad
    nc = s // q

    xc = x.reshape(bsz, nc, q, nh, hp).float()
    dtc = dt.reshape(bsz, nc, q, nh)
    bc = b_ssm.reshape(bsz, nc, q, n).float()
    cc = c_ssm.reshape(bsz, nc, q, n).float()

    da = dtc * a  # [B, nc, Q, nh]
    cs = torch.cumsum(da, dim=2)  # inclusive, within a chunk

    # intra-chunk: y[i] += sum_{j<=i} C[i].B[j] exp(cs[i]-cs[j]) dt[j] x[j]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # [B, nc, i, j, nh]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    mask = mask[None, None, :, :, None]
    seg = torch.where(mask, seg, 0.0)
    decay = torch.where(mask, torch.exp(seg), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    scores = cb[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # chunk-local end states: sum_q exp(cs[-1]-cs[q]) dt[q] B[q] (x) x[q]
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)
    local = torch.einsum("bcqn,bcqh,bcqhp->bchpn", bc, decay_end * dtc, xc)

    # the inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(da.sum(dim=2))  # [B, nc, nh]
    state = (torch.zeros((bsz, nh, hp, n), dtype=torch.float32,
                         device=x.device)
             if ssm_state is None else ssm_state.float())
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + local[:, c]
    entering = torch.stack(entering, dim=1)  # [B, nc, nh, hp, N]

    # inter-chunk term: y[q] += C[q] . (exp(cs[q]) * state entering)
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cc, torch.exp(cs),
                           entering)
    y = (y_intra + y_inter).reshape(bsz, s, nh, hp)
    return y[:, :s_in], state


def apply_mamba(p, cfg, x, *, ssm_state=None, return_state=False,
                return_cache=False):
    """The Mamba2 block over a whole sequence: x [B, S, d] -> [B, S, d].
    ``return_state`` also returns the final SSM state; ``return_cache``
    the final state and the conv tail, the last K-1 rows of the raw
    ``[x_part, bc_part]`` (left-padded with zeros for a prompt shorter
    than K-1, the rows a decode from a zero cache would hold; the
    reference serves no such prompt)."""
    bsz, s, _ = x.shape
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hp = cfg.ssm_headdim
    z = x @ p["z_proj"]
    x_part = x @ p["x_proj"]
    bc_part = torch.cat([x @ p["b_proj"], x @ p["c_proj"]], dim=-1)
    dt_raw = x @ p["dt_proj"]

    x_conv = _causal_conv(cfg, x_part, p["conv_x"], p["conv_bx"])
    bc_conv = _causal_conv(cfg, bc_part, p["conv_bc"], p["conv_bc_bias"])
    b_ssm, c_ssm = bc_conv[..., :ns], bc_conv[..., ns:]
    x_ssd = x_conv.reshape(bsz, s, nh, hp)
    dt = softplus(dt_raw.float() + p["dt_bias"])  # [B, S, nh]
    a = -torch.exp(p["A_log"])

    y, final_state = _ssd_chunked(cfg, x_ssd, dt, b_ssm, c_ssm, a, ssm_state)
    y = y + x_ssd.float() * p["D"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = y * F.silu(z)
    y = L.rmsnorm(y, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_cache:
        tail = cfg.ssm_conv - 1
        raw = torch.cat([x_part, bc_part], dim=-1)
        if s < tail:
            raw = F.pad(raw, (0, 0, tail - s, 0))
        return out, final_state, raw[:, raw.shape[1] - tail:]
    if return_state:
        return out, final_state
    return out


def init_mamba_cache(cfg, batch, dtype=torch.float32, device="cuda"):
    di, ns = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * ns),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim, ns),
                           dtype=torch.float32, device=device),
    }


def apply_mamba_step(p, cfg, x, cache):
    """One-token decode: x [B, 1, d], cache {conv, ssm} -> (y [B, 1, d],
    the new cache).  The window is ``[conv state, new xbc row]`` in their
    promoted dtype (the decode passes an fp32 conv state), its taps summed
    in fp32; the state update exp(dt·a)·state + dt·B (x) x in fp32; the
    output cast to x's dtype before the gate, the norm before
    ``out_proj``.  Nothing waits on the host, so the step captures in a
    CUDA graph."""
    bsz = x.shape[0]
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hp = cfg.ssm_headdim
    x0 = x[:, 0]
    z = x0 @ p["z_proj"]
    xbc = torch.cat([x0 @ p["x_proj"], x0 @ p["b_proj"], x0 @ p["c_proj"]],
                    dim=-1)
    dt_raw = x0 @ p["dt_proj"]

    conv = cache["conv"]
    wdt = torch.promote_types(conv.dtype, xbc.dtype)
    window = torch.cat([conv.to(wdt), xbc[:, None, :].to(wdt)], dim=1)
    w = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1).float()
    bias = torch.cat([p["conv_bx"], p["conv_bc_bias"]], dim=-1).float()
    xbc_out = (window.float() * w).sum(dim=1) + bias
    xbc_out = F.silu(xbc_out).to(x.dtype)
    new_conv = window[:, 1:]

    x_ssd = xbc_out[..., :di].reshape(bsz, nh, hp).float()
    b_ssm = xbc_out[..., di:di + ns].float()
    c_ssm = xbc_out[..., di + ns:].float()
    dt = softplus(dt_raw.float() + p["dt_bias"])  # [B, nh]
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a)
    new_ssm = cache["ssm"] * decay[:, :, None, None] + (
        (dt[:, :, None] * x_ssd)[..., None] * b_ssm[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", c_ssm, new_ssm)
    y = y + x_ssd * p["D"][None, :, None]
    y = y.reshape(bsz, di).to(x.dtype)
    y = y * F.silu(z)
    y = L.rmsnorm(y, p["norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"conv": new_conv, "ssm": new_ssm}
