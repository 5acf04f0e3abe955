"""The SSM (mamba2) and hybrid (zamba2) families of the port
(``repro.models.hybrid``), on one device.

A trunk of Mamba2 blocks (``models/ssm.py``), each pre-normed and added
to the residual; a hybrid config (``attn_every`` = k > 0) applies ONE
weight-shared block (attention + GLU MLP) after every k trunk layers,
``n_layers // k`` times, each application with a KV cache of its own.
A pure SSM config (``attn_every`` = 0) has no shared block.

Parameters are a plain dict: ``embed`` [V, d], ``trunk`` (a list of
per-layer ``{"ln", "mamba"}`` dicts; the reference stacks them along a
leading L axis and scans), ``ln_f``, ``lm_head`` [d, V] and, for
hybrid, ``shared`` (``ln1``, ``attn``, ``ln2``, ``mlp``).

The serving cache is ``{"conv": [L, B, K-1, d_inner + 2N]`` (the cache
dtype), ``"ssm": [L, B, nh, headdim, N]`` (fp32), ``"pos": [B] int32``,
and for hybrid ``"k", "v": [n_apps, B, S, Hkv, hd]}``; ``decode_step``
updates it in place.  The block-paged engine's pools hold ``conv`` and
``ssm`` as ``lane`` leaves, [L, max_lanes, ...] (a lane's recurrent state
has a fixed size: nothing to page), and ``k``/``v`` as ``paged`` leaves;
``decode_step_paged`` writes all of them in place (``copy_``), so the
captured decode graph, which holds their addresses, sees each step's new
state.  Inactive lanes advance their state as well, as in the
reference: the next admission overwrites it.

The planned GEMMs are the reference's: ``lm_head``, and the shared
block's ``attn.q/k/v`` and ``mlp.*`` in prefill and decode, its
``attn.scores``/``attn.values`` in prefill, the decode attention's
sites and ``attn.out`` at decode and in ``forward``.  Prefill's shared
out projection is a plain product, as the reference's ``@ wo``; the
Mamba2 blocks plan nothing.

Training: ``loss_fn`` is the reference's masked next-token
cross-entropy over the untied ``lm_head``'s fp32 logits.  With
``cfg.remat`` "full" or "dots" and grad enabled, ``forward`` runs each
trunk block and each application of the shared block under
``transformer.checkpointed``, as the reference's ``_maybe_remat``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.planned import planned_dense

from . import layers as L
from . import ssm as SSM
from . import transformer as TFM


def n_attn_apps(cfg) -> int:
    if cfg.attn_every <= 0:
        return 0  # pure SSM (mamba2 family)
    return cfg.n_layers // cfg.attn_every


def _check_family(cfg) -> None:
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(f"family {cfg.family!r} is not ssm or hybrid")


def _shared_after(cfg, i: int) -> int | None:
    """The shared block's application that follows trunk layer ``i``, or
    None: one after every ``attn_every`` layers, ``n_attn_apps`` in all
    (the layers past the last whole segment are the trunk's tail)."""
    every = cfg.attn_every
    if every > 0 and (i + 1) % every == 0:
        return (i + 1) // every - 1
    return None


# ---------------------------------------------------------------------------
# parameters and forward
# ---------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random weights at the config's full width, drawn on ``device``
    from ``generator`` with the reference's scales: the trunk's Mamba2
    blocks (``ssm.init_mamba``), N(0, 0.02) embeddings, N(0, 1/d) head,
    and for hybrid the shared attention and GLU MLP."""
    _check_family(cfg)
    dt = L.compute_dtype(cfg)
    p = {
        "trunk": [{"ln": L.init_norm(cfg, device),
                   "mamba": SSM.init_mamba(cfg, generator, device)}
                  for _ in range(cfg.n_layers)],
        "embed": L.normal(generator, (cfg.vocab, cfg.d_model), 0.02, dt,
                          device),
        "ln_f": L.init_norm(cfg, device),
    }
    if n_attn_apps(cfg):
        p["shared"] = {"ln1": L.init_norm(cfg, device),
                       "attn": L.init_attention(cfg, generator, device),
                       "ln2": L.init_norm(cfg, device),
                       "mlp": L.init_glu_mlp(cfg, generator, device)}
    p["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab, dt,
                                device)
    return p


def param_specs(cfg) -> dict:
    """``init_params``' tree of logical axes (``trunk`` one entry a
    layer)."""
    s = {
        "embed": ("vocab", "d_model"),
        "trunk": [{"ln": L.norm_specs(cfg), "mamba": SSM.mamba_specs(cfg)}
                  for _ in range(cfg.n_layers)],
        "ln_f": L.norm_specs(cfg),
        "lm_head": ("d_model", "vocab"),
    }
    if n_attn_apps(cfg):
        s["shared"] = {
            "ln1": L.norm_specs(cfg),
            "attn": L.attention_specs(cfg),
            "ln2": L.norm_specs(cfg),
            "mlp": L.mlp_specs(cfg),
        }
    return s


def cache_specs(cfg) -> dict:
    """``init_cache``'s tree of logical axes."""
    s = {
        "conv": ("layers", "batch", None, "ssm_heads"),
        "ssm": ("layers", "batch", "ssm_heads", None, None),
        "pos": ("batch",),
    }
    if n_attn_apps(cfg):
        s["k"] = ("layers", "batch", None, "kv_heads", None)
        s["v"] = ("layers", "batch", None, "kv_heads", None)
    return s


def _shared_prefill(sp, cfg, x, positions):
    """The shared block over a whole sequence: (x', k, v).  Its
    projections and attention plan as the reference's; the out
    projection is a plain product, as its ``@ wo``."""
    b, s, _ = x.shape
    h = L.apply_norm(sp["ln1"], cfg, x)
    q, k, v = L._qkv(sp["attn"], cfg, h, positions)
    attn = L.attention_core(q, k, v, causal=True).reshape(b, s, -1)
    x = x + attn @ sp["attn"]["wo"]
    h = L.apply_norm(sp["ln2"], cfg, x)
    return x + L.apply_mlp(sp["mlp"], cfg, h), k, v


def _trunk_block(lp, cfg, x):
    return x + SSM.apply_mamba(lp["mamba"], cfg,
                               L.apply_norm(lp["ln"], cfg, x))


def _shared_block(sp, cfg, x, positions):
    """The shared block as the reference's ``forward`` runs it: its out
    projection planned at ``attn.out``."""
    h = L.apply_norm(sp["ln1"], cfg, x)
    x = x + L.apply_attention(sp["attn"], cfg, h, positions)[0]
    return x + L.apply_mlp(sp["mlp"], cfg, L.apply_norm(sp["ln2"], cfg, x))


def forward(p, cfg, tokens):
    """Full-sequence forward -> final-norm hidden states [B, S, d]; each
    trunk block and shared application under ``transformer.checkpointed``
    as ``transformer.remat`` says."""
    _check_family(cfg)
    x = TFM.embed_tokens(p, cfg, tokens)
    positions = TFM._positions(x)
    mode = TFM.remat(cfg)
    for i, lp in enumerate(p["trunk"]):
        x = TFM.checkpointed(mode, lambda x, lp: _trunk_block(lp, cfg, x),
                             x, lp)
        if _shared_after(cfg, i) is not None:
            x = TFM.checkpointed(
                mode, lambda x, sp: _shared_block(sp, cfg, x, positions), x,
                p["shared"])
    return L.apply_norm(p["ln_f"], cfg, x)


def loss_fn(p, cfg, batch):
    """batch: tokens [B, S], labels [B, S] (a label < 0 is masked) -> the
    mean cross-entropy of the ``lm_head``'s fp32 logits over the unmasked
    positions."""
    hidden = forward(p, cfg, batch["tokens"])
    logits = planned_dense(hidden, p["lm_head"].to(hidden.dtype),
                           site="lm_head")
    labels = batch["labels"]
    mask = (labels >= 0).float()
    total = (TFM.xent(logits, labels.clamp(min=0).long()) * mask).sum()
    return total / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _states(cfg, batch, dtype, device) -> dict:
    """The trunk's zero conv states (``dtype``) and SSM states (fp32),
    [L, batch, ...]."""
    di, ns = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                             di + 2 * ns), dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                            cfg.ssm_headdim, ns), dtype=torch.float32,
                           device=device),
    }


def _kv(cfg, rows, dtype, device) -> dict:
    """The shared applications' zero K/V, [n_apps, *rows, Hkv, hd]; none
    for a pure SSM config."""
    napp = n_attn_apps(cfg)
    if not napp:
        return {}
    shape = (napp, *rows, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device="cuda"):
    return {**_states(cfg, batch, dtype, device),
            "pos": torch.zeros(batch, dtype=torch.int32, device=device),
            **_kv(cfg, (batch, max_seq), dtype, device)}


def prefill(p, cfg, tokens, max_seq, cache_dtype=torch.bfloat16):
    """The whole prompt at its exact length (a pad token would enter the
    recurrent state): each trunk layer's final SSM state and conv tail,
    each shared application's K/V, and the last token's logits ->
    (logits [B, V], cache with ``pos`` = prompt length)."""
    _check_family(cfg)
    b, s = tokens.shape
    x = TFM.embed_tokens(p, cfg, tokens)
    positions = TFM._positions(x)
    cache = init_cache(cfg, b, max_seq, cache_dtype, x.device)
    for i, lp in enumerate(p["trunk"]):
        h = L.apply_norm(lp["ln"], cfg, x)
        out, state, tail = SSM.apply_mamba(lp["mamba"], cfg, h,
                                           return_cache=True)
        x = x + out
        cache["conv"][i] = tail.to(cache_dtype)
        cache["ssm"][i] = state
        app = _shared_after(cfg, i)
        if app is not None:
            x, k, v = _shared_prefill(p["shared"], cfg, x, positions)
            cache["k"][app, :, :s] = k.to(cache_dtype)
            cache["v"][app, :, :s] = v.to(cache_dtype)
    x = L.apply_norm(p["ln_f"], cfg, x)
    cache["pos"].fill_(s)
    return TFM.logits_fn(p, cfg, x[:, -1:])[:, 0], cache


def _decode(p, cfg, conv, ssm, tokens, shared_attention):
    """The one-token step over the trunk's [L, B, ...] conv and SSM
    states, written in place, with ``shared_attention(app, h)`` the
    shared block's attention (which writes its own K/V)."""
    x = TFM.embed_tokens(p, cfg, tokens)
    for i, lp in enumerate(p["trunk"]):
        h = L.apply_norm(lp["ln"], cfg, x)
        out, mc = SSM.apply_mamba_step(
            lp["mamba"], cfg, h, {"conv": conv[i].float(), "ssm": ssm[i]})
        x = x + out
        conv[i].copy_(mc["conv"])
        ssm[i].copy_(mc["ssm"])
        app = _shared_after(cfg, i)
        if app is not None:
            sp = p["shared"]
            x = x + shared_attention(app, L.apply_norm(sp["ln1"], cfg, x))
            x = x + L.apply_mlp(sp["mlp"], cfg,
                                L.apply_norm(sp["ln2"], cfg, x))
    return TFM.logits_fn(p, cfg, L.apply_norm(p["ln_f"], cfg, x))[:, 0]


def decode_step(p, cfg, cache, tokens):
    """tokens [B, 1] -> (logits [B, V], cache), the cache updated in
    place (every lane's states, the shared block's K/V rows, then
    ``pos``) and returned for symmetry with the reference."""
    pos = cache["pos"]

    def attention(app, h):
        return L.apply_attention_decode(p["shared"]["attn"], cfg, h,
                                        cache["k"][app], cache["v"][app],
                                        pos)

    logits = _decode(p, cfg, cache["conv"], cache["ssm"], tokens, attention)
    pos += 1
    return logits, cache


# ---------------------------------------------------------------------------
# block-paged serving
# ---------------------------------------------------------------------------

def paged_layout(cfg) -> dict:
    """The recurrent states are ``lane`` leaves ([L, max_lanes, ...]);
    the shared attention's K/V pages like any transformer cache."""
    layout = {"conv": "lane", "ssm": "lane"}
    if n_attn_apps(cfg):
        layout["k"] = "paged"
        layout["v"] = "paged"
    return layout


def init_paged_pools(cfg, num_blocks, block_size, max_lanes,
                     dtype=torch.bfloat16, device="cuda"):
    return {**_states(cfg, max_lanes, dtype, device),
            **_kv(cfg, (num_blocks, block_size), dtype, device)}


def decode_step_paged(p, cfg, pools, tokens, block_tables, pos, active):
    """Block-paged decode: tokens [B, 1]; block_tables [B, T] int32; pos
    [B] int32; active [B] bool -> (logits [B, V], pools), every pool
    written in place: each lane's conv and SSM states (inactive lanes
    too), each shared application's new K/V row through the block tables
    (an inactive lane's to the sink block)."""

    def attention(app, h):
        return L.apply_attention_decode_paged(
            p["shared"]["attn"], cfg, h, pools["k"][app], pools["v"][app],
            block_tables, pos, active)

    return _decode(p, cfg, pools["conv"], pools["ssm"], tokens,
                   attention), pools
