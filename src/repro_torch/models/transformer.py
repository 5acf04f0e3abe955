"""Decoder-only LM of the dense, vlm and MoE families, with GQA or MLA
attention (the port of ``repro.models.transformer``).

Parameters are a plain dict: ``embed`` [V, d], ``ln_f``, a ``layers``
list of per-layer dicts (the reference stacks them along a leading L axis
in two groups, ``dense_layers`` and ``moe_layers``, and runs
``lax.scan`` over each; a Python loop over the dense layers, then the MoE
ones, takes its place here) and, for untied heads, ``lm_head`` [d, V].
A layer's ``attn`` holds GQA attention's projections
(``layers.init_attention``) or, with ``cfg.use_mla`` (deepseek-v2), MLA's
(``models/mla.py``).  A dense layer holds ``mlp``, an MoE layer ``moe``
(``models/moe.py``); an MoE config starts with ``moe_first_dense`` dense
layers (``layer_split``).  A vlm config (``vlm_patches`` > 0) adds
``patch_proj`` [d, d]: its precomputed patch embeddings [B, P, d] pass
through it (``vlm.patch_proj``) and come before the text's
(``embed_tokens``), so a prefill's hidden sequence and cache hold P + S
rows.  ``convert.params_from_jax`` turns the reference's tree into this
form.

The serving cache is ``{"k", "v": [L, B, S, Hkv, hd], "pos": [B] int32}``
(MLA: the compressed ``{"ckv": [L, B, S, kv_lora_rank], "kr": [L, B, S,
rope_head_dim]}`` with ``pos``) and ``decode_step`` updates it in place
(MLA decodes in the absorbed form).  The block-paged engine's pools are
the same leaves as ``[L, NB + 1, bs, ...]`` block pools
(``init_paged_pools``; the last block is the sink of inactive lanes'
writes) and ``decode_step_paged`` writes them in place through per-lane
block tables.

Training: ``loss_fn`` is the reference's masked next-token cross-entropy
(``logit_chunk`` chunks the lm_head and the loss over the sequence; a
vlm's over its text rows only) plus ``1e-2`` times the MoE layers'
summed load-balance terms; with ``cfg.remat`` "full" or "dots" and grad
enabled, ``forward`` runs each layer under ``torch.utils.checkpoint``
(``checkpointed``), as the reference's ``jax.checkpoint`` around its
scanned block, "dots" with the reference's policy
``dots_with_no_batch_dims_saveable`` (``_dots_policy``).  Serving
runs under ``no_grad``, never takes that path and computes no
load-balance term.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.planned import planned_dense, planned_executing
from repro_torch.parallel.sharding import carry_context

from . import layers as L
from . import mla as MLA
from . import moe as MOE

CACHE_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def cache_dtype_of(cfg) -> torch.dtype:
    return CACHE_DTYPES[cfg.kv_cache_dtype]


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not a decoder-only LM; this module "
            "runs the dense, vlm and MoE families")


def cache_rows(cfg) -> dict:
    """The two per-layer cache leaves, each with the shape of one token's
    row in it: GQA's K/V, or MLA's latent and shared rope key."""
    if cfg.use_mla:
        return {"ckv": (cfg.kv_lora_rank,), "kr": (cfg.rope_head_dim,)}
    return dict.fromkeys(("k", "v"), (cfg.n_kv_heads, cfg.hd))


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
    layer's block from ``moe.init_moe``; a vlm's ``patch_proj`` last."""
    _check_family(cfg)
    dt = L.compute_dtype(cfg)
    n_dense, _ = layer_split(cfg)
    init_attn = MLA.init_mla if cfg.use_mla else L.init_attention
    layers = []
    for i in range(cfg.n_layers):
        layer = {"ln1": L.init_norm(cfg, device),
                 "attn": init_attn(cfg, generator, device),
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
    if cfg.vlm_patches:
        p["patch_proj"] = L.dense_init(generator, cfg.d_model, cfg.d_model,
                                       dt, device)
    return p


def layer_specs(cfg, *, moe: bool) -> dict:
    """One layer's logical axes: its attention's (GQA or MLA), its norms'
    and its MLP's or MoE block's."""
    return {
        "ln1": L.norm_specs(cfg),
        "attn": MLA.mla_specs(cfg) if cfg.use_mla else L.attention_specs(cfg),
        "ln2": L.norm_specs(cfg),
        **({"moe": MOE.moe_specs(cfg)} if moe else {"mlp": L.mlp_specs(cfg)}),
    }


def param_specs(cfg) -> dict:
    """``init_params``' tree of logical axes: ``layers`` one entry a
    layer (the reference's stacked groups carry a leading ``layers``
    axis instead)."""
    n_dense, _ = layer_split(cfg)
    s = {
        "embed": ("vocab", "d_model"),
        "ln_f": L.norm_specs(cfg),
        "layers": [layer_specs(cfg, moe=i >= n_dense)
                   for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ("d_model", "vocab")
    if cfg.vlm_patches:
        s["patch_proj"] = ("d_model", None)
    return s


def cache_specs(cfg) -> dict:
    """``init_cache``'s tree of logical axes."""
    if cfg.use_mla:
        return {
            "ckv": ("layers", "batch", None, None),
            "kr": ("layers", "batch", None, None),
            "pos": ("batch",),
        }
    return {
        "k": ("layers", "batch", None, "kv_heads", None),
        "v": ("layers", "batch", None, "kv_heads", None),
        "pos": ("batch",),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(p, cfg, tokens, extra_embeds=None):
    """tokens [B, S] -> [B, S, d]; with a vlm's patch embeddings
    ``extra_embeds`` [B, P, d] (cast to the compute dtype, then through
    ``patch_proj`` at ``vlm.patch_proj``) first -> [B, P + S, d]."""
    x = p["embed"][tokens.long()].to(L.compute_dtype(cfg))
    if extra_embeds is None:
        return x
    pe = extra_embeds.to(device=x.device, dtype=x.dtype)
    if "patch_proj" in p:
        pe = planned_dense(pe, p["patch_proj"], site="vlm.patch_proj")
    return torch.cat([pe, x], dim=1)


def _ffn(lp, cfg, x, with_aux=False):
    """The layer's feed-forward half on its pre-norm input: the MLP of a
    dense layer, the expert block of an MoE one (at decode every lane
    routes, inactive ones too, as in the reference).  With ``with_aux``
    (the full-sequence forward): (y, the layer's load-balance term, 0
    for a dense layer)."""
    if "moe" in lp:
        return MOE.apply_moe(lp["moe"], cfg, x, with_aux)
    y = L.apply_mlp(lp["mlp"], cfg, x)
    return (y, 0.0) if with_aux else y


def _block(lp, cfg, x, positions, with_aux=False):
    """One layer over a whole sequence: (x', k, v, aux), ``k``/``v`` the
    layer's cache rows (MLA: ckv and kr), ``aux`` its load-balance term
    where ``with_aux`` asks for it (the forward does; prefill does not),
    else None."""
    attend = MLA.apply_mla if cfg.use_mla else L.apply_attention
    attn, k, v = attend(lp["attn"], cfg, L.apply_norm(lp["ln1"], cfg, x),
                        positions)
    x = x + attn
    h = L.apply_norm(lp["ln2"], cfg, x)
    y, aux = (_ffn(lp, cfg, h, True) if with_aux
              else (_ffn(lp, cfg, h), None))
    return x + y, k, v, aux


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def remat(cfg) -> str | None:
    """How a layer's activations are recomputed in the backward pass:
    ``cfg.remat`` ("full" or "dots") while grad is enabled, else None."""
    if not torch.is_grad_enabled() or cfg.remat == "none":
        return None
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat must be none|dots|full, got {cfg.remat!r}")
    return cfg.remat


#: the products without batch dimensions (``torch.matmul`` of a [.., K]
#: activation and a [K, N] weight folds into ``aten.mm``)
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, func, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: a
    product without batch dimensions (``aten.mm``/``addmm``) is saved, all
    else recomputed.  A planned product is opaque to it, as the
    reference's ``custom_vjp`` around its kernel is to JAX's policy: the
    ops a planned Function dispatches are recomputed with it."""
    if func in _NO_BATCH_DOTS and not planned_executing():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def checkpointed(mode, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` for ``mode`` (the
    reference's ``_maybe_remat``): "full" recomputes everything in the
    backward, "dots" saves the unplanned products without batch
    dimensions (``_dots_policy``), None runs ``fn`` plainly.  The
    recomputation runs under the forward's mesh context
    (``sharding.carry_context``)."""
    if mode is None:
        return fn(*args)
    fn = carry_context(fn)
    if mode == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_contexts)
    return checkpoint(fn, *args, use_reentrant=False)


def run_layers(cfg, layer, x, stack):
    """``x`` (a tensor or a tuple of them) through ``layer(x, lp)`` for
    each layer's parameters in ``stack``, each under ``checkpointed`` as
    ``remat`` says."""
    mode = remat(cfg)
    for lp in stack:
        x = checkpointed(mode, layer, x, lp)
    return x


def forward(p, cfg, tokens, extra_embeds=None):
    """Full-sequence forward -> (hidden, aux): the final-norm hidden
    states [B, S, d] (a vlm's [B, P + S, d], its patch rows first) and
    the MoE layers' load-balance terms summed in layer order (0 for the
    dense and vlm families)."""
    _check_family(cfg)
    x = embed_tokens(p, cfg, tokens, extra_embeds)
    positions = _positions(x)

    def layer(carry, lp):
        x, _, _, aux = _block(lp, cfg, carry[0], positions, with_aux=True)
        return x, carry[1] + aux

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = run_layers(cfg, layer, (x, zero), p["layers"])
    return L.apply_norm(p["ln_f"], cfg, x), aux


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
    masked) and, for a vlm, extra_embeds [B, P, d].  The mean
    cross-entropy over the unmasked positions of the text (a vlm's patch
    rows carry no label), plus ``1e-2 * aux`` (the MoE layers' summed
    load-balance terms; 0 for the dense and vlm families).  With
    ``cfg.logit_chunk`` below S, the lm_head and the loss run over chunks
    of that many positions, so the [B, S, V] logits never exist at
    once."""
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux = forward(p, cfg, tokens, batch.get("extra_embeds"))
    if cfg.vlm_patches:
        hidden = hidden[:, -tokens.shape[1]:]
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
    return total / torch.clamp(mask.sum(), min=1.0) + 1e-2 * aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_seq, dtype=torch.bfloat16, device="cuda"):
    cache = {name: torch.zeros((cfg.n_layers, batch, max_seq, *row),
                               dtype=dtype, device=device)
             for name, row in cache_rows(cfg).items()}
    cache["pos"] = torch.zeros(batch, dtype=torch.int32, device=device)
    return cache


def prefill(p, cfg, tokens, max_seq, cache_dtype=torch.bfloat16,
            last_index=None, extra_embeds=None):
    """Run the whole prompt, build its cache, return last-token logits:
    (logits [B, V], cache with ``pos`` = prompt length).  A vlm's patch
    embeddings ``extra_embeds`` [B, P, d] come first: the cache then
    holds P + S rows and ``pos`` counts them.

    ``last_index`` ([B] int32, optional) supports *bucketed* prefill:
    ``tokens`` may be right-padded to a bucket length and logits are then
    taken at each lane's last valid token instead of position -1 (offset
    by the patch rows), with ``cache["pos"]`` set past it.  Pad rows land
    in the cache but the decode mask (``kpos <= pos``) hides them until
    overwritten."""
    _check_family(cfg)
    b, s = tokens.shape
    x = embed_tokens(p, cfg, tokens, extra_embeds)
    rows = x.shape[1]
    positions = _positions(x)
    cache = init_cache(cfg, b, max_seq, cache_dtype, x.device)
    kname, vname = cache_rows(cfg)
    for i, lp in enumerate(p["layers"]):
        x, k, v, _ = _block(lp, cfg, x, positions)
        cache[kname][i, :, :rows] = k.to(cache_dtype)
        cache[vname][i, :, :rows] = v.to(cache_dtype)
    x = L.apply_norm(p["ln_f"], cfg, x)
    sel, pos = L.last_rows(x, last_index, offset=rows - s)
    logits = logits_fn(p, cfg, sel)[:, 0]
    cache["pos"].copy_(pos)
    return logits, cache


def decode_step(p, cfg, cache, tokens):
    """tokens [B, 1] -> (logits [B, V], cache).  The cache is updated in
    place — each layer writes its new K/V row, then ``pos`` advances —
    and returned for symmetry with the reference."""
    pos = cache["pos"]
    kname, vname = cache_rows(cfg)
    attend = MLA.apply_mla_decode if cfg.use_mla \
        else L.apply_attention_decode
    x = embed_tokens(p, cfg, tokens)
    for i, lp in enumerate(p["layers"]):
        h = L.apply_norm(lp["ln1"], cfg, x)
        x = x + attend(lp["attn"], cfg, h, cache[kname][i],
                       cache[vname][i], pos)
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
    there are no per-lane leaves for this family (MLA: the latent and
    the rope key)."""
    return dict.fromkeys(cache_rows(cfg), "paged")


def init_paged_pools(cfg, num_blocks, block_size, max_lanes,
                     dtype=torch.bfloat16, device="cuda"):
    del max_lanes  # no per-lane state in this family
    return {name: torch.zeros((cfg.n_layers, num_blocks, block_size, *row),
                              dtype=dtype, device=device)
            for name, row in cache_rows(cfg).items()}


def decode_step_paged(p, cfg, pools, tokens, block_tables, pos, active):
    """Block-paged decode: tokens [B,1]; block_tables [B,T] int32; pos
    [B] int32; active [B] bool -> (logits [B,V], pools), the pools
    written in place (each layer's new K/V row; an inactive lane's to the
    sink block).

    ``pos``/tables/``active`` are host-owned inputs that the step never
    changes (the engine advances pos and edits tables between steps), so
    the step's shapes never depend on which requests are in flight."""
    kname, vname = cache_rows(cfg)
    attend = MLA.apply_mla_decode_paged if cfg.use_mla \
        else L.apply_attention_decode_paged
    x = embed_tokens(p, cfg, tokens)
    for i, lp in enumerate(p["layers"]):
        h = L.apply_norm(lp["ln1"], cfg, x)
        x = x + attend(lp["attn"], cfg, h, pools[kname][i], pools[vname][i],
                       block_tables, pos, active)
        x = x + _ffn(lp, cfg, L.apply_norm(lp["ln2"], cfg, x))
    x = L.apply_norm(p["ln_f"], cfg, x)
    return logits_fn(p, cfg, x)[:, 0], pools
