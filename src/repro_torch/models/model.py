"""Model API of the port — the contract the serving engine and the
trainer use.

    api = build_model(cfg, device="cuda")
    params = api.init(generator)
    loss = api.loss(params, {"tokens": tokens, "labels": labels})
    loss = api.loss(params, {"frames": frames, "tokens": tokens,
                             "labels": labels})                  # encdec
    loss = api.loss(params, {"tokens": tokens, "labels": labels,
                             "extra_embeds": patches})           # vlm
    logits, cache = api.prefill(params, {"tokens": tokens}, max_seq)
    logits, cache = api.prefill(params, {"tokens": tokens,
                                         "frames": frames}, max_seq)  # encdec
    logits, cache = api.prefill(params, {"tokens": tokens,
                                         "extra_embeds": patches},
                                max_seq)                          # vlm
    logits, cache = api.decode(params, cache, tokens)
    pools = api.paged_init(num_blocks, block_size, max_lanes)
    logits, pools = api.paged_decode(params, pools, tokens, tables, pos,
                                     active)

``prefill`` and ``stream_prefill`` take ``last_index`` ([B] int32) for a
bucketed prompt: the logits come from each lane's last real token.
``paged_layout()`` maps each pool leaf to ``"paged"`` (a block pool
indexed through the block tables), ``"lane"`` (one fixed-size block a
lane) or ``"lane_scalar"`` (one scalar a lane); ``paged_decode`` writes
the pools in place and never moves ``pos``.

The dense, vlm, MoE (GQA or MLA attention: deepseek-v2 decodes in
MLA's absorbed form over a compressed latent cache), SSM, hybrid and
encdec families are ported.  A vlm's prefill takes the batch's
precomputed patch embeddings ``extra_embeds`` [B, P, d], prepended to the
prompt (its cache then holds P + S rows).  The SSM and hybrid families
prefill at the exact prompt length only: their ``prefill`` refuses a
``last_index`` (a pad token would enter the recurrent state).  encdec's
``prefill`` encodes the batch's precomputed ``frames`` [B, F, d] and runs
the prompt against their cross K/V.  It also serves streamed audio:
``enc_init(b, f_max)`` builds the incremental encoder state,
``enc_step(p, ec, frames_chunk)`` appends one chunk and returns its
encoder states, ``enc_kv(p, enc)`` projects them to per-decoder-layer
cross K/V, and ``stream_prefill(p, enc_k, enc_v, enc_len, tokens,
max_seq)`` is the decoder prompt pass against a partially filled encoder
cache.

``param_logical()``, ``cache_logical()`` and ``batch_logical()`` are the
logical axes of ``init``'s parameters, ``init_cache``'s cache and a
training batch, trees of the same structure with tuples of axis names
at the leaves (``parallel/sharding.py`` resolves them against a mesh's
rules); the parameters' follow the port's per-layer lists.

``batch_specs(shape)`` gives, for a ``configs.ShapeSpec``, the shape and
dtype of every input of a step at that cell as a ``TensorSpec`` (the
port's counterpart of ``jax.ShapeDtypeStruct``: a frozen shape and
dtype, no tensor), keyed as ``batch_logical()``: ``tokens`` and
``labels`` [B, S] int32, a vlm's text ``S - vlm_patches`` long beside
its ``extra_embeds`` [B, P, d] bf16, encdec's ``frames`` [B, F, d] bf16.
The dry run (``launch/dryrun.py``) makes fake tensors of them.

``loss`` is the reference's training loss of every ported family (the
masked mean next-token cross-entropy: ``transformer.loss_fn``, with the
MoE family's ``1e-2`` load-balance term and a vlm's text rows only,
``hybrid.loss_fn``, ``encdec.loss_fn``), differentiable by
``torch.autograd`` through the planned GEMMs' backward passes
(``kernels/planned.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig

from . import encdec as ENCDEC
from . import hybrid as HYBRID
from . import transformer as TFM


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of a model input (``jax.ShapeDtypeStruct``)."""

    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = self.dtype.itemsize
        for extent in self.shape:
            n *= extent
        return n


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    # training loss
    loss: Callable | None = None
    # logical axes of the parameters, the cache and a training batch
    param_logical: Callable | None = None
    cache_logical: Callable | None = None
    batch_logical: Callable | None = None
    # the inputs' shapes and dtypes at a ShapeSpec
    batch_specs: Callable | None = None
    # block-paged serving (continuous batching)
    paged_init: Callable | None = None
    paged_decode: Callable | None = None
    paged_layout: Callable | None = None
    # streaming (chunked) admission — encdec only
    enc_init: Callable | None = None
    enc_step: Callable | None = None
    enc_kv: Callable | None = None
    stream_prefill: Callable | None = None


def _token_batch_specs(cfg, shape) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        s_text = s - cfg.vlm_patches
        return {
            "tokens": TensorSpec((b, s_text), torch.int32),
            "labels": TensorSpec((b, s_text), torch.int32),
            "extra_embeds": TensorSpec((b, cfg.vlm_patches, cfg.d_model),
                                       torch.bfloat16),
        }
    if cfg.family == "encdec":
        return {
            "frames": TensorSpec((b, cfg.enc_frames, cfg.d_model),
                                 torch.bfloat16),
            "tokens": TensorSpec((b, s), torch.int32),
            "labels": TensorSpec((b, s), torch.int32),
        }
    return {"tokens": TensorSpec((b, s), torch.int32),
            "labels": TensorSpec((b, s), torch.int32)}


def _token_batch_logical(cfg) -> dict:
    base = {"tokens": ("batch", None), "labels": ("batch", None)}
    if cfg.family == "vlm":
        base["extra_embeds"] = ("batch", None, None)
    if cfg.family == "encdec":
        base["frames"] = ("batch", None, None)
    return base


def build_model(cfg: ModelConfig, device="cuda") -> ModelAPI:
    device = torch.device(device)
    cache_dtype = TFM.cache_dtype_of(cfg)
    if cfg.family == "encdec":
        return _encdec_api(cfg, device, cache_dtype)
    if cfg.family in ("ssm", "hybrid"):
        return _hybrid_api(cfg, device, cache_dtype)
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; the port serves dense, "
            "vlm and MoE decoders, SSM and hybrid models, and encdec")

    def prefill(p, batch, max_seq, last_index=None):
        return TFM.prefill(p, cfg, batch["tokens"], max_seq,
                           cache_dtype=cache_dtype, last_index=last_index,
                           extra_embeds=batch.get("extra_embeds"))

    return ModelAPI(
        cfg=cfg,
        device=device,
        init=lambda generator: TFM.init_params(cfg, generator, device),
        loss=lambda p, batch: TFM.loss_fn(p, cfg, batch),
        param_logical=lambda: TFM.param_specs(cfg),
        cache_logical=lambda: TFM.cache_specs(cfg),
        batch_logical=lambda: _token_batch_logical(cfg),
        batch_specs=lambda shape: _token_batch_specs(cfg, shape),
        prefill=prefill,
        decode=lambda p, cache, tokens: TFM.decode_step(p, cfg, cache,
                                                        tokens),
        init_cache=lambda b, s: TFM.init_cache(cfg, b, s, cache_dtype,
                                               device),
        paged_init=lambda nb, bs, lanes: TFM.init_paged_pools(
            cfg, nb, bs, lanes, cache_dtype, device),
        paged_decode=lambda p, pools, t, bt, pos, act:
            TFM.decode_step_paged(p, cfg, pools, t, bt, pos, act),
        paged_layout=lambda: TFM.paged_layout(cfg),
    )


def _hybrid_api(cfg: ModelConfig, device: torch.device,
                cache_dtype: torch.dtype) -> ModelAPI:
    def prefill(p, batch, max_seq, last_index=None):
        if last_index is not None:
            raise ValueError(
                "bucketed (padded) prefill is not supported for "
                "ssm/hybrid: the recurrent SSM state would absorb "
                "pad tokens; prefill at the exact prompt length")
        return HYBRID.prefill(p, cfg, batch["tokens"], max_seq,
                              cache_dtype=cache_dtype)

    return ModelAPI(
        cfg=cfg,
        device=device,
        init=lambda generator: HYBRID.init_params(cfg, generator, device),
        loss=lambda p, batch: HYBRID.loss_fn(p, cfg, batch),
        param_logical=lambda: HYBRID.param_specs(cfg),
        cache_logical=lambda: HYBRID.cache_specs(cfg),
        batch_logical=lambda: _token_batch_logical(cfg),
        batch_specs=lambda shape: _token_batch_specs(cfg, shape),
        prefill=prefill,
        decode=lambda p, cache, tokens: HYBRID.decode_step(p, cfg, cache,
                                                           tokens),
        init_cache=lambda b, s: HYBRID.init_cache(cfg, b, s, cache_dtype,
                                                  device),
        paged_init=lambda nb, bs, lanes: HYBRID.init_paged_pools(
            cfg, nb, bs, lanes, cache_dtype, device),
        paged_decode=lambda p, pools, t, bt, pos, act:
            HYBRID.decode_step_paged(p, cfg, pools, t, bt, pos, act),
        paged_layout=lambda: HYBRID.paged_layout(cfg),
    )


def _encdec_api(cfg: ModelConfig, device: torch.device,
                cache_dtype: torch.dtype) -> ModelAPI:
    def prefill(p, batch, max_seq, last_index=None):
        return ENCDEC.prefill(p, cfg, batch["frames"], batch["tokens"],
                              max_seq, cache_dtype=cache_dtype,
                              last_index=last_index)

    return ModelAPI(
        cfg=cfg,
        device=device,
        init=lambda generator: ENCDEC.init_params(cfg, generator, device),
        loss=lambda p, batch: ENCDEC.loss_fn(p, cfg, batch),
        param_logical=lambda: ENCDEC.param_specs(cfg),
        cache_logical=lambda: ENCDEC.cache_specs(cfg),
        batch_logical=lambda: _token_batch_logical(cfg),
        batch_specs=lambda shape: _token_batch_specs(cfg, shape),
        prefill=prefill,
        decode=lambda p, cache, tokens: ENCDEC.decode_step(p, cfg, cache,
                                                           tokens),
        init_cache=lambda b, s: ENCDEC.init_cache(
            cfg, b, s, dtype=cache_dtype, device=device),
        paged_init=lambda nb, bs, lanes: ENCDEC.init_paged_pools(
            cfg, nb, bs, lanes, cache_dtype, device),
        paged_decode=lambda p, pools, t, bt, pos, act:
            ENCDEC.decode_step_paged(p, cfg, pools, t, bt, pos, act),
        paged_layout=lambda: ENCDEC.paged_layout(cfg),
        enc_init=lambda b, f_max=None: ENCDEC.init_enc_cache(
            cfg, b, f_max, device),
        enc_step=lambda p, ec, fc: ENCDEC.encode_chunk(p, cfg, ec, fc),
        enc_kv=lambda p, enc: ENCDEC.enc_kv_chunk(p, cfg, enc, cache_dtype),
        stream_prefill=lambda p, ek, ev, el, tk, ms, last_index=None:
            ENCDEC.prefill_decoder(p, cfg, ek, ev, el, tk, ms,
                                   cache_dtype=cache_dtype,
                                   last_index=last_index),
    )
