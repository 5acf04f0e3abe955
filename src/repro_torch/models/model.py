"""Model API of the port — the contract the serving engine uses.

    api = build_model(cfg, device="cuda")
    params = api.init(generator)
    logits, cache = api.prefill(params, {"tokens": tokens}, max_seq)
    logits, cache = api.decode(params, cache, tokens)

The dense and encdec families are ported; the others raise.  encdec
serves streamed audio: ``enc_init(b, f_max)`` builds the incremental
encoder state, ``enc_step(p, ec, frames_chunk)`` appends one chunk and
returns its encoder states, ``enc_kv(p, enc)`` projects them to
per-decoder-layer cross K/V, and ``stream_prefill(p, enc_k, enc_v,
enc_len, tokens, max_seq)`` is the decoder prompt pass against a
partially filled encoder cache.  Its offline ``prefill`` over
precomputed frames is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig

from . import encdec as ENCDEC
from . import transformer as TFM


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    # streaming (chunked) admission — encdec only
    enc_init: Callable | None = None
    enc_step: Callable | None = None
    enc_kv: Callable | None = None
    stream_prefill: Callable | None = None


def build_model(cfg: ModelConfig, device="cuda") -> ModelAPI:
    device = torch.device(device)
    cache_dtype = TFM.cache_dtype_of(cfg)
    if cfg.family == "encdec":
        return _encdec_api(cfg, device, cache_dtype)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; the port serves dense "
            "decoders and encdec streaming")

    def prefill(p, batch, max_seq):
        return TFM.prefill(p, cfg, batch["tokens"], max_seq,
                           cache_dtype=cache_dtype)

    return ModelAPI(
        cfg=cfg,
        device=device,
        init=lambda generator: TFM.init_params(cfg, generator, device),
        prefill=prefill,
        decode=lambda p, cache, tokens: TFM.decode_step(p, cfg, cache,
                                                        tokens),
        init_cache=lambda b, s: TFM.init_cache(cfg, b, s, cache_dtype,
                                               device),
    )


def _encdec_api(cfg: ModelConfig, device: torch.device,
                cache_dtype: torch.dtype) -> ModelAPI:
    def prefill(p, batch, max_seq):
        raise NotImplementedError(
            "offline encdec prefill over precomputed frames is not ported; "
            "submit the audio with submit_audio_stream")

    return ModelAPI(
        cfg=cfg,
        device=device,
        init=lambda generator: ENCDEC.init_params(cfg, generator, device),
        prefill=prefill,
        decode=lambda p, cache, tokens: ENCDEC.decode_step(p, cfg, cache,
                                                           tokens),
        init_cache=lambda b, s: ENCDEC.init_cache(
            cfg, b, s, dtype=cache_dtype, device=device),
        enc_init=lambda b, f_max=None: ENCDEC.init_enc_cache(
            cfg, b, f_max, device),
        enc_step=lambda p, ec, fc: ENCDEC.encode_chunk(p, cfg, ec, fc),
        enc_kv=lambda p, enc: ENCDEC.enc_kv_chunk(p, cfg, enc, cache_dtype),
        stream_prefill=lambda p, ek, ev, el, tk, ms: ENCDEC.prefill_decoder(
            p, cfg, ek, ev, el, tk, ms, cache_dtype=cache_dtype),
    )
