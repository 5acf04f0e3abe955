"""Model API of the port — the contract the serving engine uses.

    api = build_model(cfg, device="cuda")
    params = api.init(generator)
    logits, cache = api.prefill(params, {"tokens": tokens}, max_seq)
    logits, cache = api.decode(params, cache, tokens)

Only the dense family is ported; the others raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig

from . import transformer as TFM


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable


def build_model(cfg: ModelConfig, device="cuda") -> ModelAPI:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported; the port serves dense "
            "decoders")
    device = torch.device(device)
    cache_dtype = TFM.cache_dtype_of(cfg)

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
