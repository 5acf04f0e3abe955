"""Config registry of the port: the archs it runs.

``get_config(arch)`` gives the published full-width configuration and
``get_smoke_config(arch)`` the reduced one the tests use; both are copies
of the reference's configs.  The port registers the archs it serves and
trains: the dense decoders qwen1.5-0.5b, qwen3-32b, stablelm-12b and
codeqwen1.5-7b (its KV cache in fp8 e4m3); llava-next-mistral-7b (vlm:
the dense backbone with precomputed patch embeddings prepended);
olmoe-1b-7b (MoE) and deepseek-v2-236b (MoE with MLA attention and
shared experts; its 236 B parameters fit no one card at full depth);
mamba2-780m (SSM) and zamba2-1.2b (hybrid) on a recurrent state;
whisper-base (encdec: precomputed frames and streamed audio).
``"widesa-paper"`` names the paper's Table II benchmark suite
(``core.recurrence.PAPER_BENCHMARKS``), a pseudo-config that no engine
serves, as in the reference.
"""

from __future__ import annotations

import importlib

from .base import LONG_CONTEXT_ARCHS, SHAPES, ModelConfig, ShapeSpec, cells_for

_ARCH_MODULES = {
    "qwen1.5-0.5b": "qwen15_05b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-780m": "mamba2_780m",
    "zamba2-1.2b": "zamba2_12b",
    "qwen3-32b": "qwen3_32b",
    "stablelm-12b": "stablelm_12b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-base": "whisper_base",
    "widesa-paper": "widesa_paper",
}

ARCHS = [a for a in _ARCH_MODULES if a != "widesa-paper"]


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise ValueError(
            f"arch {arch!r} is not ported; the port runs the archs "
            f"{ARCHS}")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = [
    "ARCHS", "SHAPES", "LONG_CONTEXT_ARCHS", "ModelConfig", "ShapeSpec",
    "cells_for", "get_config", "get_smoke_config",
]
