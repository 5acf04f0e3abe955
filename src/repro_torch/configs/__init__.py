"""Config registry of the port: the archs it runs.

``get_config(arch)`` gives the published full-width configuration and
``get_smoke_config(arch)`` the reduced one the tests use; both are copies
of the reference's configs.  The port registers the archs it runs
(qwen1.5-0.5b serves text; whisper-base serves streamed audio; qwen3-32b's
grouped KV heads are held against the reference in the tests); every
other arch is not ported yet and raises.
"""

from __future__ import annotations

import importlib

from .base import ModelConfig

_ARCH_MODULES = {
    "qwen1.5-0.5b": "qwen15_05b",
    "qwen3-32b": "qwen3_32b",
    "whisper-base": "whisper_base",
}

ARCHS = list(_ARCH_MODULES)


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


__all__ = ["ARCHS", "ModelConfig", "get_config", "get_smoke_config"]
