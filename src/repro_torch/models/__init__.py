"""Model stack of the port (dense, MoE and encdec families)."""

from .model import ModelAPI, build_model

__all__ = ["ModelAPI", "build_model"]
