"""Model stack of the port (dense family)."""

from .model import ModelAPI, build_model

__all__ = ["ModelAPI", "build_model"]
