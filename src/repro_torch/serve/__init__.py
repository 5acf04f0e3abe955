"""Serving stack of the port: the slot engine behind ``make_engine``."""

from .api import EngineBase, Request, make_engine, validate_request
from .engine import ServeEngine

__all__ = ["EngineBase", "Request", "ServeEngine", "make_engine",
           "validate_request"]
