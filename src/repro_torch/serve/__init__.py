"""Serving stack of the port: the slot engine behind ``make_engine`` and
the planned audio frontend of streamed encdec requests."""

from .api import EngineBase, Request, make_engine, validate_request
from .engine import ServeEngine
from .frontend import AudioFrontend, FrontendConfig, synth_samples

__all__ = ["AudioFrontend", "EngineBase", "FrontendConfig", "Request",
           "ServeEngine", "make_engine", "synth_samples",
           "validate_request"]
