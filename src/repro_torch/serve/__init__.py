"""Serving stack of the port: the slot and block-paged engines behind
``make_engine``, the paged cache and its scheduler, and the planned audio
frontend of streamed encdec requests."""

from .api import EngineBase, Request, make_engine, validate_request
from .engine import PagedServeEngine, ServeEngine
from .frontend import AudioFrontend, FrontendConfig, synth_samples
from .paged_cache import BlockAllocator, PagedKVCache
from .scheduler import Scheduler, SchedulerConfig

__all__ = ["AudioFrontend", "BlockAllocator", "EngineBase",
           "FrontendConfig", "PagedKVCache", "PagedServeEngine", "Request",
           "Scheduler", "SchedulerConfig", "ServeEngine", "make_engine",
           "synth_samples", "validate_request"]
