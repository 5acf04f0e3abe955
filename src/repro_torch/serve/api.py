"""Serving surface of the port (text requests).

``Request`` / ``validate_request`` are the reference's request model and
horizon check; ``EngineBase`` owns submission, the drain loop and the
planning context; ``make_engine(cfg, kind="slot")`` is the one
constructor.  The block-paged engine and streaming audio admission are
not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import planned
from repro_torch.models import build_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


def validate_request(prompt, max_new_tokens: int, max_seq: int) -> None:
    """Reject requests that would run past the sequence horizon (the
    decode write would clamp at the last cache row and overwrite it)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    total = len(prompt) + max_new_tokens
    if total > max_seq:
        raise ValueError(
            f"request needs {total} cache rows (prompt {len(prompt)} + "
            f"max_new_tokens {max_new_tokens}) > max_seq {max_seq}: "
            "the decode write would silently clamp at the horizon, "
            "overwriting the last cache row; raise max_seq or shorten "
            "the request")


class EngineBase:
    """Request queue, submission and drain loop shared by the engines."""

    def __init__(self, cfg, *, max_seq: int, policy=None, device="cuda"):
        self.cfg = cfg
        self.policy = policy
        self.device = torch.device(device)
        self.api = build_model(cfg, self.device)
        self.max_seq = max_seq
        self.params = None
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._next_rid = 0
        self.plan_report: dict = {}
        self.autotune_report: dict = {}

    def _plan_ctx(self):
        """The planning override every engine call runs under."""
        return planned.override(policy=self.policy)

    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        prompt = np.asarray(prompt, np.int32)
        validate_request(prompt, max_new_tokens, self.max_seq)
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, max_new_tokens))
        return rid

    submit_text = submit

    def step(self) -> int:  # provided by the engine subclass
        raise NotImplementedError

    def run_until_drained(self, max_steps: int = 1000) -> list[Request]:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
        return self.finished


def make_engine(cfg, kind: str = "slot", **kwargs):
    """The serving-engine constructor; keyword arguments pass through to
    the engine class (``device`` defaults to ``"cuda"``)."""
    from .engine import ServeEngine

    if kind == "slot":
        return ServeEngine(cfg, **kwargs)
    if kind == "paged":
        raise NotImplementedError(
            "the block-paged engine is not ported yet; use kind='slot'")
    raise ValueError(
        f"unknown engine kind {kind!r}: expected 'slot' or 'paged'")
