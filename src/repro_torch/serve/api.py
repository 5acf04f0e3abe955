"""Serving surface of the port: text requests and streamed audio.

``Request`` / ``validate_request`` are the reference's request model and
horizon check; ``EngineBase`` owns submission (``submit`` /
``submit_text`` for token prompts, ``submit_audio_stream`` for raw
audio), the drain loop, the planning context and the chunked-streaming
machinery; ``make_engine(cfg, kind="slot")`` is the one constructor.  The
block-paged engine is not ported yet.

Streaming admission (``kind == "audio"`` requests, encdec only): the
utterance arrives as fixed-size sample chunks (``AudioFrontend.split``).
Admission feeds chunk 0 through the planned frontend -> incremental
encoder -> per-layer cross K/V, then runs the decoder-only prompt pass
(``api.stream_prefill``) against the partially filled encoder cache, so
decode starts before the utterance ends.  Each later ``step()`` feeds one
more chunk per streaming lane through the same functions and writes its
K/V into the lane in place; cross-attention masks rows past ``enc_len``.
A text ``submit`` with ``extra`` (precomputed frames) is refused until
the offline encdec prefill is ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import planned
from repro_torch.models import build_model
from repro_torch.models.transformer import cache_dtype_of

from .frontend import AudioFrontend, FrontendConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] int32
    max_new_tokens: int
    output: list = dataclasses.field(default_factory=list)
    done: bool = False
    # streaming audio: kind == "audio" requests carry their utterance as
    # chunk-sized sample blocks; ``fed`` counts chunks already encoded
    kind: str = "text"
    chunks: list | None = None
    fed: int = 0


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


@dataclasses.dataclass
class _StreamState:
    """Per-lane streaming state: the request it belongs to (identity-
    checked so a recycled lane drops stale state), the incremental
    encoder cache, and the frontend's FIR carry."""
    req: Request
    ec: dict
    carry: torch.Tensor


class EngineBase:
    """Request queue, submission, drain loop and streaming layer.

    Subclasses provide ``_lane_request(lane)`` (who holds the lane),
    ``_append_enc(lane, ek, ev, start, new_len)`` (write one chunk's cross
    K/V into the lane) and their own admit/step paths.
    """

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
        # audio streaming is an encdec capability: the frontend geometry
        # targets the config's embedding width
        self.frontend = (AudioFrontend(FrontendConfig(d_model=cfg.d_model),
                                       self.device)
                         if cfg.family == "encdec" else None)
        self._streams: dict[int, _StreamState] = {}

    def _plan_ctx(self):
        """The planning override every engine call runs under."""
        return planned.override(policy=self.policy)

    # -- submission ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 16,
               extra: dict | None = None) -> int:
        if extra:
            raise NotImplementedError(
                "extra model inputs (offline encdec prefill over "
                "precomputed frames) are not ported; submit audio with "
                "submit_audio_stream")
        prompt = np.asarray(prompt, np.int32)
        validate_request(prompt, max_new_tokens, self.max_seq)
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, max_new_tokens))
        return rid

    submit_text = submit

    def submit_audio_stream(self, samples, max_new_tokens: int = 16,
                            prompt=None) -> int:
        """Queue a chunked audio request: ``samples`` is a whole number
        of frontend chunks (``frontend.cfg.chunk_samples`` each); the
        decoder prompt defaults to a single BOS-like token 0."""
        if self.frontend is None:
            raise ValueError(
                f"audio streaming needs an encdec model with an audio "
                f"frontend; family {self.cfg.family!r} has none")
        chunks = self.frontend.split(samples)
        n_frames = len(chunks) * self.frontend.cfg.frames_per_chunk
        if n_frames > self.cfg.enc_frames:
            raise ValueError(
                f"audio stream is {n_frames} encoder frames "
                f"({len(chunks)} chunks x "
                f"{self.frontend.cfg.frames_per_chunk}) > enc_frames "
                f"{self.cfg.enc_frames}: the encoder cache cannot hold "
                "the utterance; split it across requests")
        prompt = np.asarray([0] if prompt is None else prompt, np.int32)
        validate_request(prompt, max_new_tokens, self.max_seq)
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, max_new_tokens,
                                  kind="audio", chunks=chunks))
        return rid

    def step(self) -> int:  # provided by the engine subclass
        raise NotImplementedError

    def run_until_drained(self, max_steps: int = 1000) -> list[Request]:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
        return self.finished

    # -- streaming machinery ------------------------------------------------
    def _lane_request(self, lane: int) -> Request | None:
        raise NotImplementedError

    def _append_enc(self, lane: int, ek, ev, start: int,
                    new_len: int) -> None:
        raise NotImplementedError

    def _zero_enc_kv(self):
        cfg = self.cfg
        shape = (cfg.n_layers, 1, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
        dt = cache_dtype_of(cfg)
        return (torch.zeros(shape, dtype=dt, device=self.device),
                torch.zeros(shape, dtype=dt, device=self.device))

    def _encode_chunk(self, carry, ec, chunk):
        """One chunk through frontend -> encoder -> cross K/V; returns
        (carry', ec', ek, ev) — the one code path admission and per-step
        feeding both run.  ``ec`` is updated in place."""
        carry, feats = self.frontend.chunk_features(carry, chunk)
        ec, enc_out = self.api.enc_step(self.params, ec, feats[None])
        ek, ev = self.api.enc_kv(self.params, enc_out)
        return carry, ec, ek, ev

    def _stream_admit_state(self, req: Request):
        """Encode the chunks consumed so far (at least one: initial
        admission feeds chunk 0) into fresh admission-side buffers.
        Returns (enc_k [nl,1,f_max,..], enc_v, enc_len [1], ec, carry)."""
        c = self.frontend.cfg.frames_per_chunk
        carry = self.frontend.init_state()
        ec = self.api.enc_init(1, self.cfg.enc_frames)
        ck, cv = self._zero_enc_kv()
        n = max(req.fed, 1)
        for i in range(n):
            carry, ec, ek, ev = self._encode_chunk(carry, ec, req.chunks[i])
            ck[:, :, i * c:(i + 1) * c] = ek
            cv[:, :, i * c:(i + 1) * c] = ev
        req.fed = n
        enc_len = torch.full((1,), n * c, dtype=torch.int32,
                             device=self.device)
        return ck, cv, enc_len, ec, carry

    def _feed_streams(self) -> None:
        """Advance every streaming lane by one chunk (called once per
        ``step()``, inside the plan context).  Lanes whose request
        finished drop their state; fully fed lanes keep decoding against
        the complete encoder cache."""
        c = self.frontend.cfg.frames_per_chunk if self.frontend else 0
        for lane in list(self._streams):
            st = self._streams[lane]
            if self._lane_request(lane) is not st.req:
                del self._streams[lane]
                continue
            req = st.req
            if req.fed >= len(req.chunks):
                continue
            i = req.fed
            st.carry, st.ec, ek, ev = self._encode_chunk(
                st.carry, st.ec, req.chunks[i])
            self._append_enc(lane, ek, ev, i * c, (i + 1) * c)
            req.fed = i + 1


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
