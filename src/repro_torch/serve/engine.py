"""The slot serving engine (the port of ``repro.serve.engine.ServeEngine``).

One cache with ``max_slots`` batch lanes: each admitted prompt is
prefilled alone at ``max_seq`` and its cache copied into a free lane;
every ``step()`` admits what fits, feeds one more audio chunk to every
streaming lane, then runs one decode step over all lanes and appends each
active lane's greedy token.  A streamed audio request (encdec) is
admitted after its first chunk: the planned frontend and the incremental
encoder fill a partial encoder cache and the decoder prompt prefills
against it (``stream_prefill``).  Every GEMM and frontend stage runs
through ``kernels.planned`` — on the card, the hand-written kernels.

``load()`` warms the serving path up: one decode step over the fresh
cache (and one prefill when ``prompt_len`` is given) plans every serving
shape.  ``plan_report`` and ``autotune_report`` hold the deltas of that
warmup, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.core import autotune
from repro_torch.kernels import planned

from .api import EngineBase, Request, _StreamState


class ServeEngine(EngineBase):
    def __init__(self, cfg, *, max_slots: int = 4, max_seq: int = 512,
                 prompt_len: int | None = None, policy=None, device="cuda"):
        super().__init__(cfg, max_seq=max_seq, policy=policy, device=device)
        self.max_slots = max_slots
        self.prompt_len = prompt_len
        self.cache = None
        self.slots: list[Request | None] = [None] * max_slots

    @torch.no_grad()
    def load(self, params):
        """Install weights and plan the serving GEMMs up front (see the
        module docstring); the cache starts fresh afterwards."""
        self.params = params
        before = planned.planned_report()
        tune0 = autotune.counters()
        with self._plan_ctx():
            cache = self.api.init_cache(self.max_slots, self.max_seq)
            tokens0 = torch.zeros((self.max_slots, 1), dtype=torch.int32,
                                  device=self.device)
            self.api.decode(params, cache, tokens0)
            if self.prompt_len:
                tokens = torch.zeros((1, self.prompt_len), dtype=torch.int32,
                                     device=self.device)
                self.api.prefill(params, {"tokens": tokens}, self.max_seq)
        self.cache = self.api.init_cache(self.max_slots, self.max_seq)
        self.plan_report = planned.report_delta(
            before, planned.planned_report())
        tune1 = autotune.counters()
        self.autotune_report = {k: tune1[k] - tune0[k] for k in tune1}

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _lane_request(self, lane: int) -> Request | None:
        return self.slots[lane]

    def _write_lane(self, lane: int, prefill_cache):
        """Copy a single-request prefill cache into lane ``lane``, in place
        (every leaf: the self-attention K/V, and for encdec the encoder
        K/V and ``enc_len``; ``pos``).

        Dtypes must match exactly: a mismatch means the prefill cache was
        built with other settings, and a silent cast could narrow it (an
        fp32 prefill into an fp8 lane) without a trace."""
        for name, dst in self.cache.items():
            src = prefill_cache[name]
            if src.dtype != dst.dtype:
                raise TypeError(
                    f"prefill cache dtype {src.dtype} != engine cache "
                    f"dtype {dst.dtype} (shape {tuple(src.shape)} -> "
                    f"{tuple(dst.shape)}); rebuild the prefill cache with "
                    "the engine's kv_cache_dtype instead of relying on a "
                    "silent cast")
            # batch axis: 0 for the 1-D pos / enc_len leaves, 1 for
            # [L, B, ...] leaves
            if dst.dim() == 1:
                dst[lane] = src[0]
            else:
                dst[:, lane] = src[:, 0]

    def _append_enc(self, lane: int, ek, ev, start: int,
                    new_len: int) -> None:
        """Write one chunk's cross K/V ([nl, 1, C, hkv, hd]) into the
        lane's encoder buffers at ``start`` and bump its fill clock, in
        place."""
        c = ek.shape[2]
        self.cache["enc_k"][:, lane, start:start + c] = ek[:, 0]
        self.cache["enc_v"][:, lane, start:start + c] = ev[:, 0]
        self.cache["enc_len"][lane] = new_len

    def _admit(self):
        free = self._free_slots()
        while free and self.queue:
            req = self.queue.pop(0)
            tokens = torch.as_tensor(req.prompt[None], device=self.device)
            stream = None
            if req.kind == "audio":
                ck, cv, el, ec, carry = self._stream_admit_state(req)
                logits, pc = self.api.stream_prefill(
                    self.params, ck, cv, el, tokens, self.max_seq)
                stream = (ec, carry)
            else:
                logits, pc = self.api.prefill(
                    self.params, {"tokens": tokens}, self.max_seq)
            req.output.append(int(torch.argmax(logits[0])))
            if len(req.output) >= req.max_new_tokens:
                # the prefill token already met the budget: the request
                # finishes at admit time and never takes a lane
                req.done = True
                self.finished.append(req)
                continue
            lane = free.pop(0)
            self._write_lane(lane, pc)
            self.slots[lane] = req
            if stream is not None:
                self._streams[lane] = _StreamState(req, *stream)

    @torch.no_grad()
    def step(self) -> int:
        """Admit, feed one chunk per streaming lane, then one decode step
        for all lanes.  Returns the number of requests still active or
        queued."""
        with self._plan_ctx():
            self._admit()
            self._feed_streams()
            active = [i for i, s in enumerate(self.slots) if s is not None]
            if not active:
                return len(self.queue)
            tokens = torch.zeros((self.max_slots, 1), dtype=torch.int32)
            for i in active:
                tokens[i, 0] = self.slots[i].output[-1]
            logits, self.cache = self.api.decode(
                self.params, self.cache, tokens.to(self.device))
            nxt = torch.argmax(logits, dim=-1).tolist()
        for i in active:
            req = self.slots[i]
            req.output.append(nxt[i])
            if len(req.output) >= req.max_new_tokens:
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
                self._streams.pop(i, None)
        return sum(s is not None for s in self.slots) + len(self.queue)
