"""The serving engines of the port (``repro.serve.engine``): the slot
engine and the block-paged continuous-batching engine.

``ServeEngine`` is the slot engine: one cache with ``max_slots`` batch
lanes; each admitted prompt is prefilled alone at ``max_seq`` and its
cache copied into a free lane; every ``step()`` admits what fits, feeds
one more audio chunk to every streaming lane, then runs one decode step
over all lanes and appends each active lane's greedy token.  A streamed
audio request (encdec) is admitted after its first chunk: the planned
frontend and the incremental encoder fill a partial encoder cache and
the decoder prompt prefills against it (``stream_prefill``); a text
request with precomputed frames (``submit(..., extra={"frames": ...})``)
prefills offline, encoder and prompt in one ``prefill``.  Every GEMM
and frontend stage runs through ``kernels.planned`` — on the card, the
hand-written kernels.  Its ``load()`` warms the serving path up: one
decode step over the fresh cache (and one prefill when ``prompt_len`` is
given) plans every serving shape.

``PagedServeEngine`` replaces the fixed-slot admit/free model with
continuous batching over a block-paged KV cache (``paged_cache``):

  * K/V lives in fixed-size blocks on the sequence axis; each request
    holds a host-side block table.  Admit/evict/grow is a host table
    edit — the decode step takes static-shape (tokens, block_tables,
    pos, active) inputs from static device buffers and is captured once
    in ``load()`` as a CUDA graph (the reference compiles it once);
    joining or finishing a request never re-captures it.  Each
    ``step()`` stages the host state into those buffers with one copy
    (from pinned memory), replays the graph — no Python facade call and
    no planner lookup — and reads the greedy tokens before the next
    replay overwrites them.
  * Prefills are bucketed (``scheduler``): prompts pad to the next
    bucket length so the prefill runs at one shape per bucket, and the
    scheduler packs at most a few prefills into steps where decode lanes
    sit idle instead of stalling all in-flight decodes behind a burst.
    The MoE, SSM and hybrid families prefill at exact lengths instead
    (pad tokens would take expert slots from real ones, or enter the
    recurrent state), as in the reference.  Prefills
    and chunk feeds run eagerly, outside the graph.
  * When the block pool runs dry mid-flight, the youngest active
    request is preempted: its blocks free instantly, it re-queues with
    its generated tokens folded into the prompt, and recomputes on
    re-admission (output-transparent — same context, same greedy
    tokens).  Text lanes are preferred victims over streaming audio
    lanes (an audio victim must also replay its consumed chunks).

Both engines take ``target=`` (e.g. ``core.SERVING_HIERARCHICAL_TARGET``):
every call they make runs under ``planned.override(policy=..., target=...)``,
so the serving GEMMs plan two-level and run as the compositions of their
groups; the paged engine captures its decode step under it, with the
two-level plans inside the graph.

``plan_report`` and ``autotune_report`` hold the deltas of each
engine's ``load()``, as in the reference.  A replayed step makes no
Python call, so neither they nor the kernel wrappers' launch counts see
it: they count the capture (and the eager prefills and chunk feeds).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import autotune
from repro_torch.kernels import planned

from .api import EngineBase, Request, _StreamState
from .paged_cache import PagedKVCache
from .scheduler import Scheduler, SchedulerConfig


class ServeEngine(EngineBase):
    def __init__(self, cfg, *, max_slots: int = 4, max_seq: int = 512,
                 prompt_len: int | None = None, policy=None, target=None,
                 device="cuda"):
        super().__init__(cfg, max_seq=max_seq, policy=policy, target=target,
                         device=device)
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
                self.api.prefill(params,
                                 self._prefill_batch(tokens, warmup=True),
                                 self.max_seq)
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
                    self.params, self._prefill_batch(tokens, req.extra),
                    self.max_seq)
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


class PagedServeEngine(EngineBase):
    """Continuous-batching engine over a block-paged KV cache.

    ``max_lanes`` bounds concurrent requests (the decode batch width),
    ``max_seq`` the per-request horizon, ``block_size`` the KV block
    granularity, ``num_blocks`` the shared pool size (default: enough
    for every lane at full horizon — shrink it to oversubscribe and
    exercise preemption).  ``stats`` tracks ``decode_compiles`` (the
    decode captures, pinned at 1), ``prefill_compiles`` (one per
    bucket), ``preemptions`` and ``steps``.
    """

    def __init__(self, cfg, *, max_lanes: int = 4, max_seq: int = 512,
                 block_size: int = 16, num_blocks: int | None = None,
                 prompt_len: int | None = None, policy=None, target=None,
                 scheduler: Scheduler | SchedulerConfig | None = None,
                 device="cuda"):
        super().__init__(cfg, max_seq=max_seq, policy=policy, target=target,
                         device=device)
        self.max_lanes = max_lanes
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.prompt_len = prompt_len
        if isinstance(scheduler, SchedulerConfig):
            scheduler = Scheduler(scheduler)
        self.scheduler = scheduler or Scheduler()
        # bucket pads are invisible to masked attention, but not to every
        # family: capacity-limited MoE routing lets pads compete with real
        # tokens for expert slots, and a recurrent ssm/hybrid state absorbs
        # them, so those prefill at exact lengths, as in the reference;
        # dense and encdec bucket
        self._exact_prefill = cfg.family in ("ssm", "hybrid", "moe")
        self.kv: PagedKVCache | None = None
        self.lanes: list[Request | None] = [None] * max_lanes
        self._admit_seq = 0
        self._lane_seq: dict[int, int] = {}
        self._prefill_shapes: set = set()
        self._decode_fn = None
        self._decode_exec = None
        self._graph = None
        self._decode_out = None
        self.stats = {"decode_compiles": 0, "prefill_compiles": 0,
                      "preemptions": 0, "steps": 0}

    # -- load ---------------------------------------------------------------
    @torch.no_grad()
    def load(self, params):
        """Install weights, build the block pools, and capture the decode
        step — exactly once.

        The step reads static device buffers: tokens [max_lanes, 1],
        block_tables [max_lanes, max_seq/block_size], pos [max_lanes] and
        active [max_lanes], one int32 buffer (``_inputs``).  On the card
        it runs once on a side stream with every lane inactive (its
        writes land in the sink block), so that every launch
        configuration has been set up, then is captured as one
        ``torch.cuda.CUDAGraph``; a capture that fails raises — the
        engine never decodes eagerly on the card.  On the CPU
        (``device="cpu"``) the same closure over the same buffers runs
        once the same way and is the step.  Admit/evict/grow edit the
        host tables only, so nothing in flight can change what was
        captured.

        ``plan_report`` / ``autotune_report`` are the deltas of this load
        window (the warmup and the capture, and with ``prompt_len`` one
        bucketed prefill), as in ``ServeEngine.load``.
        """
        self.params = params
        self.kv = PagedKVCache(
            self.api, max_lanes=self.max_lanes, max_seq=self.max_seq,
            block_size=self.block_size, num_blocks=self.num_blocks)
        self.num_blocks = self.kv.num_blocks
        lanes, width = self.max_lanes, self.kv.blocks_per_lane
        cuda = self.device.type == "cuda"
        self._staged = torch.zeros(lanes * (width + 3), dtype=torch.int32,
                                   pin_memory=cuda)
        self._inputs = torch.zeros(lanes * (width + 3), dtype=torch.int32,
                                   device=self.device)
        before = planned.planned_report()
        tune0 = autotune.counters()
        with self._plan_ctx():
            self._decode_fn = self._decode_closure()
            if cuda:
                self._decode_exec = self._capture(self._decode_fn)
            else:
                # plan every decode shape, as the card's warmup run does;
                # each later step runs under the engine's planning override,
                # as the captured graph holds the plans it was captured with
                self._decode_fn()
                self._decode_exec = self._planned_step(self._decode_fn)
            self.stats["decode_compiles"] += 1
            if self.prompt_len:
                self._warm_prefill()
        self.plan_report = planned.report_delta(
            before, planned.planned_report())
        tune1 = autotune.counters()
        self.autotune_report = {k: tune1[k] - tune0[k] for k in tune1}

    def _planned_step(self, fn):
        """``fn`` run under the engine's planning override (the CPU's
        decode step)."""
        def step():
            with self._plan_ctx():
                return fn()

        return step

    def _decode_closure(self):
        """The decode step over the static input buffer: (logits
        [max_lanes, V], greedy next tokens [max_lanes])."""
        lanes, width = self.max_lanes, self.kv.blocks_per_lane
        tokens, tables, pos, active = self._inputs.split(
            [lanes, lanes * width, lanes, lanes])
        tokens, tables = tokens.view(lanes, 1), tables.view(lanes, width)
        params, pools, decode = self.params, self.kv.pools, \
            self.api.paged_decode

        def step():
            logits, _ = decode(params, pools, tokens, tables, pos,
                               active != 0)
            return logits, torch.argmax(logits, dim=-1)

        return step

    def _capture(self, step):
        """One warmup run of ``step`` on a side stream, then its capture
        as a CUDA graph (the input buffer is all zeros: every lane
        inactive).  Returns the replay: it runs the graph and returns its
        static outputs (logits, next tokens), which the next replay
        overwrites."""
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            step()
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
        self._graph, self._decode_out = graph, out

        def replay():
            graph.replay()
            return out

        return replay

    def _warm_prefill(self) -> None:
        """Plan the prefill of ``prompt_len`` tokens at its bucket (its
        exact length for the exact-prefill families; a vlm's with zero
        patch embeddings ahead of it): one run at that shape, its cache
        dropped."""
        bucket = self.scheduler.bucket_for(self.prompt_len,
                                           exact=self._exact_prefill)
        tokens = torch.zeros((1, bucket), dtype=torch.int32,
                             device=self.device)
        li = None if self._exact_prefill else torch.full(
            (1,), self.prompt_len - 1, dtype=torch.int32, device=self.device)
        batch = self._prefill_batch(tokens, warmup=True)
        self.api.prefill(self.params, batch,
                         bucket + self._extra_rows(batch), last_index=li)

    # -- admission ----------------------------------------------------------
    def _effective_prompt(self, req: Request) -> np.ndarray:
        """Prompt plus already-generated tokens: a preempted request
        re-prefills its full context and continues where it left off."""
        if not req.output:
            return req.prompt
        return np.concatenate(
            [req.prompt, np.asarray(req.output, np.int32)])

    def _lane_request(self, lane: int) -> Request | None:
        return self.lanes[lane]

    def _append_enc(self, lane: int, ek, ev, start: int,
                    new_len: int) -> None:
        """Write one chunk's cross K/V ([nl, 1, C, hkv, hd]) into the
        lane's encoder pools at ``start`` and set its fill clock, in place
        (the captured step reads these very tensors)."""
        pools, c = self.kv.pools, ek.shape[2]
        pools["enc_k"][:, lane, start:start + c] = ek[:, 0]
        pools["enc_v"][:, lane, start:start + c] = ev[:, 0]
        pools["enc_len"][lane] = new_len

    def _count_prefill(self, key) -> None:
        """Count a prefill shape the first time it runs: one per bucket
        and batch keys (the reference's jitted prefill compiles once per
        ``(rows, batch keys, last_index use)``, and once per bucket for a
        stream)."""
        if key not in self._prefill_shapes:
            self._prefill_shapes.add(key)
            self.stats["prefill_compiles"] += 1

    def _admit_one(self, req: Request, lane: int) -> None:
        """Prefill ``req`` (a re-admitted one over its prompt and the
        tokens it made, with the same frames) at its bucket and install
        it in ``lane``; or finish it, if the prefill's token meets its
        budget."""
        eff = self._effective_prompt(req)
        plen = len(eff)
        extra_rows = self._extra_rows(req.extra)
        bucket = self.scheduler.bucket_for(plen, exact=self._exact_prefill)
        blocks = self.kv.allocator.alloc(
            self.kv.blocks_for(extra_rows + plen))
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :plen] = eff
        tokens = torch.as_tensor(tokens, device=self.device)
        li = torch.full((1,), plen - 1, dtype=torch.int32,
                        device=self.device)
        stream = None
        if req.kind == "audio":
            ck, cv, el, ec, carry = self._stream_admit_state(req)
            self._count_prefill(("stream", bucket))
            logits, pc = self.api.stream_prefill(
                self.params, ck, cv, el, tokens, bucket, last_index=li)
            stream = (ec, carry)
        else:
            batch = self._prefill_batch(tokens, req.extra)
            # the reference passes last_index to the bucketed families'
            # prefills only: the exact ones read the last row
            use_li = not self._exact_prefill
            self._count_prefill((bucket + extra_rows, tuple(sorted(batch)),
                                 use_li))
            logits, pc = self.api.prefill(
                self.params, batch, bucket + extra_rows,
                last_index=li if use_li else None)
        req.output.append(int(torch.argmax(logits[0])))
        if len(req.output) >= req.max_new_tokens:
            # admit-time done check: the prefill token satisfied the
            # budget — finish without ever occupying a lane
            req.done = True
            self.finished.append(req)
            self.kv.allocator.release(blocks)
            return
        self.kv.install_lane(lane, blocks, extra_rows + plen)
        self.kv.write_prefill(lane, pc)
        self.lanes[lane] = req
        self._lane_seq[lane] = self._admit_seq
        self._admit_seq += 1
        if stream is not None:
            self._streams[lane] = _StreamState(req, *stream)

    def _admit(self) -> None:
        while self.queue:
            free = [i for i, r in enumerate(self.lanes) if r is None]
            n_active = self.max_lanes - len(free)
            needs = [self.kv.blocks_for(self._extra_rows(r.extra)
                                        + len(self._effective_prompt(r)))
                     for r in self.queue]
            n = self.scheduler.plan_admits(
                needs, free_lanes=len(free),
                free_blocks=self.kv.free_blocks(), n_active=n_active)
            if n == 0:
                return
            for _ in range(n):
                req = self.queue.pop(0)
                self._admit_one(req, free.pop(0))
            # a request finishing at admit time frees its lane again:
            # loop so the scheduler can top the step up
            if all(r is not None for r in self.lanes):
                return

    # -- preemption ---------------------------------------------------------
    def _preempt(self, lane: int) -> None:
        req = self.lanes[lane]
        self.kv.release_lane(lane)
        self.lanes[lane] = None
        self._lane_seq.pop(lane, None)
        self._streams.pop(lane, None)
        self.queue.insert(0, req)
        self.stats["preemptions"] += 1

    def _ensure_capacity(self) -> None:
        """Before a decode step: every active lane's next write must fit
        its allocated blocks.  Grow by one block on demand; when the
        pool is dry, preempt the *youngest* active lane (its recompute
        loss is smallest), preferring text lanes over streaming audio
        lanes — an evicted audio request must also replay its consumed
        chunks on re-admission, so its recompute loss is larger.  The
        growing lane itself is only preempted when it is the sole
        active lane left."""
        for lane in range(self.max_lanes):
            while (self.lanes[lane] is not None
                   and int(self.kv.pos[lane])
                   >= self.kv.lane_capacity(lane)):
                if self.kv.free_blocks() > 0:
                    self.kv.grow_lane(lane, self.kv.allocator.alloc(1)[0])
                    continue
                others = [i for i, r in enumerate(self.lanes)
                          if r is not None and i != lane]
                text = [i for i in others
                        if self.lanes[i].kind != "audio"]
                victims = sorted(text or others,
                                 key=lambda i: self._lane_seq.get(i, 0))
                victim = victims[-1] if victims else lane
                self._preempt(victim)
                if victim == lane:
                    break

    # -- step ---------------------------------------------------------------
    def _decode(self, active: list[int]) -> list[int]:
        """Stage the host state (tokens, tables, pos, active) into the
        static input buffer with one copy, run the captured step, and
        return every lane's greedy token."""
        lanes, width = self.max_lanes, self.kv.blocks_per_lane
        staged = self._staged.numpy()
        staged[:lanes] = 0
        for i in active:
            staged[i] = self.lanes[i].output[-1]
        staged[lanes:lanes * (width + 1)] = self.kv.tables.ravel()
        staged[lanes * (width + 1):lanes * (width + 2)] = self.kv.pos
        staged[lanes * (width + 2):] = self.kv.active
        self._inputs.copy_(self._staged, non_blocking=True)
        _, nxt = self._decode_exec()
        return nxt.tolist()

    @torch.no_grad()
    def step(self) -> int:
        """Admit + one decode step for all active lanes.  Returns active
        request count after the step plus the queue backlog."""
        with self._plan_ctx():
            # bucketed prefills and the streaming chunk feeds run the
            # planned GEMMs eagerly: the engine's policy and target must
            # be ambient
            self._admit()
            self._feed_streams()
        self._ensure_capacity()
        active = [i for i, r in enumerate(self.lanes) if r is not None]
        if not active:
            return len(self.queue)
        self.kv.guard_decode_write()
        nxt = self._decode(active)
        self.stats["steps"] += 1
        for i in active:
            req = self.lanes[i]
            req.output.append(nxt[i])
            self.kv.pos[i] += 1
            if len(req.output) >= req.max_new_tokens:
                req.done = True
                self.finished.append(req)
                self.kv.release_lane(i)
                self.lanes[i] = None
                self._lane_seq.pop(i, None)
                self._streams.pop(i, None)
        return sum(r is not None for r in self.lanes) + len(self.queue)
