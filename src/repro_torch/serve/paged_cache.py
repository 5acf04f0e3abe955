"""Block-paged KV cache: fixed-size blocks on the sequence axis, per-lane
block tables, host-side alloc/free (the port of
``repro.serve.paged_cache``).

The device state is a set of *block pools* — ``paged`` leaves shaped
[L, num_blocks + 1, block_size, ...] shared by every request — plus
``lane`` leaves ([L, max_lanes, ...]) for states that are per-request
but fixed size (the encoder K/V) and ``lane_scalar`` leaves ([max_lanes]
— one scalar per request, the streaming ``enc_len`` frame count).  Which
leaf is which comes from the model family's ``paged_layout()``.

The pools are allocated once and only ever **updated in place**: the
engine captures its decode step as a CUDA graph over their addresses, so
a pool that was replaced after capture would silently decode against
stale memory.  ``pools`` is therefore a read-only mapping; nothing can
reassign a leaf.  The last block of every paged pool is a *sink* that
the allocator never hands out: an inactive lane's decode write lands
there (the reference forces it out of range and lets the scatter drop
it, which a PyTorch index cannot do without a device-side assert).

Everything *about* the blocks lives on the host: the free list, each
lane's block list, the [max_lanes, blocks_per_lane] int32 block tables,
per-lane ``pos`` and the ``active`` mask.  Admitting, growing, or
freeing a request edits these host arrays only — the decode step always
sees the same static shapes, so join/evict never re-captures it.

Freeing is O(1) per block and never touches other lanes' device data:
freed blocks simply return to the free list; their stale contents are
masked by ``kpos <= pos`` until a future write overwrites them (the
same trick a contiguous cache plays with its zero tail).
"""

from __future__ import annotations

import types

import numpy as np
import torch


class BlockAllocator:
    """Host-side free list over ``num_blocks`` pool blocks."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks))

    @property
    def free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged cache exhausted: need {n} blocks, "
                f"{len(self._free)} free of {self.num_blocks}")
        out = self._free[:n]
        del self._free[:n]
        return out

    def release(self, blocks: list[int]) -> None:
        self._free.extend(blocks)


class PagedKVCache:
    """Device block pools + host block tables for one model family."""

    def __init__(self, api, *, max_lanes: int, max_seq: int,
                 block_size: int, num_blocks: int | None = None):
        if max_seq % block_size:
            raise ValueError(
                f"max_seq={max_seq} must be a multiple of "
                f"block_size={block_size} (the block table is "
                "max_seq/block_size entries wide)")
        self.api = api
        self.max_lanes = max_lanes
        self.max_seq = max_seq
        self.block_size = block_size
        self.blocks_per_lane = max_seq // block_size
        if num_blocks is None:
            num_blocks = max_lanes * self.blocks_per_lane
        self.num_blocks = num_blocks
        self.allocator = BlockAllocator(num_blocks)
        # one block past num_blocks: the sink (module docstring)
        self._pools = api.paged_init(num_blocks + 1, block_size, max_lanes)
        self.pools = types.MappingProxyType(self._pools)
        self.layout = api.paged_layout()
        # host-owned request bookkeeping
        self.tables = np.zeros((max_lanes, self.blocks_per_lane), np.int32)
        self.pos = np.zeros((max_lanes,), np.int32)
        self.active = np.zeros((max_lanes,), bool)
        self.lane_blocks: list[list[int]] = [[] for _ in range(max_lanes)]

    def __setattr__(self, name, value):
        if name == "pools" and "pools" in self.__dict__:
            raise AttributeError(
                "the paged pools are updated in place and never replaced: "
                "the captured decode step holds their addresses")
        super().__setattr__(name, value)

    # -- host bookkeeping ---------------------------------------------------
    def free_blocks(self) -> int:
        return self.allocator.free

    def blocks_for(self, rows: int) -> int:
        return -(-rows // self.block_size)  # ceil

    def lane_capacity(self, lane: int) -> int:
        return len(self.lane_blocks[lane]) * self.block_size

    def install_lane(self, lane: int, blocks: list[int], pos: int) -> None:
        """Point a lane at freshly allocated blocks, position ``pos``."""
        self.lane_blocks[lane] = list(blocks)
        self.tables[lane, :] = 0
        self.tables[lane, :len(blocks)] = blocks
        self.pos[lane] = pos
        self.active[lane] = True

    def grow_lane(self, lane: int, block: int) -> None:
        n = len(self.lane_blocks[lane])
        if n >= self.blocks_per_lane:
            raise MemoryError(
                f"lane {lane} already holds blocks_per_lane="
                f"{self.blocks_per_lane} blocks")
        self.lane_blocks[lane].append(block)
        self.tables[lane, n] = block

    def release_lane(self, lane: int) -> None:
        self.allocator.release(self.lane_blocks[lane])
        self.lane_blocks[lane] = []
        self.tables[lane, :] = 0
        self.pos[lane] = 0
        self.active[lane] = False

    def guard_decode_write(self) -> None:
        """Assert-guard the decode write: every active lane's next write
        position must fall inside its allocated blocks AND inside
        max_seq.  The slot engine's write clamps at the horizon
        (overwriting the last row in place); the paged cache refuses
        instead."""
        for lane in range(self.max_lanes):
            if not self.active[lane]:
                continue
            p = int(self.pos[lane])
            if p >= self.max_seq:
                raise AssertionError(
                    f"lane {lane}: decode write at pos {p} >= "
                    f"max_seq {self.max_seq} — the sequence horizon "
                    "would silently clamp; submit() should have "
                    "rejected this request")
            if p >= self.lane_capacity(lane):
                raise AssertionError(
                    f"lane {lane}: decode write at pos {p} beyond the "
                    f"lane's {len(self.lane_blocks[lane])} allocated "
                    "blocks — grow the lane (or preempt) before "
                    "stepping")

    # -- prefill write ------------------------------------------------------
    def _row_indices(self, lane: int, rows: int) -> np.ndarray:
        """Flat pool-row index of logical rows [0, min(rows, capacity))
        of ``lane``.  Rows past the lane's allocated capacity (bucket pad
        rows) are left out here, on the host, where the reference's
        scatter drops them on the device."""
        j = np.arange(min(rows, self.lane_capacity(lane)))
        blocks = np.asarray(self.lane_blocks[lane], np.int64)
        return blocks[j // self.block_size] * self.block_size \
            + j % self.block_size

    def write_prefill(self, lane: int, prefill_cache) -> None:
        """Scatter a single-request prefill cache into ``lane``'s blocks
        (paged leaves) / lane row (lane leaves), in place.  Dtypes must
        match exactly — a silent cast here would quietly narrow (e.g.
        fp32 state into an fp8 pool), corrupting the lane without a
        trace."""
        rows = None
        for name in self.layout:
            leaf = prefill_cache[name]
            pool = self._pools[name]
            if leaf.dtype != pool.dtype:
                raise TypeError(
                    f"prefill cache dtype {leaf.dtype} != pool dtype "
                    f"{pool.dtype} for leaf {name!r}; rebuild the "
                    "prefill cache with the engine's kv_cache_dtype "
                    "instead of relying on a silent cast")
            if self.layout[name] == "paged":
                rows = leaf.shape[2] if rows is None else rows
                if leaf.shape[2] != rows:
                    raise ValueError(
                        f"paged leaf {name!r} rows {leaf.shape[2]} != "
                        f"{rows}")
        idx = self._row_indices(lane, rows or 0)
        n = len(idx)
        idx = torch.as_tensor(idx, device=self.api.device)
        for name, kind in self.layout.items():
            pool, src = self._pools[name], prefill_cache[name]
            if kind == "paged":
                flat = pool.view(pool.shape[0], -1, *pool.shape[3:])
                flat[:, idx] = src[:, 0, :n]
            elif kind == "lane_scalar":
                pool[lane] = src[0]
            else:  # lane-resident state, fixed size
                pool[:, lane] = src[:, 0]
