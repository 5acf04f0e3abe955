"""Collective wire-byte models (the port of the byte models in
``repro.parallel.collectives``).

The hierarchical planner (``core/hierarchy.py``) ranks its outer splits
by these totals over the outer interconnect.  The reference module's
collectives themselves (``quantized_psum``, ``ring_reduce_scatter_matmul``,
``moe_ep_alltoall``) run across devices and are ROADMAP A9.
"""

from __future__ import annotations


def ring_allgather_bytes(shard_bytes: int, group: int) -> int:
    """Total wire bytes for a ring all-gather of ``group`` shards of
    ``shard_bytes`` each: every shard transits ``group - 1`` hops."""
    if group <= 1:
        return 0
    return int(group) * (int(group) - 1) * int(shard_bytes)


def ring_allreduce_bytes(payload_bytes: int, group: int) -> int:
    """Total wire bytes for a ring all-reduce of one ``payload_bytes``
    buffer over ``group`` ranks: reduce-scatter + all-gather, each moving
    ``(group - 1) / group`` of the payload per rank — ``2 * (group - 1) *
    payload`` in total."""
    if group <= 1:
        return 0
    return 2 * (int(group) - 1) * int(payload_bytes)


def halo_exchange_bytes(strip_bytes: int, boundaries: int) -> int:
    """Total wire bytes for a halo exchange across ``boundaries`` internal
    tile boundaries: each boundary carries one ``strip_bytes`` strip in
    each direction."""
    if boundaries <= 0:
        return 0
    return 2 * int(strip_bytes) * int(boundaries)
