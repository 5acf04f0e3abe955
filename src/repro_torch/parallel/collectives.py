"""Collective wire-byte models (the port of the byte models in
``repro.parallel.collectives``).

The hierarchical planner (``core/hierarchy.py``) ranks its outer splits
by these totals over the outer interconnect; ``cannon_bytes`` and
``chain_bytes`` model the chip-level schedules of ``kernels/systolic.py``
(the chip smoke holds ``parallel.mesh.moved`` to them).  The reference
module's collectives themselves (``quantized_psum``,
``ring_reduce_scatter_matmul``, ``moe_ep_alltoall``) run across devices
and are ROADMAP A9.
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


def cannon_bytes(a_block_bytes: int, b_block_bytes: int, n: int) -> int:
    """Total wire bytes of one Cannon ring on an ``n`` x ``n`` mesh, as
    ``kernels/systolic.py`` runs it: the pre-skew moves every block but
    those of the first row of A and the first column of B (``n (n - 1)``
    each), then each of the ``n`` steps rotates all ``n^2`` blocks of
    both operands one hop (the last rotation included)."""
    if n <= 1:
        return 0
    n = int(n)
    return (n * (n - 1) + n ** 3) * (int(a_block_bytes) + int(b_block_bytes))


def chain_bytes(strip_bytes: int, width: int) -> int:
    """Total wire bytes of a 1-D chain's window halo: each of the
    ``width - 1`` internal boundaries carries one ``strip_bytes`` strip,
    right to left."""
    return max(int(width) - 1, 0) * int(strip_bytes)
