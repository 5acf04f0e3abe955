"""Collectives of the port (``repro.parallel.collectives``) and their
wire-byte models.

The hierarchical planner (``core/hierarchy.py``) ranks its outer splits
by the byte models' totals over the outer interconnect; ``cannon_bytes``
and ``chain_bytes`` model the chip-level schedules of
``kernels/systolic.py`` and ``ring_reduce_scatter_bytes`` the ring below
(the chip smoke holds ``parallel.mesh.moved`` to them).

The collectives run on the single-controller mesh of ``parallel/mesh.py``
and take every member's blocks at once, in lockstep:

    quantized_psum       int8 all-reduce with stochastic rounding (a
                         per-tensor max-abs scale from one ``pmax``, an
                         int32 ``psum``)
    ring_reduce_scatter_matmul
                         y = X @ W with X split over its columns and W
                         over its rows: each member's partial product on
                         B1's hand kernel in the accumulator dtype (int32
                         for integers, fp32 for floats), reduced by a
                         ``ppermute`` ring over row chunks; member i ends
                         with row chunk i of y
    moe_ep_alltoall      expert-parallel MoE: tokens split over the batch
                         axis and their sequence over the expert axis,
                         dispatched to the experts' members by
                         ``all_to_all`` and back
"""

from __future__ import annotations

import torch

from . import mesh as pm
from .mesh import P


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


def ring_reduce_scatter_bytes(chunk_bytes: int, group: int) -> int:
    """Total wire bytes of ``ring_reduce_scatter_matmul`` over ``group``
    members: ``group - 1`` ring steps in which every member passes one
    accumulator chunk on, then the realignment, in which every member
    sends its chunk two places on (to itself on a ring of 2)."""
    group = int(group)
    if group <= 1:
        return 0
    hops = group * (group - 1) + (group if group > 2 else 0)
    return hops * int(chunk_bytes)


# ---------------------------------------------------------------------------
# int8 quantized all-reduce (stochastic rounding)
# ---------------------------------------------------------------------------

def quantized_psum(mesh, blocks, axis, generator: torch.Generator):
    """All-reduce of ``blocks`` over ``axis`` with an int8 payload: a
    per-tensor max-abs scale (one ``pmax`` of a scalar), stochastic
    rounding so E[dequant] == x, int32 accumulation.  The noise is drawn
    once from ``generator`` (on its device) and every member adds the
    same, as the reference's one key gives every member the same."""
    xf = pm.map_members(mesh, lambda m, x: x.float(), blocks)
    amax = pm.pmax(mesh, pm.map_members(
        mesh, lambda m, x: x.abs().max(), xf), axis)
    shape = xf.flat[0].shape
    noise = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=generator.device) - 0.5
    scales = pm.map_members(
        mesh, lambda m, a: torch.clamp(a, min=1e-30) / 127.0, amax)

    def quantize(member, x, scale):
        q = torch.round(x / scale + noise.to(x.device)).clamp_(-127, 127)
        return q.to(torch.int8).to(torch.int32)

    total = pm.psum(mesh, pm.map_members(mesh, quantize, xf, scales), axis)
    return pm.map_members(mesh, lambda m, t, scale: t.float() * scale,
                          total, scales)


# ---------------------------------------------------------------------------
# collective (ring) matmul
# ---------------------------------------------------------------------------

def _partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` on B1 (``widesa_mm.matmul``, the configuration the
    runtime picks for the planner's plan) in the accumulator dtype; the
    plain version on the CPU."""
    from repro_torch.kernels import planned, runtime, widesa_mm

    (m, k), n = x.shape, w.shape[1]
    plan = planned.plan_for("mm", (m, n, k), planned.dtype_name(x.dtype))
    if plan is None:
        raise ValueError(f"no plan for the ring's partial mm{(m, n, k)} in "
                         f"{x.dtype}")
    return widesa_mm.matmul(x, w, tiles=runtime.gemm_tiles(plan, x, w).tile,
                            out_dtype=runtime.acc_dtype(x.dtype))


def ring_reduce_scatter_matmul(mesh, x_blocks, w_blocks, axis,
                               axis_size: int | None = None):
    """Streamed TP matmul y = X @ W over ``axis``: member i holds X's
    column block [m, k_loc] and W's row block [k_loc, n] and ends with
    row chunk i of y, [m / axis_size, n], in the accumulator dtype (int32
    for integers, fp32 for floats).  The partials are reduced by a
    ``ppermute`` ring over their row chunks (module docstring), then
    realigned so member i holds chunk i, as the reference's."""
    n_sh = axis_size or pm._width(mesh, axis)
    if n_sh != pm._width(mesh, axis):
        raise ValueError(f"axis_size {n_sh} for the "
                         f"{pm._width(mesh, axis)}-wide axis {axis!r}")
    parts = pm.map_members(mesh, lambda m, x, w: _partial(x, w),
                           x_blocks, w_blocks)
    m = parts.flat[0].shape[0]
    if m % n_sh:
        raise ValueError(f"{m} rows do not split into {n_sh} chunks")
    m_loc = m // n_sh

    def chunk(member, c):
        return parts[member][c * m_loc:(c + 1) * m_loc]

    def idx(member):
        return pm.axis_index(mesh, member, axis)

    acc = pm.map_members(mesh, lambda mb: chunk(mb, (idx(mb) + 1) % n_sh))
    fwd = [(i, (i + 1) % n_sh) for i in range(n_sh)]
    for s in range(1, n_sh):
        acc = pm.ppermute(mesh, acc, axis, fwd)
        acc = pm.map_members(
            mesh, lambda mb, a: a + chunk(mb, (idx(mb) + 1 - s) % n_sh), acc)
    if n_sh > 1:
        acc = pm.ppermute(mesh, acc, axis,
                          [(i, (i + 2) % n_sh) for i in range(n_sh)])
    return acc


# ---------------------------------------------------------------------------
# EP all-to-all MoE
# ---------------------------------------------------------------------------

def moe_ep_alltoall(cfg, p, x, ctx):
    """Expert-parallel MoE on the context's mesh: x [B, S, d] split over
    the batch axis and its sequence over the expert axis (a sequence that
    does not divide raises ``ValueError``, as the reference's
    ``shard_map`` does).  In lockstep phases: each member routes its
    tokens (a plain fp32 product with the router, as the reference's),
    takes their load-balance term and dispatches them to [E, C, d];
    ``all_to_all`` (split 0, concat 1) gives each member its experts'
    rows from every member, [E_loc, ep * C, d]; each member runs its
    experts' stack (``moe.expert_ffn``: B2 on the card); ``all_to_all``
    (split 1, concat 0) returns the rows; each member combines its
    tokens; a ``pmean`` of the terms over the expert axis.  Returns (y,
    aux)."""
    from repro_torch.models import moe as MOE

    mesh = ctx.mesh
    exp_axis = ctx.rules.get("experts", "model")
    batch_axis = ctx.rules.get("batch", "data")
    e = cfg.moe_num_experts
    spec = P(batch_axis, exp_axis, None)
    xs = pm.shard(mesh, x, spec)
    router = pm.shard(mesh, p["router"], P(None, None))
    wg, wu, wd = (pm.shard(mesh, p[k], P(exp_axis, None, None))
                  for k in ("wg", "wu", "wd"))
    cap = MOE.capacity_of(cfg, xs.flat[0].shape[0] * xs.flat[0].shape[1])

    def dispatch(member, x_loc, r):
        xf = x_loc.reshape(-1, x_loc.shape[-1])
        weights, ids, probs = MOE.route(cfg, xf.float() @ r)
        order, slot, keep, token = MOE.dispatch_indices(cfg, ids, cap)
        buf = MOE.dispatch(xf, slot, token, e, cap)
        return buf, {"weights": weights, "order": order, "slot": slot,
                     "keep": keep}, MOE.load_balance_loss(cfg, probs, ids)

    bufs, routes, aux = pm.map_members(mesh, dispatch, xs, router)
    bufs = pm.all_to_all(mesh, bufs, exp_axis, 0, 1)
    outs = pm.map_members(
        mesh, lambda m, b, g, u, dn: MOE.expert_ffn(cfg, g, u, dn, b),
        bufs, wg, wu, wd)
    outs = pm.all_to_all(mesh, outs, exp_axis, 1, 0)

    def combine(member, out, r, x_loc):
        y = MOE.combine(out.reshape(e * cap, -1), r["weights"], r["order"],
                        r["slot"], r["keep"])
        return y.reshape(x_loc.shape)

    ys = pm.map_members(mesh, combine, outs, routes, xs)
    aux = pm.pmean(mesh, aux, exp_axis)
    return (pm.unshard(mesh, ys, spec, x.device),
            pm.unshard(mesh, aux, P(), x.device))
