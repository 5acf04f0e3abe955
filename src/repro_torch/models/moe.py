"""Mixture-of-Experts block of the port (``repro.models.moe``): top-k
routing, capacity with drop-on-overflow, shared experts, on one device.

Routing is the reference's: an fp32 router GEMM (``planned_dense`` at
``moe.router``), softmax, top-k (ties to the lower expert index, as
``lax.top_k``), the k weights renormalised (``route``).  Dispatch is
sort-based (``dispatch_indices``): the T·k assignments sorted stably by
expert, each ranked within its expert by ``searchsorted``, those ranked
at ``capacity = max(1, ceil(T·k·cf / E))`` or later dropped.  The kept
rows fill an [E, C, d] buffer (``dispatch``), the expert stack runs as
three planned bmm calls over [E, C, d] x [E, d, ff] (``expert_ffn``:
``moe.gate``, ``moe.up``, ``moe.down``) and each token sums its k
weighted expert outputs (``combine``).  Shared experts (deepseek-v2's
2, ``moe_shared_experts``) run as one GLU over every token beside the
routed ones, at the planned ``moe.shared_gate``/``up``/``down`` sites: on
the card, the same hand kernels.

Two things differ from the reference's form, not from its result:

* the buffer is gathered (each slot reads the row of the assignment
  ranked there) instead of scatter-added, and the combine un-permutes
  the contributions to [T, k] and adds each token's in ascending expert
  order, one add at a time in the compute dtype: the order of the
  reference's ``.at[token].add`` over the expert-sorted assignments.  No
  atomics, so repeated drains give the same bits;
* nothing waits on the host (no boolean-mask indexing, ``nonzero`` or
  ``.item()``; the capacity is a Python int of T), so the paged engine's
  decode step, which routes every lane, inactive ones too, as the
  reference does, is captured as one CUDA graph.

Training adds the reference's Switch-style load-balance term
(``load_balance_loss``: E · Σ_e f_e · P̄_e over the flattened
assignments) where the loss asks for it (``with_aux``); serving on one
device computes none.

Under a mesh context (``parallel/sharding.py``) ``apply_moe`` takes the
reference's mesh paths, on the single-controller mesh of
``parallel/mesh.py`` (every member's work issued in turn):

* TP-MoE (``_moe_shard_map``): tokens split over ``batch``, experts over
  ``experts``; each member routes its tokens over all experts and keeps
  the assignments to its own (``moe_ffn_tokens(local_experts=(start,
  count))``: the others dropped, the slots re-based), a ``psum`` of y
  over the expert axis and a ``pmean`` of the load-balance term;
* EP all-to-all (``parallel.collectives.moe_ep_alltoall``, where the
  config sets ``moe_ep``): tokens split over ``batch`` and their
  sequence over ``experts``, two ``all_to_all`` of the dispatched rows.

Each member's load-balance term is its own tokens' and the members
take its mean: the reference's value, which is not the global batch's
term (``parallel/mesh.py``'s ``unshard`` gives its gradient as the
reference's transpose does).  Capacity is each member's, so the mesh
paths drop other assignments than one device does unless nothing
drops.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.planned import planned_bmm, planned_dense
from repro_torch.parallel import mesh as pm
from repro_torch.parallel.mesh import P
from repro_torch.parallel.sharding import current_mesh

from . import layers as L


def init_moe(cfg, generator: torch.Generator, device="cuda") -> dict:
    """Random weights drawn on ``device`` with the reference's scales: the
    router [d, E] fp32 at 0.02, the experts [E, d, ff] / [E, ff, d] at
    N(0, 1/d_in) in the compute dtype, and the shared experts' GLU when
    ``moe_shared_experts`` > 0."""
    d, e, ff = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
    dt = L.compute_dtype(cfg)

    def normal(shape, scale, dtype=dt):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    p = {"router": normal((d, e), 0.02, torch.float32),
         "wg": normal((e, d, ff), 1.0 / math.sqrt(d)),
         "wu": normal((e, d, ff), 1.0 / math.sqrt(d)),
         "wd": normal((e, ff, d), 1.0 / math.sqrt(ff))}
    if cfg.moe_shared_experts:
        sf = cfg.moe_shared_experts * cfg.moe_d_ff
        p["shared_wg"] = normal((d, sf), 1.0 / math.sqrt(d))
        p["shared_wu"] = normal((d, sf), 1.0 / math.sqrt(d))
        p["shared_wd"] = normal((sf, d), 1.0 / math.sqrt(sf))
    return p


def moe_specs(cfg) -> dict:
    """The block's logical axes (``init_moe``'s tree)."""
    s = {
        "router": ("d_model", None),
        "wg": ("experts", "d_model", None),
        "wu": ("experts", "d_model", None),
        "wd": ("experts", None, "d_model"),
    }
    if cfg.moe_shared_experts:
        s |= {
            "shared_wg": ("d_model", "ff"),
            "shared_wu": ("d_model", "ff"),
            "shared_wd": ("ff", "d_model"),
        }
    return s


def capacity_of(cfg, t: int) -> int:
    """Slots an expert holds for a batch of ``t`` tokens."""
    return max(1, int(math.ceil(
        t * cfg.moe_top_k * cfg.moe_capacity_factor / cfg.moe_num_experts)))


def route(cfg, logits):
    """softmax -> top-k -> renormalise.  logits: [T, E] ->
    (weights [T, k] fp32, ids [T, k] int64, probs [T, E] fp32).  A stable
    descending sort puts equal probabilities in index order, so ties go
    to the lower expert, as ``lax.top_k`` breaks them."""
    probs = torch.softmax(logits.float(), dim=-1)
    top, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    weights, ids = top[:, :k], ids[:, :k]
    return weights / weights.sum(dim=-1, keepdim=True), ids, probs


def load_balance_loss(cfg, probs, ids):
    """The Switch-style load-balance term E · Σ_e f_e · P̄_e: f_e the share
    of the assignments ``ids`` [..., k] that went to expert e, P̄_e the
    mean routing probability ``probs`` [..., E] of e (leading axes
    flattened); its gradient flows through P̄ only.  The counts are sums
    of ones in fp32, exact in any order."""
    e = cfg.moe_num_experts
    flat = ids.reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=flat.device)
    counts.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32,
                                           device=flat.device))
    f = counts / counts.sum().clamp(min=1.0)
    p_mean = probs.reshape(-1, e).mean(dim=0)
    return e * (f * p_mean).sum()


def dispatch_indices(cfg, ids, capacity: int):
    """Sort-based dispatch of the assignments ``ids`` [T, k] (assignment
    ``a = t*k + j``), as flat [T*k] tensors in expert-sorted order:
    ``order`` (the assignment at each sorted position), ``slot`` (expert
    x capacity + rank, the rank clamped to the last slot), ``keep`` (rank
    below capacity) and ``token``."""
    del cfg
    t, k = ids.shape
    ids_flat = ids.reshape(-1)
    order = torch.argsort(ids_flat, stable=True)
    sorted_experts = ids_flat[order]
    first = torch.searchsorted(sorted_experts, sorted_experts, side="left")
    rank = torch.arange(t * k, device=ids.device) - first
    keep = rank < capacity
    slot = sorted_experts * capacity + rank.clamp(max=capacity - 1)
    return order, slot, keep, order // k


def dispatch(x_flat, slot, token, n_exp: int, capacity: int,
             start: int = 0):
    """The buffer [E, C, d] of experts ``start`` to ``start + E``: slot c
    of expert e holds the row of the token whose assignment ranks c-th at
    e (sorted position ``first[e] + c``), zeros where fewer than c + 1
    came.  A gather: every slot reads one row, so no two writes meet."""
    experts = slot // capacity  # each sorted assignment's expert
    bounds = torch.arange(start, start + n_exp, device=slot.device)
    first = torch.searchsorted(experts, bounds, side="left")
    last = torch.searchsorted(experts, bounds, side="right")
    pos = first[:, None] + torch.arange(capacity, device=slot.device)
    rows = x_flat[token[pos.clamp(max=token.numel() - 1)]]
    return rows.masked_fill_((pos >= last[:, None])[..., None], 0)


def expert_ffn(cfg, wg, wu, wd, x):
    """x: [E, C, d] -> [E, C, d]: the expert stack's GLU as three planned
    bmm calls."""
    act = L.activation(cfg)
    h = act(planned_bmm(x, wg, site="moe.gate")) * planned_bmm(
        x, wu, site="moe.up")
    return planned_bmm(h, wd, site="moe.down")


def combine(out_buf, weights, order, slot, keep):
    """y [T, d]: each token's k expert outputs (rows of ``out_buf`` [E*C,
    d]) times their weights, dropped ones times 0, added one at a time in
    ascending expert order in the compute dtype."""
    t, k = weights.shape
    dt = out_buf.dtype
    # each token's sorted positions, in ascending order: its experts'
    pos = torch.argsort(order).view(t, k).sort(dim=-1).values
    w = weights.reshape(-1)[order[pos]].to(dt)
    rows = out_buf[slot[pos]] * w[..., None] * keep[pos].to(dt)[..., None]
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    return y


def moe_ffn_tokens(cfg, p, x_flat, with_aux: bool = False, *,
                   local_experts: tuple[int, int] | None = None):
    """Route, dispatch, expert FFN and combine for a flat token batch
    x_flat [T, d] -> [T, d]; with ``with_aux``, (y, the batch's
    load-balance term).  ``local_experts`` (start, count): ``p``'s expert
    weights are those experts' only, the assignments to any other are
    dropped and the slots re-based, so y holds the shard's contribution
    (the TP-MoE path sums the shards')."""
    t, d = x_flat.shape
    capacity = capacity_of(cfg, t)
    logits = planned_dense(x_flat.float(), p["router"], site="moe.router")
    weights, ids, probs = route(cfg, logits)
    order, slot, keep, token = dispatch_indices(cfg, ids, capacity)
    start, n_exp = local_experts or (0, cfg.moe_num_experts)
    buf = dispatch(x_flat, slot, token, n_exp, capacity, start)
    if local_experts is not None:
        expert = slot // capacity
        keep = keep & (expert >= start) & (expert < start + n_exp)
        slot = (slot - start * capacity).clamp(0, n_exp * capacity - 1)
    out = expert_ffn(cfg, p["wg"], p["wu"], p["wd"], buf)
    y = combine(out.reshape(n_exp * capacity, d), weights, order, slot, keep)
    if with_aux:
        return y, load_balance_loss(cfg, probs, ids)
    return y


def _moe_shard_map(p, cfg, x, ctx):
    """TP-MoE on the context's mesh: tokens split over the batch axis and
    replicated over the expert axis, each member's experts' contribution
    from ``moe_ffn_tokens(local_experts=...)``, a ``psum`` of y and a
    ``pmean`` of the load-balance term over the expert axis.  Returns
    (y [B, S, d], aux)."""
    mesh = ctx.mesh
    exp_axis = ctx.rules.get("experts", "model")
    batch_axis = ctx.rules.get("batch", "data")
    n_exp_shards = mesh.shape[exp_axis] if exp_axis in mesh.shape else 1
    e_loc = cfg.moe_num_experts // n_exp_shards
    xs = pm.shard(mesh, x, P(batch_axis, None, None))
    router = pm.shard(mesh, p["router"], P(None, None))
    wg, wu, wd = (pm.shard(mesh, p[k], P(exp_axis, None, None))
                  for k in ("wg", "wu", "wd"))

    def local(member, x_loc, r, g, u, dn):
        b_loc, s, d = x_loc.shape
        shard = pm.axis_index(mesh, member, exp_axis)
        y, aux = moe_ffn_tokens(
            cfg, {"router": r, "wg": g, "wu": u, "wd": dn},
            x_loc.reshape(b_loc * s, d), True,
            local_experts=(shard * e_loc, e_loc))
        return y.reshape(b_loc, s, d), aux

    y, aux = pm.map_members(mesh, local, xs, router, wg, wu, wd)
    y = pm.psum(mesh, y, exp_axis)
    aux = pm.pmean(mesh, aux, exp_axis)
    return (pm.unshard(mesh, y, P(batch_axis, None, None), x.device),
            pm.unshard(mesh, aux, P(), x.device))


def apply_moe(p, cfg, x, with_aux: bool = False):
    """MoE forward: x [B, S, d] -> [B, S, d], plus the shared experts' GLU
    (``moe.shared_gate``/``up``/``down``) over every token when the
    config has them; with ``with_aux``, (y, the load-balance term).
    Under a mesh context the EP all-to-all path runs where the config
    sets ``moe_ep``, else the TP-MoE path; on one device every B·S token
    is routed together (module docstring)."""
    b, s, d = x.shape
    ctx = current_mesh()
    if ctx is not None and ctx.mesh is not None:
        if cfg.moe_ep:
            from repro_torch.parallel.collectives import moe_ep_alltoall
            y, aux = moe_ep_alltoall(cfg, p, x, ctx)
        else:
            y, aux = _moe_shard_map(p, cfg, x, ctx)
    else:
        y = moe_ffn_tokens(cfg, p, x.reshape(b * s, d), with_aux)
        if with_aux:
            y, aux = y
        y = y.reshape(b, s, d)
    if cfg.moe_shared_experts:
        act = L.activation(cfg)
        h = act(planned_dense(x, p["shared_wg"], site="moe.shared_gate")) \
            * planned_dense(x, p["shared_wu"], site="moe.shared_up")
        y = y + planned_dense(h, p["shared_wd"], site="moe.shared_down")
    return (y, aux) if with_aux else y
