"""Pipeline parallelism (GPipe) over a ``pipe`` mesh axis (the port of
``repro.parallel.pipeline``).

Schedule: GPipe with M microbatches over P stages.  Each stage holds its
slice of the layer stack; every tick each stage runs its layers on what
it holds (stage 0 on the next microbatch, the others on what the stage
before sent them, zeros in the bubble), the last stage keeps the
microbatch that leaves the pipe, and the activations move one stage on
by ``ppermute``.  The ticks run in lockstep on the single-controller
mesh of ``parallel/mesh.py`` (each tick every member's layers, member
after member), M + P - 1 of them, so the steady-state bubble is
(P - 1) / (M + P - 1) of the work.  At the end a ``psum`` of each
member's outputs times its one-hot ownership gives every member the
last stage's, as the reference's replicated ``out_specs`` asks.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.tree import leaves, tree_map

from . import mesh as pm
from .mesh import P


def _layers(stacked_params) -> list:
    """Per-layer parameter trees: the port's list of layers as it is, or
    a tree whose tensors stack the layers along a leading axis (the
    reference's form) split along it."""
    if isinstance(stacked_params, list):
        return stacked_params
    n = leaves(stacked_params)[0].shape[0]
    return [tree_map(lambda t, i=i: t[i], stacked_params) for i in range(n)]


def pipeline_apply(block_fn: Callable, stacked_params, x: torch.Tensor, *,
                   mesh, axis: str = "pipe",
                   microbatches: int | None = None) -> torch.Tensor:
    """y = the fold of ``block_fn(layer_params, x)`` over the L layers of
    ``stacked_params``, the layers split over ``axis`` (L % P == 0, each
    stage L / P in order) and x [B, ...] into ``microbatches`` (default
    P; B % M == 0), computed with the GPipe rotation (module
    docstring)."""
    n_stages = mesh.shape[axis]
    mb = microbatches or n_stages
    layers = _layers(stacked_params)
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers over {n_stages} stages")
    b = x.shape[0]
    if b % mb:
        raise ValueError(f"batch {b} over {mb} microbatches")
    per = len(layers) // n_stages
    mb_size = b // mb
    xs = pm.shard(mesh, x, P())

    def stage_of(member):
        return pm.axis_index(mesh, member, axis)

    params = {}
    for member in mesh.members():
        dev = mesh.device(member)
        s = stage_of(member)
        params[member] = [tree_map(lambda t: t.to(dev), lp)
                          for lp in layers[s * per:(s + 1) * per]]
    micro = pm.map_members(
        mesh, lambda m, xm: xm.reshape((mb, mb_size) + xm.shape[1:]), xs)
    buf = pm.map_members(mesh, lambda m, mi: torch.zeros_like(mi[0]), micro)
    out = pm.map_members(mesh, lambda m, mi: torch.zeros_like(mi), micro)
    fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    for t in range(mb + n_stages - 1):
        def tick(member, mi, cur, o):
            stage = stage_of(member)
            if stage == 0:
                cur = mi[min(t, mb - 1)]
            for lp in params[member]:
                cur = block_fn(lp, cur)
            emit = t - (n_stages - 1)
            if emit >= 0 and stage == n_stages - 1:
                o = torch.cat([o[:emit], cur[None].to(o.dtype),
                               o[emit + 1:]])
            return cur, o

        ys, out = pm.map_members(mesh, tick, micro, buf, out)
        buf = pm.ppermute(mesh, ys, axis, fwd)
    owned = pm.map_members(
        mesh, lambda m, o: o * float(stage_of(m) == n_stages - 1), out)
    total = pm.psum(mesh, owned, axis)
    return pm.unshard(mesh, total, P(), x.device).reshape(x.shape)
