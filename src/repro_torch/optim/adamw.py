"""AdamW with global-norm clipping and a cosine schedule, leaf for leaf
over the port's parameter tree (the port of ``repro.optim.adamw``).

Moments are fp32 tensors beside each parameter; the arithmetic is the
reference's, in fp32 on the parameters' device: b1 0.9, b2 0.95, eps
1e-8, the clip scale ``min(1, clip / (gnorm + 1e-9))``, bias correction,
weight decay on every leaf, and the new parameter cast back to its own
dtype.  Updates run under ``torch.no_grad()`` and return a new parameter
tree; the moments are updated in place (the state passed in is the
state returned, its count a new tensor), so a step holds one set of
moments, not two: 8 bytes a parameter less at the update's peak.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import leaves, tree_map, unflatten


@dataclasses.dataclass
class AdamWState:
    m: Any
    v: Any
    count: torch.Tensor  # 0-d int32 on the parameters' device


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=device))


def opt_state_logical(param_logical) -> AdamWState:
    """The moments' logical axes, their parameters' (``count`` a
    scalar)."""
    return AdamWState(m=param_logical, v=param_logical, count=())


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def cosine_schedule(step, *, base_lr=3e-4, warmup=100, total=10000,
                    min_ratio=0.1, device=None) -> torch.Tensor:
    """Linear warmup to ``base_lr``, then a cosine down to ``min_ratio``
    of it at ``total``: a 0-d float32 tensor."""
    step = torch.as_tensor(step, device=device).to(torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                     (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """One AdamW step with global-norm clipping, the moments of ``state``
    updated in place.  Returns (params, state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c

    def upd(g, m, v, p):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + eps)
        pf = p.float()
        new_p = pf - lr * (step + weight_decay * pf)
        return new_p.to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        leaves(grads), leaves(state.m), leaves(state.v), leaves(params))]
    return (unflatten(params, [o[0] for o in out]),
            AdamWState(m=unflatten(params, [o[1] for o in out]),
                       v=unflatten(params, [o[2] for o in out]),
                       count=count),
            {"grad_norm": gnorm, "clip_scale": scale})
