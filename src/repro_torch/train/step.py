"""The train step (the port of ``repro.train.step``): loss and gradients
through ``torch.autograd`` (every planned GEMM's backward on the hand
kernels, ``kernels/planned.py``), the cosine schedule, then AdamW.

With ``cfg.grad_accum`` = k > 1 the global batch is split into k
microbatches run one after another, their gradients summed in fp32 and
divided by k, as the reference's scan does.
"""

from __future__ import annotations

import torch

from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.tree import leaves, tree_map, unflatten


def value_and_grad(loss_fn, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)``; a leaf the
    loss does not reach gets a zero gradient."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(live, batch)
        flat = leaves(live)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, flat)]
    return loss.detach(), unflatten(params, grads)


def make_train_step(api, cfg, *, tcfg=None):
    """``train_step(params, opt_state, batch, step)`` -> (params,
    opt_state, metrics) with a ``TrainConfig`` (metrics: ``loss``,
    ``lr``, ``grad_norm``, ``clip_scale``), (params, opt_state, loss)
    without one; ``batch`` holds tensors on the parameters' device."""
    accum = max(getattr(cfg, "grad_accum", 1), 1)
    lr_kwargs = {}
    if tcfg is not None:
        lr_kwargs = dict(base_lr=tcfg.base_lr, warmup=tcfg.warmup,
                         total=tcfg.total_steps)

    def train_step(params, opt_state, batch, step):
        if accum > 1:
            micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                     for k, v in batch.items()}
            total, acc = None, None
            for i in range(accum):
                loss, g = value_and_grad(
                    api.loss, params, {k: v[i] for k, v in micro.items()})
                g = tree_map(lambda x: x.float(), g)
                total = loss if total is None else total + loss
                acc = g if acc is None else tree_map(torch.add, acc, g)
            loss = total / accum
            grads = tree_map(lambda x: x / accum, acc)
        else:
            loss, grads = value_and_grad(api.loss, params, batch)
        lr = cosine_schedule(step, device=loss.device, **lr_kwargs)
        params, opt_state, metrics = adamw_update(
            grads, opt_state, params, lr=lr,
            **({"weight_decay": tcfg.weight_decay,
                "clip_norm": tcfg.clip_norm} if tcfg else {}))
        metrics["loss"] = loss
        metrics["lr"] = lr
        return params, opt_state, metrics if tcfg else loss

    return train_step
