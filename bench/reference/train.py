"""Plain float32 training steps: the masked next-token cross-entropy plus
the MoE layers' load-balance terms, its gradient by autograd, global-norm
clipping and AdamW, from the starting weights the benchmark made.

Parameters are held as the configuration states them, in bf16: each
update is worked out in float32 from the bf16 values and rounded back,
as a model stored in bf16 is; the moments are float32.  Each layer runs
under ``torch.utils.checkpoint`` so that the float32 activations fit.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import decoder as D


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_ratio`` of it at ``total_steps``."""
    base, warm, total = opt["base_lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return base * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * (opt["min_ratio"] + (1 - opt["min_ratio"]) * 0.5
                   * (1 + math.cos(math.pi * prog)))


def loss_fn(leaves: dict, cfg: dict, tokens, labels, precision, capacity):
    """Mean cross-entropy of the next token plus 1e-2 times the summed
    load-balance terms; ``leaves`` maps each leaf's path to a float32
    tensor."""
    x = leaves["embed"][tokens]
    aux_total = x.new_zeros(())
    for i in range(cfg["n_layers"]):
        pre = f"layers/{i}/"
        lw = {k[len(pre):]: v for k, v in leaves.items() if k.startswith(pre)}

        def run(x, *vals, lw=lw):
            return D.block(dict(zip(lw, vals)), cfg, x, precision, capacity)

        x, aux = checkpoint(run, x, *lw.values(), use_reentrant=False)
        aux_total = aux_total + aux
    h = D.rmsnorm(x, leaves["ln_f/w"], cfg["norm_eps"])
    logits = D.mm(h, leaves["lm_head"], precision)
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
    return ce + 1e-2 * aux_total


def steps(paths, start, cfg: dict, batches, opt: dict, precision="fp32",
          capacity=None):
    """Follow ``len(batches)`` training steps from the starting weights
    (``start(path)`` gives a leaf on the card, drawn again each time it
    is asked, so the starting tree need not be kept beside the float32
    state).  Returns the loss of each step, each leaf's norm of the first
    step's clipped gradient, and each leaf's norm of the change after the
    last step."""
    p = {k: start(k).float() for k in paths}
    # the moments wait on the host between steps, so that the float32
    # weights, their gradients and the activations have the card
    host = {"pin_memory": p[paths[0]].is_cuda}
    m = {k: torch.zeros(v.shape, dtype=torch.float32, **host)
         for k, v in p.items()}
    v2 = {k: torch.zeros(v.shape, dtype=torch.float32, **host)
          for k, v in p.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, first_grad = [], {}
    for step, batch in enumerate(batches):
        live = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        with torch.enable_grad():
            loss = loss_fn(live, cfg, batch["tokens"], batch["labels"],
                           precision, capacity)
            grads = torch.autograd.grad(loss, [live[k] for k in paths],
                                        allow_unused=True)
        del live
        grads = [torch.zeros_like(p[k]) if g is None else g
                 for k, g in zip(paths, grads)]
        losses.append(float(loss.detach()))
        del loss
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = min(1.0, opt["clip_norm"] / (float(gnorm) + 1e-9))
        lr = lr_at(opt, step)
        c = step + 1
        with torch.no_grad():
            for i, k in enumerate(paths):
                g = grads[i] * scale
                grads[i] = None
                if step == 0:
                    first_grad[k] = float(g.norm())
                mk = m[k].to(g.device, non_blocking=True)
                vk = v2[k].to(g.device, non_blocking=True)
                mk.mul_(b1).add_((1 - b1) * g)
                vk.mul_(b2).add_((1 - b2) * g * g)
                upd = (mk / (1 - b1 ** c)) / (
                    torch.sqrt(vk / (1 - b2 ** c)) + eps)
                new = p[k] - lr * (upd + opt["weight_decay"] * p[k])
                p[k] = new.to(_dtype(cfg, k)).float()
                m[k].copy_(mk)
                v2[k].copy_(vk)
                del g, mk, vk, upd, new
        del grads
    change = {k: float((p[k] - start(k).float()).norm()) for k in paths}
    return losses, first_grad, change


def _dtype(cfg, path):
    """A leaf's storage dtype: the router is float32, the rest the
    configuration's dtype."""
    if path.endswith("moe/router"):
        return torch.float32
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[cfg.get("dtype", "bfloat16")]
