"""How ``correct`` is decided: what the timed path produced, held against
the plain float32 reference (``reference/``) by the numbers and limits of
``limits/<cell>.json``.

Serving: a sample of the requests the window finished, drawn from the
seed and holding the one with the most served tokens, is run through the
reference over its prompt and served tokens; at every served position the
number is how far the served token's reference logit lies below the
reference's best: ``widest_gap``, the widest over the sample, and
``mean_gap``, their mean over every served position (each compared where
``limits/<cell>.json`` gives it a limit).

Training: the first steps' losses, each leaf's norm of the first clipped
gradient (read from the optimizer's first moment after one step) and each
leaf's norm of the parameters' change after the checked steps, against
the reference's; a leaf's gap is measured against the larger of the
reference's norm of that leaf and of the median leaf (``leaf_gap``), and
the median leaf's gap of the first gradient (``grad_median_gap``), which
the near-tie routing of one small leaf does not set.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np


def sample_requests(done: list, seed: int, spec: dict) -> list:
    """The finished requests to check: the one with the most served
    tokens, then others in an order drawn from the seed, until
    ``served_tokens`` tokens or ``max_requests`` requests."""
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r["tokens"]), -r["due"]))
    rng = np.random.default_rng([seed, 7])
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    out, served = [longest], len(longest["tokens"])
    for r in rest:
        if served >= spec["served_tokens"] or len(out) >= spec["max_requests"]:
            break
        out.append(r)
        served += len(r["tokens"])
    return out


def gaps(logits, served) -> list[float]:
    """At each position, the reference's best logit less that of the
    token served there."""
    best = logits.max(dim=-1).values
    picked = logits.gather(-1, served[:, None])[:, 0]
    return (best - picked).tolist()


def _seq_tensors(torch, seqs, device):
    """(sequences the reference reads, first position read, served token
    ids): a prompt and its served tokens but the last."""
    tok, starts, served = [], [], []
    for prompt, out in seqs:
        full = np.concatenate([np.asarray(prompt, np.int64),
                               np.asarray(out[:-1], np.int64)])
        tok.append(torch.as_tensor(full, device=device))
        starts.append(len(prompt) - 1)
        served.append(torch.as_tensor(np.asarray(out, np.int64),
                                      device=device))
    return tok, starts, served


def served(ctx, params, cfg: dict, seqs, limits: dict) -> list[dict]:
    """The serving cell's numbers over the sample, ``widest_gap`` and
    ``mean_gap``; those ``limits`` names are compared (no finished request
    reads infinite)."""
    from reference import decoder as D

    torch = ctx.torch
    D.strict_fp32()
    t0 = time.perf_counter()
    tok, starts, srv = _seq_tensors(torch, seqs, ctx.device)
    logits = D.served_logits(params, cfg, tok, starts)
    every = [g for lg, s in zip(logits, srv) for g in gaps(lg, s)]
    ctx.note(f"check sample: {len(seqs)} requests, "
             f"{sum(len(s) for s in srv)} served tokens; reference "
             f"{time.perf_counter() - t0:.1f} s")
    numbers = {"widest_gap": max(every, default=math.inf),
               "mean_gap": sum(every) / len(every) if every else math.inf}
    ctx.result_extra["readings"] = numbers
    return [n for n in (_number(k, v, limits) for k, v in numbers.items())
            if n is not None]


def control_gap(ctx, params, cfg: dict, seqs) -> dict:
    """The control's reading on the same sample: at each served position
    the token the fp8 reference puts first, and how far its float32
    reference logit lies below the best."""
    from reference import decoder as D

    torch = ctx.torch
    D.strict_fp32()
    tok, starts, srv = _seq_tensors(torch, seqs, ctx.device)
    ref = D.served_logits(params, cfg, tok, starts)
    low = D.served_logits(params, cfg, tok, starts, precision="fp8")
    fp8 = [g for r, lo in zip(ref, low) for g in gaps(r, lo.argmax(dim=-1))]
    prog = [g for r, s in zip(ref, srv) for g in gaps(r, s)]
    return {"widest_gap_fp8": max(fp8), "mean_gap_fp8": sum(fp8) / len(fp8),
            "widest_gap_program": max(prog),
            "mean_gap_program": sum(prog) / len(prog)}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |program norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf; ``keep`` limits
    the leaves compared."""
    med = statistics.median(ref[k] for k in ref)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in ref if keep is None or k in keep}


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap (``leaf_gaps``) and its path."""
    gaps = leaf_gaps(prog, ref, keep)
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def trained(prog: dict, ref: dict, limits: dict) -> list[dict]:
    """The training cell's numbers: the worst step's relative loss gap,
    the worst leaf's gap of the first gradient and of the change.  A leaf
    whose reference gradient is under a thousandth of the median leaf's
    moves by round-off alone and is left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    grad, grad_at = leaf_gap(prog["grad"], ref["grad"])
    grad_median = statistics.median(leaf_gaps(prog["grad"], ref["grad"]).values())
    med = statistics.median(ref["grad"].values())
    moved = {k for k, g in ref["grad"].items() if g >= 1e-3 * med}
    change, change_at = leaf_gap(prog["change"], ref["change"], moved)
    numbers = [_number("loss_gap", loss, limits),
               _number("grad_gap", grad, limits, grad_at),
               _number("grad_median_gap", grad_median, limits),
               _number("change_gap", change, limits, change_at)]
    return [n for n in numbers if n is not None]


def _number(name, value, limits, where=""):
    """A compared number beside its limit; None where ``limits`` gives
    it none."""
    if name not in limits:
        return None
    lim = limits[name]["limit"]
    return {"name": name, "value": value, "limit": lim,
            "ok": bool(value <= lim), "where": where}
