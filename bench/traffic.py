"""The one traffic generator: a traffic file's parameters and a seed in,
requests or training batches out.

Sizes come from a fixed multiset: ``block`` requests whose prompt and
output lengths are drawn once from the file's distributions with the
file's own ``size_seed``.  Every seed serves the same blocks, each in an
order of its own, and draws its own token ids, so two seeds do the same
amount of work and differ in which request comes when.  Open-loop
arrivals do the same with the gaps between them: a block's gaps are a
fixed set of exponential draws at the file's rate, shuffled by the seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Req:
    """One request: when it is due (seconds from the schedule's start),
    its prompt's token ids and how many tokens it asks for."""
    idx: int
    due: float
    prompt: np.ndarray
    max_new: int


def _lengths(spec: dict, n: int, rng) -> np.ndarray:
    """``n`` lengths from ``spec`` = {dist: lognormal, median, sigma, min,
    max}, rounded and clipped."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def block_sizes(traffic: dict) -> list[tuple[int, int]]:
    """The fixed block of (prompt length, output length) pairs every seed
    serves."""
    rng = np.random.default_rng(traffic["size_seed"])
    n = traffic["block"]
    return list(zip(_lengths(traffic["prompt"], n, rng).tolist(),
                    _lengths(traffic["output"], n, rng).tolist()))


def block_gaps(traffic: dict) -> np.ndarray:
    """The fixed block of inter-arrival gaps (seconds) of an open loop at
    ``rate_per_s``: exponential draws scaled so their mean is exactly one
    over the rate."""
    rng = np.random.default_rng(traffic["size_seed"] + 1)
    g = rng.exponential(1.0, traffic["block"])
    return g / g.mean() / traffic["rate_per_s"]


def prompt_lengths(traffic: dict) -> list[int]:
    """Every distinct prompt length the traffic sends (what set-up warms)."""
    return sorted({p for p, _ in block_sizes(traffic)})


def requests(traffic: dict, seed: int, vocab: int, n: int) -> list[Req]:
    """The first ``n`` requests of the schedule for ``seed``: whole blocks,
    each block's requests (and, for an open loop, its gaps) in an order
    drawn from the seed; token ids uniform over the vocabulary.  A batch
    traffic's requests are all due at 0."""
    rng = np.random.default_rng(seed)
    sizes = block_sizes(traffic)
    gaps = block_gaps(traffic) if traffic["kind"] == "open" else None
    out: list[Req] = []
    t = 0.0
    while len(out) < n:
        order = rng.permutation(len(sizes))
        gorder = rng.permutation(len(sizes))
        for j, i in enumerate(order):
            if len(out) == n:
                break
            plen, olen = sizes[i]
            if gaps is not None:
                t += float(gaps[gorder[j]])
            prompt = rng.integers(0, vocab, plen, dtype=np.int64)
            out.append(Req(len(out), t, prompt.astype(np.int32), int(olen)))
    return out


def train_batch(traffic: dict, seed: int, step: int, vocab: int):
    """Step ``step``'s batch as numpy arrays: ``tokens`` and ``labels``
    [batch, seq] int32, the labels the next token of a sequence one longer
    than the row, so every row and every step differ.  Drawn from
    (seed, step) alone, so any step's batch can be made again."""
    rng = np.random.default_rng([seed, step])
    b, s = traffic["batch"], traffic["seq"]
    seq = rng.integers(0, vocab, (b, s + 1), dtype=np.int64).astype(np.int32)
    return {"tokens": seq[:, :-1].copy(), "labels": seq[:, 1:].copy()}
