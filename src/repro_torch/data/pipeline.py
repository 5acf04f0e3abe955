"""Deterministic synthetic data pipeline, host-shardable (a copy of
``repro.data.pipeline``).

Batches are numpy arrays and a pure function of (seed, step, host), byte
for byte the reference's: replay after a restart reproduces the exact
stream.  Token streams follow a Markov-ish structure (the next token
depends on the previous one plus noise), so the LM loss decreases during
a short training run instead of sitting at ln(V).
"""

from __future__ import annotations

import numpy as np


class SyntheticPipeline:
    def __init__(self, cfg, shape, *, seed: int = 0, n_hosts: int = 1,
                 host_id: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.n_hosts = n_hosts
        self.host_id = host_id
        if shape.global_batch % n_hosts:
            raise ValueError("global batch must divide hosts")
        self.local_batch = shape.global_batch // n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))

    def batch(self, step: int) -> dict:
        cfg, s = self.cfg, self.shape.seq_len
        b = self.local_batch
        rng = self._rng(step)
        # the stream lives on a small effective vocabulary so a few hundred
        # steps visibly learn it; ids stay valid for any model vocab
        v = min(cfg.vocab, 97)
        s_text = s - cfg.vlm_patches if cfg.family == "vlm" else s
        # markov-ish stream: t_{i+1} = (a * t_i + noise) % V
        toks = np.empty((b, s_text + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        noise = rng.integers(0, 17, (b, s_text))
        for i in range(s_text):
            toks[:, i + 1] = (toks[:, i] * 31 + 7 + noise[:, i]) % v
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        if cfg.family == "vlm":
            out["extra_embeds"] = rng.standard_normal(
                (b, cfg.vlm_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
