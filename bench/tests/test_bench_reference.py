"""The plain reference against the port at a tiny size on the CPU, in
float32: the served logits of prefill and of decoding through the paged
cache, and three training steps (loss, first gradient, change)."""

import numpy as np
import pytest
import torch

import tiny
import weights as W
import yardstick as Y
from reference import decoder as D
from reference import train as R


def _engine_tokens(cell, seed=3):
    from repro_torch.serve import make_engine

    import harness

    conf, tr = cell["config"], cell["traffic"]
    params = W.make(torch, conf["port"], seed, "cpu")
    eng = make_engine(harness.port_config(conf), "paged", max_lanes=4,
                      max_seq=40, block_size=8, device="cpu")
    eng.load(params)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, conf["port"]["vocab"], n).astype(np.int32)
               for n in (5, 9, 17, 12, 30)]
    for p in prompts:
        eng.submit(p, 8)
    done = sorted(eng.run_until_drained(), key=lambda r: r.rid)
    return params, conf["port"], [(r.prompt, r.output) for r in done]


@pytest.mark.parametrize("name", ["olmoe-chat", "stablelm-batch"])
def test_served_tokens_are_the_reference_argmax(name):
    """In float32 the port's greedy tokens (prefill, then decode through
    the paged cache at 4 lanes) are the reference's argmax at every
    position, to within rounding."""
    params, cfg, seqs = _engine_tokens(tiny.tiny_cell(name))
    toks = [torch.as_tensor(np.concatenate([p, o[:-1]]).astype(np.int64))
            for p, o in seqs]
    logits = D.served_logits(params, cfg, toks, [len(p) - 1 for p, _ in seqs])
    for (p, o), lg in zip(seqs, logits):
        served = torch.as_tensor(o)
        gap = lg.max(-1).values - lg.gather(-1, served[:, None])[:, 0]
        assert lg.shape[0] == len(o)
        assert float(gap.max()) < 1e-4


def test_reference_logits_match_the_port_forward():
    from repro_torch.models import build_model

    import harness

    cell = tiny.tiny_cell("olmoe-chat")
    conf = cell["config"]
    params = W.make(torch, conf["port"], 4, "cpu")
    api = build_model(harness.port_config(conf), "cpu")
    tokens = torch.randint(0, 256, (1, 21), generator=torch.Generator().manual_seed(0))
    got, _ = api.prefill(params, {"tokens": tokens}, 32)
    want = D.served_logits(params, conf["port"], [tokens[0].long()], [20])[0]
    assert torch.allclose(got[0], want[0], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("capacity_factor", [1.25, None])
def test_reference_training_steps_match_the_port(capacity_factor):
    """Three AdamW steps of the tiny MoE (capacity 1.25: assignments drop;
    None: dropless) from the benchmark's weights: the reference's losses,
    first clipped gradients and changes equal the port's train step's."""
    cell = tiny.tiny_cell("olmoe-train", capacity_factor=capacity_factor)
    import run

    ctx = run.Context(torch, cell, 11, 0.05, False, device="cpu")
    rec = run.measure(ctx)
    r = ctx.result_extra["readings"]
    assert len(r["program"]["loss"]) == 3
    for c in rec["checks"]:
        assert c["value"] < 1e-4, c
    if capacity_factor == 1.25:
        pc = cell["config"]["port"]
        assert Y.capacity(pc, 32) < 32 * pc["moe_top_k"]


def test_fp8_control_rounds_operands():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    w = torch.randn(64, 8, generator=torch.Generator().manual_seed(2))
    exact = D.mm(x, w, "fp32")
    low = D.mm(x, w, "fp8")
    rel = float((low - exact).norm() / exact.norm())
    assert 1e-3 < rel < 0.2


def test_lr_schedule_is_the_cosine():
    opt = {"base_lr": 1.0, "warmup": 0, "total_steps": 100, "min_ratio": 0.1}
    assert R.lr_at(opt, 0) == pytest.approx(1.0)
    assert R.lr_at(opt, 100) == pytest.approx(0.1)
    assert R.lr_at(dict(opt, warmup=10), 5) == pytest.approx(0.5)
