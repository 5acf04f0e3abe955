"""The control: the reference with float8 operands, put in the program's
place.  On the CPU at a toy size in bf16, its mean gap lies well above
the program's; on the card (``gpu``) at the cell's own size it fails the
cell's limit while the program passes it."""

import copy

import pytest
import torch

import tiny
import check
import run


def test_control_reads_wider_than_bf16_program_on_cpu():
    cell = tiny.tiny_cell("olmoe-chat")
    cell["config"]["port"].update(dtype="bfloat16", kv_cache_dtype="bfloat16")
    ctx = run.Context(torch, cell, 21, 1.0, False, device="cpu",
                      control=True)
    rec = run.measure(ctx)
    c = rec["control"]
    assert c["mean_gap_fp8"] > 3 * c["mean_gap_program"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["olmoe-chat", "stablelm-batch"])
def test_control_fails_the_limit_on_the_card(card, name):
    import harness

    cell = copy.deepcopy(harness.cell(name))
    ctx = run.Context(torch, cell, 2**31 + 101, 10.0, False, control=True)
    rec = run.measure(ctx)
    lim = cell["limits"]["mean_gap"]["limit"]
    assert all(c["ok"] for c in rec["checks"])
    assert rec["control"]["mean_gap_fp8"] > lim


@pytest.mark.gpu
def test_training_control_fails_a_limit_on_the_card(card):
    import harness

    cell = copy.deepcopy(harness.cell("olmoe-train"))
    ctx = run.Context(torch, cell, 2**31 + 101, 5.0, False, control=True)
    rec = run.measure(ctx)
    assert all(c["ok"] for c in rec["checks"])
    low = ctx.result_extra["control"]
    assert any(low[k] > cell["limits"][k]["limit"] for k in low)
