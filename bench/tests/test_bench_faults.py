"""A run with its timed path broken comes out not correct: the harness's
look for a card skipped, the rest of a run driven on the CPU at a toy
size, with each fault the cell can have planted underneath, and the
cell's own limits.  (One card, no exchange between chips: that fault has
no place here.)"""

import pytest

import tiny


@pytest.mark.parametrize("name", ["olmoe-chat", "stablelm-batch"])
def test_sound_serving_run_is_correct(name):
    _, out = tiny.run_tiny(name)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["olmoe-chat", "stablelm-batch"])
def test_token_altered_where_produced_is_not_correct(name):
    _, out = tiny.run_tiny(name, fault="token")
    assert not out["correct"], out["checks"]


def test_sound_training_run_is_correct():
    _, out = tiny.run_tiny("olmoe-train", seconds=0.3)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_broken_training_step_is_not_correct(fault):
    _, out = tiny.run_tiny("olmoe-train", seconds=0.3, fault=fault)
    assert not out["correct"], out["checks"]
