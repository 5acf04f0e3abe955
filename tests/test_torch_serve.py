"""The port's slot engine serves the reference's greedy tokens.

The same 6 requests (prompts drawn with numpy) go through the JAX
``ServeEngine`` and the port's engine on the same parameters.  Greedy
tokens must be identical, and identical again between 1 and 3 slots.
The ``_write_lane`` dtype guard and the engine surface are ported too
(the paged engine is held in ``test_torch_paged.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.autotune import PlanPolicy as JaxPolicy  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serve import make_engine, validate_request  # noqa: E402

ARCH = "qwen1.5-0.5b"
MAX_SEQ = 48


@pytest.fixture(scope="module")
def served():
    cfg = jax_smoke(ARCH)
    jparams = jax_build(cfg).init(jax.random.PRNGKey(42))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(3, 12)))
               for _ in range(6)]
    budgets = [int(rng.integers(1, 9)) for _ in prompts]

    jeng = JaxEngine(cfg, max_slots=3, max_seq=MAX_SEQ,
                     policy=JaxPolicy(mode="modelled"))
    jeng.load(jparams)
    for p, n in zip(prompts, budgets):
        jeng.submit(p, max_new_tokens=n)
    want = {r.rid: list(r.output) for r in jeng.run_until_drained()}

    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              get_smoke_config(ARCH), "cpu")
    got = {}
    engines = {}
    for slots in (1, 3):
        eng = make_engine(get_smoke_config(ARCH), kind="slot",
                          max_slots=slots, max_seq=MAX_SEQ, device="cpu")
        eng.load(tparams)
        for p, n in zip(prompts, budgets):
            eng.submit(p, max_new_tokens=n)
        got[slots] = {r.rid: list(r.output) for r in eng.run_until_drained()}
        engines[slots] = eng
    return want, got, budgets, engines


def test_greedy_tokens_equal_reference_engine(served):
    want, got, budgets, _ = served
    assert got[3] == want
    assert [len(want[i]) for i in range(len(budgets))] == budgets


def test_outputs_identical_for_1_and_3_slots(served):
    _, got, _, _ = served
    assert got[1] == got[3]


def test_engine_drains_and_frees_every_lane(served):
    *_, engines = served
    for eng in engines.values():
        assert eng.queue == [] and all(s is None for s in eng.slots)


def test_load_reports_the_warmup_plans(served):
    *_, engines = served
    report = engines[3].plan_report
    assert {"attn.decode_scores", "attn.decode_values", "lm_head",
            "mlp.down"} <= set(report)
    assert all(st["fallback"] == 0 for st in report.values())
    assert engines[3].autotune_report["measure_calls"] == 0


def test_write_lane_rejects_a_mismatched_cache_dtype(served):
    *_, engines = served
    eng = engines[3]
    bad = eng.api.init_cache(1, MAX_SEQ)
    bad["k"] = bad["k"].float()
    with pytest.raises(TypeError, match="dtype"):
        eng._write_lane(0, bad)


def test_requests_past_the_horizon_are_rejected():
    with pytest.raises(ValueError, match="max_seq"):
        validate_request(np.zeros(40, np.int32), 9, MAX_SEQ)
    with pytest.raises(ValueError, match="max_new_tokens"):
        validate_request(np.zeros(4, np.int32), 0, MAX_SEQ)


def test_unported_engine_kinds_raise():
    """The block-paged engine is ported: ``kind="paged"`` builds it; a
    kind neither package has still raises."""
    from repro_torch.serve import PagedServeEngine

    cfg = get_smoke_config(ARCH)
    assert isinstance(make_engine(cfg, kind="paged", device="cpu"),
                      PagedServeEngine)
    with pytest.raises(ValueError, match="unknown engine kind"):
        make_engine(cfg, kind="bogus", device="cpu")
