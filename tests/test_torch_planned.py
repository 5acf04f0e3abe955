"""The port's planned facade decides as the JAX facade does.

The same sequence of GEMM calls — planned, mixed-dtype, unsupported
dtype, infeasible, disabled — goes through both facades on the same numpy
operands (the JAX side under the modelled policy, as the port plans).
Each site must show the same planned/fallback counts, reasons, backends,
shapes and plan descriptions, and the outputs must agree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.autotune import PlanPolicy as JaxPolicy  # noqa: E402
from repro.kernels import planned as jp  # noqa: E402
from repro_torch.kernels import planned as tp  # noqa: E402

#: (function, site, operand shapes, dtype of each operand, kwargs)
CALLS = (
    ("dense", "t.dense", ((8, 32), (32, 64)), ("float32",) * 2, {}),
    ("dense", "t.dense", ((5, 19), (19, 37)), ("int8",) * 2, {}),
    ("dense", "t.lead", ((2, 3, 16), (16, 8)), ("float32",) * 2, {}),
    ("bmm", "t.bmm", ((3, 5, 11), (3, 11, 7)), ("int16",) * 2, {}),
    ("bmm", "t.acc", ((4, 8, 32), (4, 32, 8)), ("bfloat16",) * 2,
     {"out_dtype": "float32"}),
    ("bmm", "t.batch", ((2, 3, 4, 8), (2, 3, 8, 5)), ("int32",) * 2, {}),
    ("dense", "t.mixed", ((8, 16), (16, 8)), ("float32", "int8"), {}),
    ("dense", "t.half", ((8, 16), (16, 8)), ("float16",) * 2, {}),
    ("dense", "t.tiny", ((1, 1), (1, 1)), ("float32",) * 2, {}),
)


def _operands(shapes, dtypes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for shape, dt in zip(shapes, dtypes):
        if dt.startswith("int"):
            out.append(rng.integers(-8, 8, shape).astype(dt))
        else:
            out.append(rng.standard_normal(shape).astype(np.float32))
    return out


def _run_jax(fn, site, arrays, dtypes, kw):
    args = [jnp.asarray(a).astype(d) for a, d in zip(arrays, dtypes)]
    kw = {k: getattr(jnp, v) for k, v in kw.items()}
    f = jp.planned_dense if fn == "dense" else jp.planned_bmm
    out = np.asarray(f(*args, site=site, **kw))
    return out.astype(np.float32) if out.dtype.name == "bfloat16" else out


def _run_torch(fn, site, arrays, dtypes, kw):
    args = [torch.from_numpy(a).to(getattr(torch, d))
            for a, d in zip(arrays, dtypes)]
    kw = {k: getattr(torch, v) for k, v in kw.items()}
    f = tp.planned_dense if fn == "dense" else tp.planned_bmm
    out = f(*args, site=site, **kw)
    return out.float().numpy() if out.dtype == torch.bfloat16 \
        else out.numpy()


def _run_both(calls, seed=0):
    for i, (fn, site, shapes, dtypes, kw) in enumerate(calls):
        arrays = _operands(shapes, dtypes, seed + i)
        want = _run_jax(fn, site, arrays, dtypes, kw)
        got = _run_torch(fn, site, arrays, dtypes, kw)
        assert got.shape == want.shape and got.dtype == want.dtype, site
        if got.dtype.kind == "i":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                       atol=1e-3)


@pytest.fixture
def both_facades():
    """Both facades on the modelled policy with empty reports (each
    package's default, ``cached``, reads its own crossover table)."""
    tp.reset_configuration()
    tp.planned_report_clear()
    jp.planned_report_clear()
    with jp.override(policy=JaxPolicy(mode="modelled")), \
            tp.override(policy=tp.PlanPolicy(mode="modelled")):
        yield
    tp.reset_configuration()


def test_sites_decide_and_record_like_the_reference(both_facades):
    _run_both(CALLS)
    with jp.override(enabled=False), tp.override(enabled=False):
        _run_both(CALLS[:1] + CALLS[3:4])
    assert tp.planned_report() == jp.planned_report()
    report = tp.planned_report()
    assert report["t.mixed"]["reasons"] == {"dtype:float32xint8": 1}
    assert report["t.half"]["reasons"] == {"dtype:float16xfloat16": 1}
    assert report["t.tiny"]["reasons"] == {"infeasible": 1}
    assert report["t.dense"]["reasons"] == {"disabled": 1}
    assert report["t.dense"]["planned"] == 2
    assert report["t.bmm"]["backends"] == {"pallas": 1}


def test_report_delta_matches_reference(both_facades):
    _run_both(CALLS[:3])
    before_t, before_j = tp.planned_report(), jp.planned_report()
    _run_both(CALLS[:2] + CALLS[6:8])
    delta = tp.report_delta(before_t, tp.planned_report())
    assert delta == jp.report_delta(before_j, jp.planned_report())
    assert set(delta) == {"t.dense", "t.mixed", "t.half"}
    assert delta["t.dense"]["planned"] == 2


def test_observed_requests_match_reference(both_facades):
    tp.observed_clear()
    jp.observed_clear()
    _run_both(CALLS)
    assert tp.observed_requests() == jp.observed_requests()


def test_override_restores_previous_configuration():
    tp.reset_configuration()
    default = tp.current_config()
    assert default.enabled and default.policy == tp.DEFAULT_POLICY
    assert tp.DEFAULT_POLICY.mode == "cached"
    with tp.override(enabled=False) as cfg:
        assert not cfg.enabled and not tp.planned_enabled()
    assert tp.current_config() == default
    tp.configure(enabled=False)
    with tp.override(enabled=True):
        assert tp.planned_enabled()
    assert not tp.planned_enabled()
    tp.reset_configuration()
    assert tp.planned_enabled()


def test_supported_dtypes_and_target_match_reference():
    assert tp.SUPPORTED_DTYPES == jp.SUPPORTED_DTYPES
    assert tp.PLANNED_TARGET.mesh_shape == jp.PLANNED_TARGET.mesh_shape


def test_planned_dense_reads_a_transposed_weight_without_copy():
    x = torch.randn(4, 16)
    table = torch.randn(40, 16)  # a tied head reads the embedding as [d, V]
    out = tp.planned_dense(x, table.t(), site="t.tied")
    torch.testing.assert_close(out, x @ table.t())
    assert tp.planned_report()["t.tied"]["planned"] == 1


@pytest.mark.parametrize("fn,shapes,dtypes", [
    ("dense", ((8, 16), (16, 8)), (torch.float32, torch.int8)),
    ("dense", ((8, 16), (16, 8)), (torch.float16, torch.float16)),
    ("dense", ((1, 1), (1, 1)), (torch.float32, torch.float32)),
    ("bmm", ((0, 3, 4), (0, 4, 5)), (torch.float32, torch.float32)),
], ids=["mixed", "unsupported", "infeasible-mm", "infeasible-bmm"])
def test_unplanned_calls_off_the_cpu_raise(fn, shapes, dtypes):
    """Tensors off the CPU never reach the plain version unless planning
    is disabled; meta tensors stand in for card tensors here."""
    tp.reset_configuration()
    a, b = (torch.empty(s, dtype=d, device="meta")
            for s, d in zip(shapes, dtypes))
    f = tp.planned_dense if fn == "dense" else tp.planned_bmm
    with pytest.raises(RuntimeError, match="no hand-kernel plan"):
        f(a, b, site="t.offcpu")
    if dtypes[0] == dtypes[1]:
        with tp.override(enabled=False):
            assert f(a, b, site="t.offcpu").shape[-1] == shapes[1][-1]


@pytest.mark.gpu
def test_unplanned_card_call_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels run only there")
    tp.reset_configuration()
    x = torch.ones((1, 1), device="cuda")
    with pytest.raises(RuntimeError, match="infeasible"):
        tp.planned_dense(x, x, site="t.card")
    with tp.override(enabled=False):
        torch.testing.assert_close(tp.planned_dense(x, x, site="t.card"),
                                   x)
