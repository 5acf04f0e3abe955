"""The metric readers on synthetic run records."""

import pytest

import tiny  # noqa: F401
import harness
from stats import percentile


def read(name, rec):
    return harness.reader(name).read(rec)


def _req(due, first, n, done=None, last=None):
    return {"due": due, "first": first, "n": n, "done": done,
            "last": last if last is not None else first, "prompt": 10}


def test_percentile_interpolates():
    assert percentile([1, 2, 3, 4, 5], 50) == 3
    assert percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert percentile([], 95) is None


def test_ttft_counts_every_due_request_and_the_unanswered():
    import serving

    # 20 requests due in [10, 30): 19 answered 0.1 s after due, one never
    reqs = [_req(10 + i, 10 + i + 0.1, 5) for i in range(19)]
    reqs.append(_req(29.5, None, 0))
    reqs.append(_req(5.0, 5.2, 5))        # due in the lead-in: not counted
    reqs.append(_req(31.0, None, 0))      # due after the window: not counted
    reqs.append(_req(29.0, 30.5, 1))      # answered after the window's end
    waits = serving.ttft_waits(reqs, (10.0, 30.0))
    assert sorted(waits) == pytest.approx(sorted([0.1] * 19 + [0.5, 1.0]))
    assert percentile(waits, 95) == pytest.approx(0.5)
    rec = {"kind": "serve", "mode": "open", "window": [10.0, 30.0],
           "requests": reqs}
    assert read("ttft_p95_ms.chat", rec) == pytest.approx(500.0)
    assert read("ttft_p95_ms.chat", dict(rec, mode="batch")) is None


def test_tpot_over_requests_finished_in_window():
    reqs = [_req(0, 11.0, 11, done=12.0, last=12.0),   # 0.1 s a token
            _req(0, 11.0, 3, done=40.0, last=40.0),    # finished after
            _req(0, 11.0, 5, done=None)]
    rec = {"kind": "serve", "mode": "open", "window": [10.0, 30.0],
           "requests": reqs}
    assert read("tpot_p95_ms", rec) == pytest.approx(100.0)


def _steps():
    # [t0, t1, admitted, admitted tokens, decode tokens, decoded, flops]
    return [[0.0, 0.2, 2, 1000, 16, True, 1e12],
            [0.2, 0.25, 0, 0, 16, True, 1e11],
            [0.25, 0.3, 0, 0, 14, True, 1e11],
            [0.3, 0.45, 1, 500, 15, True, 1e12]]


def test_step_readers():
    rec = {"kind": "serve", "mode": "batch", "steps": _steps()}
    assert read("tok_s", rec) == pytest.approx((1500 + 3 + 61) / 0.45)
    assert read("lanes_busy.batch", rec) == pytest.approx(61 / 4)
    assert read("decode_step_ms.batch", rec) == pytest.approx(50.0)
    # (0.2 - 0.05) + (0.15 - 0.05) s over 1.5 ktok
    assert read("prefill_ms_per_ktok.batch", rec) == pytest.approx(
        250 / 1.5)
    assert read("mfu.batch", rec) == pytest.approx(
        2.2e12 / (0.45 * 989e12) * 100)


def test_train_and_trace_readers():
    rec = {"kind": "train", "window": [0.0, 10.0], "steps": 20,
           "step_flops": 1e14, "setup_s": 12.5,
           "trace": {"window_s": 0.5, "busy_s": 0.4, "gemm_s": 0.2,
                     "gemm_records": 100, "launch_calls": 3000, "steps": 1,
                     "gemm": {"launches": 100, "bound_s": 0.05}}}
    assert read("step_ms", rec) == pytest.approx(500.0)
    assert read("setup_s", rec) == 12.5
    assert read("mfu.train", rec) == pytest.approx(2e15 / (10 * 989e12) * 100)
    assert read("launches_per_step.train", rec) == 3000
    assert read("idle_share.train", rec) == pytest.approx(20.0)
    assert read("gemm_roofline.train", rec) == pytest.approx(25.0)
    lost = dict(rec, trace=dict(rec["trace"], gemm_records=99))
    assert read("gemm_roofline.train", lost) is None
    assert read("tok_s", rec) is None
