"""The trace's reduction on a synthetic Chrome trace: busy time as the
union of device records, idle gaps labelled by the host phase, GEMM
records and launch calls counted inside the sub-window only."""

import pytest

import tiny
from trace import kernel_name, summarize


def _x(name, ts, dur, cat, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "args": args}


def test_summarize():
    ev = [
        _x("bench.window", 1000, 1000, "user_annotation"),
        _x("bench.decode-only step", 1000, 500, "user_annotation"),
        _x("bench.admit+step", 1500, 500, "user_annotation"),
        _x("void (anonymous namespace)::skinny_kernel<__nv_bfloat16>(int)",
           1100, 100, "kernel"),
        _x("void (anonymous namespace)::skinny_kernel<__nv_bfloat16>(int)",
           1150, 100, "kernel"),            # overlaps: busy 1100-1250
        _x("Memcpy HtoD", 1300, 50, "gpu_memcpy"),
        _x("gemm_tc_kernel<128>(float)", 1600, 200, "kernel"),
        _x("elementwise_kernel<4>(x)", 1900, 50, "kernel"),
        _x("gemm_tc_kernel<128>(float)", 2100, 200, "kernel"),   # outside
        _x("cudaLaunchKernel", 1090, 5, "cuda_runtime"),
        _x("cudaGraphLaunch", 1590, 5, "cuda_runtime"),
        _x("cudaLaunchKernel", 2090, 5, "cuda_runtime"),         # outside
    ]
    s = summarize(ev)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx((150 + 50 + 200 + 50) / 1e6)
    assert s["gemm_records"] == 3
    assert s["gemm_s"] == pytest.approx(400 / 1e6)
    assert s["launch_calls"] == 2 and s["graph_launches"] == 1
    gaps = sorted((round(g * 1e6), name) for name, g in s["idle_gaps"])
    assert gaps == [(50, "admit+step"), (50, "decode-only step"),
                    (100, "admit+step"), (100, "decode-only step"),
                    (250, "decode-only step")]
    assert s["device_ops"][0] == ["skinny_kernel", pytest.approx(200 / 1e6)]


def test_kernel_names():
    assert kernel_name("void (anonymous namespace)::skinny_kernel<float>(x)") \
        == "skinny_kernel"
    assert kernel_name("Memcpy HtoD (Pageable -> Device)")[:6] == "Memcpy"


@pytest.mark.parametrize("name", ["olmoe-chat", "stablelm-batch",
                                  "olmoe-train"])
def test_traced_run_profiles_after_the_window(name):
    """A traced run's sub-window opens once the measured window has
    closed, so the profiler's start and stop hold up none of the steps
    the host-clock readings cover; the run ends and reads its metrics."""
    import torch

    import run

    cell = tiny.tiny_cell(name)
    ctx = run.Context(torch, cell, 9, 1.0, True, device="cpu")
    rec = run.measure(ctx)
    w0, w1 = rec["window"]
    assert rec["trace"]["start_s"] >= w1
    assert rec["trace"]["window_s"] > 0
    if rec["kind"] == "serve":
        assert rec["steps"] and all(w0 <= s[0] < w1 for s in rec["steps"])
        assert rec["trace"]["phase_count"]["generator"] >= 1
    else:
        assert rec["trace"]["phase_count"]["train step"] == 1
    out = run.result(ctx, rec, {"platform": "cpu"})
    assert out["correct"]
    assert "mfu.chat" in out["metrics"] or "mfu.batch" in out["metrics"] \
        or "mfu.train" in out["metrics"]


def test_lost_records_are_seen():
    """A launch call whose device record is missing is counted, and a
    sub-window with fewer GEMM records than its shapes call for is not
    complete."""
    from trace import complete, shortfall

    ev = [
        _x("bench.window", 0, 1000, "user_annotation"),
        _x("cudaLaunchKernel", 10, 5, "cuda_runtime", correlation=1),
        _x("cudaLaunchKernel", 20, 5, "cuda_runtime", correlation=2),
        _x("cudaGraphLaunch", 30, 5, "cuda_runtime", correlation=3),
        _x("skinny_kernel<float>(x)", 100, 50, "kernel", correlation=1),
        _x("gemm_tc_kernel<128>(x)", 200, 50, "kernel", correlation=3),
        _x("skinny_kernel<float>(x)", 300, 50, "kernel", correlation=3),
    ]
    s = summarize(ev)
    assert s["lost_launches"] == 1
    assert s["gemm_by_kernel"] == {"skinny_kernel": 2, "gemm_tc_kernel": 1}
    s["gemm"] = {"launches": 4, "bound_s": 1e-6}
    assert not complete(s)
    assert shortfall(s)["launches_without_records"] == 1
    s["gemm"]["launches"] = 3
    assert complete(s) and not complete({})


@pytest.mark.parametrize("name", ["olmoe-chat", "stablelm-batch",
                                  "olmoe-train"])
def test_incomplete_sub_window_is_traced_again(name, monkeypatch):
    """A sub-window whose trace lost records is not read: the next one is
    traced in its place, and the run reads that."""
    import torch

    import run
    import trace

    seen = []

    def complete(t):
        seen.append(t["tries"])
        return len(seen) > 1

    monkeypatch.setattr(trace, "tries", lambda device: trace.TRACE_TRIES)
    monkeypatch.setattr(trace, "complete", complete)
    ctx = run.Context(torch, tiny.tiny_cell(name), 9, 1.0, True,
                      device="cpu")
    rec = run.measure(ctx)
    assert seen == [1, 2]
    assert rec["trace"]["tries"] == 2
    assert rec["trace"]["start_s"] >= rec["window"][1]
