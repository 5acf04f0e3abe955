"""A short traced sub-window of a run, read from ``torch.profiler``'s
trace: the device's busy time, its idle gaps by what the host loop was
doing, the top device operations, the GEMM kernels' launches and device
time, and the host's kernel launches.

The host loop marks what it does with ``phase(name)``
(``record_function`` ranges named ``bench.<name>``); a device gap is
labelled by the phase running on the host when it began.  The trace is
written under the checkout's ``build/`` and deleted once read.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
from collections import Counter

from harness import ROOT

#: the port's GEMM kernels, by the function name in a device record
GEMM_KERNELS = ("skinny_kernel", "gemm_tc_kernel", "gemm_tc_int_kernel",
                "gemm_kernel")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: traced sub-windows a run takes at most: one whose trace holds another
#: number of GEMM records than its shapes call for lost records, and the
#: next is traced in its place
TRACE_TRIES = 3


def tries(device: str) -> int:
    """Sub-windows a run may trace on ``device``: one on the CPU, where
    no device records are made to lose."""
    return TRACE_TRIES if device != "cpu" else 1


def complete(t: dict) -> bool:
    """Whether a traced sub-window holds every GEMM record: as many as
    the shapes it ran call for (``t["gemm"]["launches"]``)."""
    return bool(t) and t["gemm_records"] == t["gemm"]["launches"]


def shortfall(t: dict) -> dict:
    """What a sub-window that is not ``complete`` holds, for the run's
    notes: GEMM records by kernel against the shapes' count, and the
    launch calls whose device records are missing."""
    return {"gemm_records": t.get("gemm_records"),
            "shapes": t.get("gemm", {}).get("launches"),
            "gemm_by_kernel": t.get("gemm_by_kernel"),
            "graph_launches": t.get("graph_launches"),
            "launch_calls": t.get("launch_calls"),
            "launches_without_records": t.get("lost_launches")}


def kernel_name(name: str) -> str:
    """A device record's function name without its template and
    arguments (``skinny_kernel``), or its first 60 characters."""
    m = re.search(r"(\w+)[<(]", name)
    return m.group(1) if m else name[:60]


class Tracer:
    """``start()`` and ``stop()`` bound the traced sub-window (``stop``
    only ends the profiler; ``read()``, called once the measured window
    has closed, exports and reads the trace); ``phase(name)`` marks a host
    phase, a no-op while nothing is traced."""

    def __init__(self, torch, device: str = "cuda"):
        self.torch = torch
        self.cuda = device != "cpu"
        self.prof = None
        self._done = None
        self._stack = None

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.prof is None:
            yield
            return
        with self.torch.profiler.record_function(f"bench.{name}"):
            yield

    @property
    def active(self) -> bool:
        return self.prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            self.torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._stack = contextlib.ExitStack()
        self.prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(
            self.torch.profiler.record_function("bench.window"))

    def stop(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()
        prof, self._done, self.prof = self.prof, self.prof, None
        self._stack.close()
        del prof

    def read(self) -> dict:
        """The sub-window's summary (``summarize``); {} if none was
        traced."""
        if self._done is None:
            return {}
        path = ROOT / "build" / f"bench_trace_{os.getpid()}.json"
        path.parent.mkdir(exist_ok=True)
        try:
            self._done.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        finally:
            path.unlink(missing_ok=True)
        self._done = None
        return summarize(events)


def summarize(events: list) -> dict:
    """What the readers need from one traced sub-window."""
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X" and e.get("name", "").startswith("bench.")]
    win = [e for e in marks if e["name"] == "bench.window"]
    if not win:
        return {}
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e)
                 for e in events if e.get("cat") in DEVICE_CATS
                 and e.get("ph") == "X" and w0 <= e["ts"] < w1)
    busy, cur_s, cur_e, gaps = 0.0, None, None, []
    prev_end = w0
    for s, e, _ in dev:
        if s > prev_end:
            gaps.append((prev_end, s))
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1 > prev_end:
        gaps.append((prev_end, w1))
    phases = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("bench."):])
                    for e in marks if e["name"] != "bench.window")

    def label(t):
        for s, e, name in phases:
            if s <= t < e:
                return name
        return "harness"

    gaps.sort(key=lambda g: g[0] - g[1])
    ops, gemm_by_kernel = Counter(), Counter()
    gemm_us, gemm_n = 0.0, 0
    for s, e, ev in dev:
        if ev.get("cat") != "kernel":
            ops[ev.get("cat")] += e - s
            continue
        name = kernel_name(ev["name"])
        ops[name] += e - s
        if name in GEMM_KERNELS:
            gemm_us += e - s
            gemm_n += 1
            gemm_by_kernel[name] += 1
    runtime = [e for e in events if e.get("ph") == "X"
               and w0 <= e.get("ts", -1) < w1
               and e.get("name") in LAUNCH_CALLS]
    recorded = {ev.get("args", {}).get("correlation") for _, _, ev in dev}
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy / 1e6,
        "gemm_s": gemm_us / 1e6,
        "gemm_records": gemm_n,
        "gemm_by_kernel": dict(gemm_by_kernel),
        "graph_launches": sum(e["name"] == "cudaGraphLaunch"
                              for e in runtime),
        "launch_calls": len(runtime),
        "lost_launches": sum(e.get("args", {}).get("correlation")
                             not in recorded for e in runtime),
        "device_ops": [[k, v / 1e6] for k, v in ops.most_common(10)],
        "idle_gaps": [[label(s), (e - s) / 1e6] for s, e in gaps[:10]],
        "phase_count": Counter(name for _, _, name in phases),
    }
