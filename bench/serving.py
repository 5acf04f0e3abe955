"""The serving cells' loop over the port's paged engine
(``serve.api.make_engine(cfg, "paged", ...)``: ``submit`` and ``step``).

Set-up makes the weights from the seed, loads the engine (which captures
its decode step), and warms every prompt length the traffic sends and a
few decode steps.  Then the host loop submits what is due and calls
``step()`` while there is work, recording when each request was due,
when ``step()`` handed back its first and its last token, and what each
step did.  ``open`` traffic arrives on its schedule after a lead-in;
``batch`` traffic is a backlog fed to the engine so that its queue never
runs dry.  A traced run profiles the ``trace_steps`` steps that follow
the window's close, from its first admitting step, so that the
profiler's start and its stop (seconds, with thousands of records) fall
outside the window the host-clock readings cover; a sub-window whose
trace lost GEMM records (``trace.complete``) is traced again from the
next admitting step, up to ``trace.TRACE_TRIES`` times.  Then a sample of the
requests finished in the window is handed to the check
(``check.served``).
"""

from __future__ import annotations

import collections
import json
import time

import numpy as np

import check
import traffic as T
import weights as W
import yardstick as Y
from stats import percentile
import trace as TR


def setup(ctx) -> dict:
    """Weights, the engine loaded and warmed; returns the run's state."""
    torch = ctx.torch
    from repro_torch.serve import make_engine

    from harness import port_config

    conf, tr = ctx.cell["config"], ctx.cell["traffic"]
    cfg = port_config(conf)
    params = W.make(torch, conf["port"], ctx.seed, ctx.device)
    e = tr["engine"]
    eng = make_engine(cfg, e["kind"], max_lanes=e["max_lanes"],
                      max_seq=e["max_seq"], block_size=e["block_size"],
                      device=ctx.device)
    eng.load(params)
    # every prompt length the traffic sends: one prefill each (a request
    # of one token finishes at admission), then a few decode steps
    for n in T.prompt_lengths(tr):
        eng.submit(np.zeros(n, np.int32), 1)
    eng.run_until_drained()
    for _ in range(e["max_lanes"]):
        eng.submit(np.zeros(min(T.prompt_lengths(tr)), np.int32), 3)
    eng.run_until_drained()
    eng.finished.clear()
    ctx.sync()
    ctx.steady()
    return {"eng": eng, "params": params, "cfg": cfg, "conf": conf,
            "traffic": tr}


def run(ctx, mode: str) -> dict:
    torch = ctx.torch
    from repro_torch.core import autotune
    from repro_torch.kernels import planned

    st = setup(ctx)
    eng, tr, conf = st["eng"], st["traffic"], st["conf"]
    pc = conf["port"]
    lanes = tr["engine"]["max_lanes"]
    tracer = TR.Tracer(torch, ctx.device)
    tune0 = None
    seconds = ctx.seconds
    if mode == "open":
        n = int((tr["lead_in_s"] + seconds) * tr["rate_per_s"] * 1.5) + tr["block"]
        lead = tr["lead_in_s"]
    else:
        n = tr["block"] * 64
        lead = None
    reqs = collections.deque(T.requests(tr, ctx.seed, pc["vocab"], n))
    recs, live, steps = [], {}, []
    feed = 2 * lanes  # batch: requests kept queued in the engine
    t_origin = time.perf_counter()

    def now():
        return time.perf_counter() - t_origin

    def submit(r, t):
        eng.submit(r.prompt, r.max_new)
        rec = {"due": r.due if mode == "open" else t, "submitted": t,
               "prompt": len(r.prompt), "max_new": r.max_new, "n": 0,
               "first": None, "last": None, "done": None, "req": r}
        live[id(eng.queue[-1])] = (eng.queue[-1], rec)
        recs.append(rec)

    window = None
    traced_steps = 0
    trace, tries = None, 0  # the traced sub-window kept, and those taken
    max_tries = TR.tries(ctx.device)
    decode_gemms = Y.decode_gemms(pc, lanes, tr["engine"]["max_seq"])

    def read_trace():
        """Stop the profiler and read its sub-window, with the GEMMs that
        it ran by the shapes' count."""
        tracer.stop()
        t = tracer.read()
        if t:
            t["start_s"] = trace_start
            t["tries"] = tries + 1
            t["gemm"] = gemm_work(
                pc, planned.report_delta(report0, planned.planned_report()),
                t["graph_launches"], decode_gemms, lanes)
        return t

    closed = None  # when the loop saw the window's end
    while True:
        t = now()
        if closed is None and window is not None and t >= window[1]:
            closed = t
            misses = autotune.counters()
        if closed is not None and (not ctx.trace or trace is not None):
            break
        if window is None and mode == "open" and t >= lead:
            window = [lead, lead + seconds]
        if window is None and mode == "batch" and (
                sum(r["done"] is not None for r in recs) >= lanes
                or t >= tr["lead_in_max_s"]):
            window = [t, t + seconds]
        if window is not None and tune0 is None:
            tune0 = autotune.counters()
        with tracer.phase("generator"):
            if mode == "open":
                while reqs and reqs[0].due <= t:
                    submit(reqs.popleft(), t)
            else:
                while reqs and len(eng.queue) < feed:
                    submit(reqs.popleft(), t)
        busy = eng.queue or any(r is not None for r in eng.lanes)
        if not busy:
            if closed is not None and not reqs:
                break  # nothing left to trace
            nxt = reqs[0].due if reqs else t + 0.001
            stop = nxt if closed is not None else (
                window[1] if window else lead)
            time.sleep(max(0.0, min(nxt, stop) - now()))
            continue
        admit = bool(eng.queue) and any(r is None for r in eng.lanes)
        if (ctx.trace and closed is not None and not tracer.active
                and trace is None and admit):
            report0 = planned.planned_report()
            trace_start = now()
            tracer.start()
        s0 = now()
        d0 = eng.stats["steps"]
        with tracer.phase("admit+step" if admit else "decode-only step"):
            eng.step()
        s1 = now()
        if tracer.active:
            traced_steps += 1
            if traced_steps == tr["trace_steps"]:
                t = read_trace()
                tries += 1
                traced_steps = 0
                if TR.complete(t) or tries == max_tries:
                    trace = t
                else:
                    ctx.note(json.dumps(
                        {"trace_incomplete": TR.shortfall(t)}))
        admitted = admitted_tokens = decoded = 0
        flops = 0.0
        for key in list(live):
            ereq, rec = live[key]
            got = len(ereq.output)
            if ctx.fault == "token" and got > rec["n"] and rec["n"] > 0:
                ereq.output[-1] = (ereq.output[-1] + 1) % pc["vocab"]
            if got > rec["n"]:
                new = got - rec["n"]
                if rec["n"] == 0:
                    admitted += 1
                    admitted_tokens += rec["prompt"]
                    flops += Y.prefill_flops(pc, rec["prompt"], head_rows=1)
                    rec["first"] = s1
                    new -= 1
                ctx_len = rec["prompt"] + got - new
                for j in range(new):
                    flops += Y.decode_flops(pc, ctx_len + j)
                decoded += new
                rec["n"] = got
                rec["last"] = s1
            if ereq.done:
                rec["done"] = s1
                rec["tokens"] = list(ereq.output)
                del live[key]
        steps.append([s0, s1, admitted, admitted_tokens, decoded,
                      eng.stats["steps"] > d0, flops])
    if tracer.active:
        trace = read_trace()
    ctx.sync()
    if mode == "batch":
        window[1] = closed
    rec = {
        "kind": "serve", "mode": mode, "lanes": lanes,
        "max_seq": tr["engine"]["max_seq"], "config": pc,
        "window": window,
        "setup_s": ctx.setup_end(t_origin + window[0]),
        "steps": [s for s in steps if window[0] <= s[0] < window[1]],
        "requests": [{k: v for k, v in r.items() if k != "req"}
                     for r in recs],
        "plan_misses": sum(misses[k] - tune0[k]
                           for k in ("misses", "measure_calls")),
        "attempted": sum(window[0] <= r["due"] < window[1] for r in recs)
        if mode == "open" else sum(r["first"] is not None
                                   and window[0] <= r["first"] <= window[1]
                                   for r in recs),
        "failed": 0,
        "memory_peak_bytes": ctx.memory_peak(),
    }
    # requests due in the window: a traced run's profiler holds the host
    # after the close, while the rest of the schedule waits
    late = [r["submitted"] - r["due"] for r in recs
            if window[0] <= r["due"] < window[1]] if mode == "open" else []
    ttft = ttft_waits(recs, window)
    rec["notes"] = {"sent": len(recs),
                    "done": sum(r["done"] is not None for r in recs),
                    "generator_late_ms_max": max(late, default=0.0) * 1e3,
                    "ttft_ms_p50_p90_p95": [
                        (percentile(ttft, q) or 0.0) * 1e3
                        for q in (50, 90, 95)] if mode == "open" else None}
    rec["trace"] = trace or {}
    done = [r for r in recs if r["done"] is not None
            and r["done"] <= window[1]]
    sample = check.sample_requests(done, ctx.seed, tr["check"])
    seqs = [(r["req"].prompt, r["tokens"]) for r in sample]
    params = st.pop("params")
    # the program's state goes before the reference runs: the engine (its
    # pools and captured graph) and everything that holds it
    del eng, st, submit, live
    ctx.release()
    rec["checks"] = check.served(ctx, params, pc, seqs, ctx.cell["limits"])
    if ctx.control:
        rec["control"] = check.control_gap(ctx, params, pc, seqs)
    return rec


def ttft_waits(recs: list, window) -> list[float]:
    """Time to first token of every request due in ``window``, from when
    it was due to the ``step()`` return that handed back its first token;
    one without a token at the window's end counts the time it waited."""
    w0, w1 = window
    return [(r["first"] if r["first"] is not None and r["first"] <= w1
             else w1) - r["due"] for r in recs if w0 <= r["due"] < w1]


def gemm_work(cfg, report: dict, replays: int, step_gemms,
              lanes: int) -> dict:
    """The GEMMs a traced sub-window ran: the eager ones from the facade's
    shape records over the sub-window, and ``replays`` times each GEMM of
    the captured decode step over ``lanes`` rows; their count and their
    least time at the card's peaks (``yardstick.bound_s``: an expert's
    from the rows routed to it)."""
    launches, bound = Y.report_work(report, cfg)
    launches += replays * len(step_gemms)
    bound += replays * sum(Y.bound_s(s, d, cfg, lanes) for s, d in step_gemms)
    return {"launches": launches, "bound_s": bound}
