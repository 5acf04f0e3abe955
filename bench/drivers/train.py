"""Training: one object holds the port's train step
(``train.step.make_train_step``) with its model and optimizer state.
Set-up makes it, drives it from the seed through the checked steps (the
window's own call and feed, on rows that all differ), reads the program's
numbers from its state, and hands the same object to the window.  The
window runs whole steps for ``--seconds``, and a traced run profiles one
step more after it (another in its place, up to ``trace.TRACE_TRIES``,
while the trace lost GEMM records); the reference follows the checked steps once the
window has closed and the program's state is freed."""

from __future__ import annotations

import json
import time

import check
import traffic as T
import weights as W
import yardstick as Y
import trace as TR


class TrainRun:
    """The train step and its state, as a trainer holds them."""

    def __init__(self, ctx, conf: dict, tr: dict):
        torch = ctx.torch
        from repro_torch.models import build_model
        from repro_torch.optim import adamw_init
        from repro_torch.train.loop import TrainConfig
        from repro_torch.train.step import make_train_step

        from harness import port_config

        self.ctx, self.tr, self.pc = ctx, tr, conf["port"]
        cfg = port_config(conf)
        opt = tr["optimizer"]
        self.params = W.make(torch, self.pc, ctx.seed, ctx.device)
        self.opt_state = adamw_init(self.params)
        self.fn = make_train_step(build_model(cfg, ctx.device), cfg, tcfg=TrainConfig(
            base_lr=opt["base_lr"], warmup=opt["warmup"],
            total_steps=opt["total_steps"], weight_decay=opt["weight_decay"],
            clip_norm=opt["clip_norm"]))
        self.step = 0

    def batch(self, step: int) -> dict:
        torch, ctx = self.ctx.torch, self.ctx
        b = T.train_batch(self.tr, ctx.seed, step, self.pc["vocab"])
        if ctx.fault == "half":
            b = {k: v[: len(v) // 2] for k, v in b.items()}
        return {k: torch.from_numpy(v).to(ctx.device) for k, v in b.items()}

    def __call__(self):
        """One optimizer update on the next batch; returns its metrics."""
        params, opt_state, metrics = self.fn(self.params, self.opt_state,
                                             self.batch(self.step), self.step)
        if self.ctx.fault != "unchanged":
            self.params, self.opt_state = params, opt_state
        self.step += 1
        return metrics


def run(ctx) -> dict:
    torch = ctx.torch
    from repro_torch.kernels import planned
    from repro_torch.tree import leaves, paths

    conf, tr = ctx.cell["config"], ctx.cell["traffic"]
    pc, opt = conf["port"], tr["optimizer"]
    run_ = TrainRun(ctx, conf, tr)
    names = paths(run_.params)
    # the checked steps, which also warm every shape up
    prog = {"loss": []}
    for i in range(tr["check_steps"]):
        prog["loss"].append(float(run_()["loss"]))
        if i == 0:
            prog["grad"] = {k: float(m.norm()) / (1 - opt["b1"]) for k, m in
                            zip(names, leaves(run_.opt_state.m))}
    prog["change"] = {
        k: float((p.float() - W.leaf(torch, pc, ctx.seed, k, ctx.device)
                  .float()).norm())
        for k, p in zip(names, leaves(run_.params))}
    tracer = TR.Tracer(torch, ctx.device)
    ctx.sync()
    ctx.steady()
    t0 = time.perf_counter()
    setup_s = ctx.setup_end(t0)
    n = 0
    while True:
        run_()
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    t1 = time.perf_counter()
    trace = {}
    for tries in range(TR.tries(ctx.device) if ctx.trace else 0):
        # one more update, traced after the window: the profiler's start
        # and stop take seconds, which the window's steps must not hold;
        # traced again while the trace lost GEMM records
        if trace:
            ctx.note(json.dumps(
                {"trace_incomplete": TR.shortfall(trace)}))
        report0 = planned.planned_report()
        trace_start = time.perf_counter() - t0
        tracer.start()
        with tracer.phase("train step"):
            run_()
        tracer.stop()
        report = planned.report_delta(report0, planned.planned_report())
        trace = tracer.read()
        if trace:
            launches, bound = Y.report_work(report, pc,
                                            tr["batch"] * tr["seq"])
            trace.update(gemm={"launches": launches, "bound_s": bound},
                         steps=1, start_s=trace_start, tries=tries + 1)
        if TR.complete(trace):
            break
    rec = {"kind": "train", "config": pc, "traffic": tr, "steps": n,
           "window": [0.0, t1 - t0], "setup_s": setup_s,
           "step_flops": 3 * tr["batch"] * Y.prefill_flops(pc, tr["seq"]),
           "attempted": n, "failed": 0,
           "memory_peak_bytes": ctx.memory_peak()}
    rec["trace"] = trace
    del run_
    ctx.release()
    rec["checks"] = _check(ctx, pc, tr, names, prog)
    return rec


def _check(ctx, pc, tr, names, prog) -> list[dict]:
    """The reference follows the checked steps from the same starting
    weights and batches."""
    from reference import decoder as D
    from reference import train as R

    torch = ctx.torch
    D.strict_fp32()
    if ctx.device != "cpu":
        ctx.note(f"reference starts with "
                 f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    batches = [{k: torch.from_numpy(v).to(ctx.device) for k, v in
                T.train_batch(tr, ctx.seed, s, pc["vocab"]).items()}
               for s in range(tr["check_steps"])]
    cap = None
    if pc.get("moe_num_experts"):
        def cap(t):
            return Y.capacity(pc, t)
    t_ref = time.perf_counter()
    loss, grad, change = R.steps(
        names, lambda k: W.leaf(torch, pc, ctx.seed, k, ctx.device), pc,
        batches, tr["optimizer"], capacity=cap)
    ref = {"loss": loss, "grad": grad, "change": change}
    ctx.note(f"reference: {time.perf_counter() - t_ref:.1f} s")
    ctx.result_extra["readings"] = {"program": prog, "reference": ref}
    if ctx.control:
        low = dict(zip(("loss", "grad", "change"), R.steps(
            names, lambda k: W.leaf(torch, pc, ctx.seed, k, ctx.device), pc,
            batches, tr["optimizer"], precision="fp8", capacity=cap)))
        ctx.result_extra["control"] = {
            c["name"]: c["value"]
            for c in check.trained(low, ref, ctx.cell["limits"])}
        ctx.result_extra["readings"]["control"] = low
    return check.trained(prog, ref, ctx.cell["limits"])
