"""Planned-execution facade: model GEMMs and the audio frontend routed
through the mapper.

The port of ``repro.kernels.planned``.  ``planned_dense(x, w)`` and
``planned_bmm(a, b)`` normalize call-site shapes onto the registered
``mm``/``bmm`` recurrences, resolve one ``PlanRequest`` per shape through
the copied planner, and run the plan (``runtime.execute_plan``: the
hand-written Hopper kernel for the mapper's ``pallas`` stamp).
``planned_fir``/``planned_conv2d`` do the same for the frontend's filter
bank and feature extractor.  ``planned_fft2d`` and ``planned_mlp_pair``
resolve a two-stage chain (``fft2d_stage+fft2d_stage``, ``mm+mm``) to a
``FusedPlan`` whose backend is the reference's default ``xla``: they run
the plain versions (``torch.fft.fft2``; ``torch.matmul`` in fp32 with the
bias and gelu between), which is the plan's own stamp, not a fallback.

A planned mm, bmm or MLP pair runs inside a ``torch.autograd.Function``
(``_MMPlanned``, ``_BMMPlanned``, ``_MLPPairPlanned``: the reference's
three ``jax.custom_vjp``s), on every device, whose backward plans its
GEMMs through the same dispatch at the sites ``<site>/bwd_dx`` and
``/bwd_dw`` (mm), ``/bwd_da`` and ``/bwd_db`` (bmm, the cotangent cast to
the operands' dtypes first), ``/bwd_up``, ``/bwd_dwd``, ``/bwd_dh``,
``/bwd_dwu`` and ``/bwd_dx`` (the pair, which recomputes its intermediate).
So training runs on the hand kernels in both directions.  An A operand
that is not row-major (``x^T`` of a weight gradient, ``a^T``) is copied
into rows padded to whole 16-byte units, which the tensor-core kernels
read by TMA; ``a_copies`` counts those copies.  A fallback runs the plain
version under plain autograd.  The frontend surfaces have no backward.
The target, the supported dtypes and the fallback rules are the
reference's, so both packages make the same decision with the same
reason at every call site:

  * planning disabled (``configure(enabled=False)``) -> ``"disabled"``;
  * mismatched or unsupported operand dtypes -> ``"dtype:AxB"``;
  * shapes the mapper has no feasible plan for -> ``"infeasible"``.

A fallback runs the plain PyTorch version in ``ref.py`` for tensors on
the CPU.  Off the CPU only the explicit ``"disabled"`` switch runs it: a
card tensor whose call has no plan (``dtype:…``, ``infeasible``) raises,
so neither serving nor training leaves the hand kernels unseen.

The default policy is the reference's ``PlanPolicy(mode="cached")`` over
the port's own crossover table (``core/default_autotune.json``, measured
on the H100; never the reference's).  A hit stamps the measured winner:
a plan stamped ``xla`` runs the registry's plain version with the
kernels' ``out_dtype`` contract (``runtime.execute_plan``), the plan's
stamp and not a fallback, counted under ``backends`` in
``planned_report()``.  The table's keys are the registry's smoke and
bench cases and the float32 census of the smoke configs, so a full-width
bf16 GEMM misses, stays modelled and runs its hand kernel.

``PlannedConfig.target`` may be a ``core.hierarchy.HierarchicalTarget``
(the engines' ``target=``): every facade mm and bmm then plans two-level
(an outer column, row or batch split over the inner chip) and runs the
composition of its groups on the hand kernels
(``hierarchy.lower_hierarchical``); ``last_plan`` carries the plan's
``describe()`` (``[hier mm/...] outer 1x2 split=...``).  A chain does not
compose hierarchically, so the MLP pair then runs its unfused per-stage
calls, which do.

``planned_report()`` keeps per-call-site counters.  PyTorch runs eagerly,
so a decision is counted on every call (the reference counts once per
trace; under ``torch.utils.checkpoint`` the forward sites count again in
the recompute).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch.core.autotune import PlanPolicy, PlanRequest, resolve
from repro_torch.core.mapper import ExecutionPlan, Target

from . import ref, runtime
from .runtime import execute_plan

#: Single-chip execution target for facade call sites (the reference's
#: ``PLANNED_TARGET``): the smallest geometry on which the PLIO model
#: produces feasible plans for the model-stack GEMM shapes.
PLANNED_TARGET = Target(name="planned_chip", mesh_shape=(1, 8))

#: Dtypes the mm/bmm kernel contract covers.
SUPPORTED_DTYPES = frozenset(
    {"float32", "bfloat16", "int8", "int16", "int32"})

#: Consult the port's committed crossover table, never measure at call
#: time (a miss keeps the modelled choice).
DEFAULT_POLICY = PlanPolicy(mode="cached")


# ---------------------------------------------------------------------------
# configuration: one configure() call + a scoped override
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlannedConfig:
    """The facade's configuration: ``target`` None means
    ``PLANNED_TARGET``."""

    enabled: bool = True
    policy: PlanPolicy = DEFAULT_POLICY
    target: Target | None = None


_CONFIG: PlannedConfig | None = None

#: "leave this field alone" — distinct from None, which for ``target``
#: means "back to PLANNED_TARGET".
_UNSET = object()


def configure(enabled: bool | None = None,
              policy: PlanPolicy | None = None,
              target=_UNSET) -> PlannedConfig:
    """Set the facade configuration; unspecified fields keep their
    current value.  Returns the new config."""
    global _CONFIG
    base = current_config()
    _CONFIG = PlannedConfig(
        enabled=base.enabled if enabled is None else bool(enabled),
        policy=base.policy if policy is None else policy,
        target=base.target if target is _UNSET else target,
    )
    return _CONFIG


@contextlib.contextmanager
def override(enabled: bool | None = None,
             policy: PlanPolicy | None = None,
             target=_UNSET):
    """Scoped ``configure``: restores the previous configuration
    (including "never configured") on exit."""
    global _CONFIG
    prev = _CONFIG
    try:
        yield configure(enabled=enabled, policy=policy, target=target)
    finally:
        _CONFIG = prev


def reset_configuration() -> None:
    """Back to "never configured" (defaults)."""
    global _CONFIG
    _CONFIG = None


def current_config() -> PlannedConfig:
    return _CONFIG if _CONFIG is not None else PlannedConfig()


def planned_enabled() -> bool:
    return current_config().enabled


# ---------------------------------------------------------------------------
# plan lookup
# ---------------------------------------------------------------------------

def _norm_dim(d):
    """int, or a tuple of ints for one stage of a chain request."""
    if isinstance(d, (tuple, list)):
        return tuple(int(x) for x in d)
    return int(d)


def plan_request(kind: str, shape, dtype: str,
                 target: Target | None = None,
                 policy: PlanPolicy | None = None) -> PlanRequest:
    """The one way a facade surface describes a plan lookup.  A ``+`` in
    ``kind`` names a fused chain (``mm+mm``); its shape is then a tuple
    of per-stage extent tuples."""
    cfg = current_config()
    return PlanRequest(
        kind=kind,
        shape=tuple(_norm_dim(d) for d in shape),
        dtype=str(dtype),
        target=target or cfg.target or PLANNED_TARGET,
        policy=policy or cfg.policy,
    )


def plan_for(kind: str, shape, dtype: str,
             target: Target | None = None,
             policy: PlanPolicy | None = None) -> ExecutionPlan | None:
    """Shape -> best feasible plan, or None."""
    return resolve(plan_request(kind, shape, dtype, target, policy))


# ---------------------------------------------------------------------------
# per-call-site report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SiteStats:
    """Decision counters for one facade call site."""

    planned: int = 0
    fallback: int = 0
    reasons: dict = dataclasses.field(default_factory=dict)
    backends: dict = dataclasses.field(default_factory=dict)
    autotune: dict = dataclasses.field(
        default_factory=lambda: {"hit": 0, "miss": 0})
    shapes: dict = dataclasses.field(default_factory=dict)
    last_shape: tuple = ()
    last_plan: str = ""

    def as_dict(self) -> dict:
        return {
            "planned": self.planned,
            "fallback": self.fallback,
            "reasons": dict(self.reasons),
            "backends": dict(self.backends),
            "autotune": dict(self.autotune),
            "shapes": dict(self.shapes),
            "last_shape": self.last_shape,
            "last_plan": self.last_plan,
        }


_REPORT: dict[str, SiteStats] = {}


def _record(site: str, shape, *, plan=None, reason=None):
    st = _REPORT.setdefault(site, SiteStats())
    st.last_shape = tuple(shape)
    key = str(tuple(shape))
    st.shapes[key] = st.shapes.get(key, 0) + 1
    if plan is not None:
        st.planned += 1
        st.last_plan = plan.describe()
        st.backends[plan.backend] = st.backends.get(plan.backend, 0) + 1
        bucket = "hit" if plan.provenance == "measured" else "miss"
        st.autotune[bucket] += 1
    else:
        st.fallback += 1
        st.reasons[reason] = st.reasons.get(reason, 0) + 1


def planned_report() -> dict[str, dict]:
    """Snapshot of per-site decisions."""
    return {site: st.as_dict() for site, st in sorted(_REPORT.items())}


def planned_report_clear() -> None:
    _REPORT.clear()


def report_delta(before: dict[str, dict],
                 after: dict[str, dict]) -> dict[str, dict]:
    """Difference of two ``planned_report`` snapshots, every counter
    delta'd; sites with no decisions inside the window are dropped and
    ``last_shape``/``last_plan`` keep the window-final value."""
    def sub(cur: dict, old: dict) -> dict:
        out = {k: v - old.get(k, 0) for k, v in cur.items()}
        return {k: v for k, v in out.items() if v}

    delta: dict[str, dict] = {}
    for site, st in after.items():
        prev = before.get(site, {})
        d_planned = st["planned"] - prev.get("planned", 0)
        d_fallback = st["fallback"] - prev.get("fallback", 0)
        if not (d_planned or d_fallback):
            continue
        delta[site] = dict(
            st, planned=d_planned, fallback=d_fallback,
            reasons=sub(st["reasons"], prev.get("reasons", {})),
            backends=sub(st["backends"], prev.get("backends", {})),
            autotune={k: st["autotune"][k] - prev.get("autotune", {}).get(
                k, 0) for k in st["autotune"]},
            shapes=sub(st["shapes"], prev.get("shapes", {})),
        )
    return delta


#: Every (kind, shape, dtype) the facade tried to plan this process.
_OBSERVED: set[tuple] = set()


def observed_requests() -> tuple[tuple, ...]:
    return tuple(sorted(_OBSERVED, key=repr))


def observed_clear() -> None:
    _OBSERVED.clear()


# ---------------------------------------------------------------------------
# decision + dispatch
# ---------------------------------------------------------------------------

def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the reference's dtype names."""
    return str(dtype).removeprefix("torch.")


def _decide(kind: str, shape: tuple[int, ...], a_dtype, b_dtype):
    """(plan, fallback_reason) for one GEMM call."""
    if not planned_enabled():
        return None, "disabled"
    da, db = dtype_name(a_dtype), dtype_name(b_dtype)
    if da != db or da not in SUPPORTED_DTYPES:
        return None, f"dtype:{da}x{db}"
    _OBSERVED.add((kind, tuple(shape), da))
    plan = resolve(plan_request(kind, shape, da))
    if plan is None:
        return None, "infeasible"
    return plan, None


def _fallback_allowed(t: torch.Tensor, site: str, shape, reason: str):
    """Raise unless the plain version may run this unplanned call: any
    reason on the CPU, only ``"disabled"`` on the card."""
    if t.device.type != "cpu" and reason != "disabled":
        raise RuntimeError(
            f"{site}: no hand-kernel plan for {tuple(shape)} ({reason}) on "
            f"{t.device}; the port runs the plain version there only under "
            "configure(enabled=False)")


def _execute(plan, *operands, out_dtype=None):
    """Run a plan: a ``HierarchicalPlan`` as the composition of its groups
    (only the single-device compositions run here: a chip-level stamp
    clamps to ``xla``, as in the reference), any other through
    ``runtime.execute_plan``."""
    if hasattr(plan, "outer_split"):
        from repro_torch.core import hierarchy

        backend = plan.backend if plan.backend in ("xla", "pallas") \
            else "xla"
        return hierarchy.lower_hierarchical(
            plan, backend=backend, out_dtype=out_dtype)(*operands)
    return execute_plan(plan, *operands, out_dtype=out_dtype)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """A kernel operand: row-major, (for B) the transpose of a row-major
    tensor, or rows padded to whole 16-byte units (``padded_rows``: the
    backward's cotangent over an odd N); anything else is made
    contiguous."""
    if t.is_contiguous() or t.transpose(-1, -2).is_contiguous():
        return t
    pitch = runtime.a_pitch(t)
    if pitch is not None and pitch * t.element_size() % 16 == 0:
        return t
    return t.contiguous()


#: A operands the backward passes copied into padded rows (``x^T`` of a
#: weight gradient, ``a^T`` of a bmm: not row-major; a cotangent whose rows
#: allow no 4-byte copy, the head's over 51865 bf16 logits): calls and
#: bytes
a_copies = {"calls": 0, "bytes": 0}


def padded_rows(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` cast to ``dtype`` in row-major rows padded to whole 16-byte
    units (a view of their first ``t.shape[-1]`` columns, or ``t`` itself
    where it is contiguous, of ``dtype`` and its rows are whole units):
    an A operand the tensor-core kernels address by TMA at any K."""
    k = t.shape[-1]
    unit = 16 // dtype.itemsize
    if k % unit == 0 and t.is_contiguous():
        return t.to(dtype)
    rows = torch.empty((*t.shape[:-1], -(-k // unit) * unit), dtype=dtype,
                       device=t.device)[..., :k]
    rows.copy_(t)
    return rows


def _a_rows(t: torch.Tensor, dtype: torch.dtype | None = None):
    """A backward GEMM's A operand: ``t`` itself where it is in the GEMMs'
    layout (``runtime.a_pitch``) and dtype, and TMA addresses its rows or
    they allow 4-byte copies (``runtime.tma_operand``,
    ``runtime.a_copy_bytes``); else a padded-row copy, which TMA
    addresses (a layout or alignment copy counted in ``a_copies``; a cast
    is a copy anyway)."""
    dtype = dtype or t.dtype
    pitch = runtime.a_pitch(t)
    readable = pitch is not None and (runtime.tma_operand(t, pitch)
                                      or runtime.a_copy_bytes(t) >= 4)
    if dtype == t.dtype and readable:
        return t
    if not readable:
        a_copies["calls"] += 1
        a_copies["bytes"] += t.numel() * dtype.itemsize
    return padded_rows(t, dtype)


#: planned executions in progress (the Functions' forwards)
_EXECUTING = [0]


@contextlib.contextmanager
def _executing():
    _EXECUTING[0] += 1
    try:
        yield
    finally:
        _EXECUTING[0] -= 1


def planned_executing() -> bool:
    """Whether a planned Function's forward is running: the ops it
    dispatches are its planned product (``transformer._dots_policy``
    treats them as the reference's policy treats a ``custom_vjp``)."""
    return _EXECUTING[0] > 0


class _MMPlanned(torch.autograd.Function):
    """``x @ w`` on a plan (the reference's ``_mm_planned`` custom_vjp):
    the backward's dx and dW are planned GEMMs themselves."""

    @staticmethod
    def forward(ctx, plan, site, x, w):
        ctx.site = site
        ctx.save_for_backward(x, w)
        with _executing():
            return _execute(plan, x, _operand(w))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        # dx's A and dW's B: padded rows where g's allow no 4-byte copy
        # (the head's cotangent over an odd vocabulary), one copy for both
        g = _a_rows(g)
        if ctx.needs_input_grad[2]:
            dx = _dispatch_mm(g, w.T, ctx.site + "/bwd_dx")
        if ctx.needs_input_grad[3]:
            dw = _dispatch_mm(_a_rows(x.T), g, ctx.site + "/bwd_dw")
        return None, None, dx, dw


def _dispatch_mm(x: torch.Tensor, w: torch.Tensor, site: str):
    """``x[m,k] @ w[k,n]`` at one site: decide, record, then the plan under
    ``_MMPlanned``, or the plain version (plain autograd) for a
    fallback.  ``x`` is in a layout the GEMMs read as A."""
    m, k = x.shape
    n = w.shape[1]
    plan, reason = _decide("mm", (m, n, k), x.dtype, w.dtype)
    _record(site, (m, n, k), plan=plan, reason=reason)
    if plan is None:
        _fallback_allowed(x, site, (m, n, k), reason)
        return ref.mm(x, w)
    return _MMPlanned.apply(plan, site, x, w)


def planned_dense(x: torch.Tensor, w: torch.Tensor, *,
                  site: str = "dense") -> torch.Tensor:
    """``x @ w`` routed through the mapper.

    ``x``: [..., K] (leading dims collapse to the mm M extent); ``w``:
    [K, N], row-major or the transpose of a row-major [N, K] (the tied
    lm_head).  Returns [..., N]: the input dtype for floats, int32 for
    integers, on the planned and the fallback path alike.  Raises for a
    card tensor without a plan (see the module docstring).
    """
    lead = x.shape[:-1]
    k, n = x.shape[-1], w.shape[-1]
    m = int(math.prod(lead)) if lead else 1
    out = _dispatch_mm(x.reshape(m, k).contiguous(), w, site)
    return out.reshape(*lead, n)


class _BMMPlanned(torch.autograd.Function):
    """Batched ``a @ b`` on a plan (the reference's ``_bmm_planned``): the
    cotangent is cast to each operand's dtype before the backward's
    planned products, so fp32 scores' cotangent enters them in bf16."""

    @staticmethod
    def forward(ctx, plan, site, out_dtype, a, b):
        ctx.site = site
        ctx.save_for_backward(a, b)
        with _executing():
            return _execute(plan, a, b, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        # dA's A and dB's B: one cast (into padded rows, which TMA
        # addresses, where g's own rows would not do) for both
        ga = _a_rows(g, a.dtype)
        if ctx.needs_input_grad[3]:
            da = _dispatch_bmm(ga, b.transpose(1, 2), ctx.site + "/bwd_da")
        if ctx.needs_input_grad[4]:
            gb = ga if b.dtype == a.dtype else g.to(b.dtype)
            db = _dispatch_bmm(_a_rows(a.transpose(1, 2)), gb,
                               ctx.site + "/bwd_db")
        return None, None, None, da, db


def _dispatch_bmm(a: torch.Tensor, b: torch.Tensor, site: str,
                  out_dtype: torch.dtype | None = None):
    """``a[z,m,k] @ b[z,k,n]`` at one site, as ``_dispatch_mm``."""
    nb, m, k = a.shape
    n = b.shape[2]
    b = _operand(b)
    plan, reason = _decide("bmm", (nb, m, n, k), a.dtype, b.dtype)
    _record(site, (nb, m, n, k), plan=plan, reason=reason)
    if plan is None:
        _fallback_allowed(a, site, (nb, m, n, k), reason)
        return ref.bmm(a, b, out_dtype)
    return _BMMPlanned.apply(plan, site, out_dtype, a, b)


def planned_bmm(a: torch.Tensor, b: torch.Tensor, *, site: str = "bmm",
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Batched ``a @ b`` routed through the mapper.

    ``a``: [..., M, K]; ``b``: [..., K, N] with identical leading batch
    dims (collapsed to the bmm batch extent).  ``out_dtype`` asks the
    kernel to flush its fp32/int32 accumulator at that dtype, without
    upcasting the operands.
    """
    batch = a.shape[:-2]
    if b.shape[:-2] != batch:
        raise ValueError(f"batch dims differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    nb = int(math.prod(batch)) if batch else 1
    m, k = a.shape[-2:]
    n = b.shape[-1]
    a3 = a.reshape(nb, m, k)
    if runtime.a_pitch(a3) is None:  # padded rows stay as they are
        a3 = a3.contiguous()
    out = _dispatch_bmm(a3, b.reshape(nb, k, n), site, out_dtype)
    return out.reshape(*batch, m, n)


# -- fused MLP pair (mm+mm chain) -------------------------------------------

#: Interstage activations the fused pair supports — matched to the
#: ``bias_*`` forms in ``core.fusion.INTERSTAGE_OPS`` (gelu is the tanh
#: form, ``jax.nn.gelu``'s default).
_ACT_FNS = {"relu": torch.relu, "silu": torch.nn.functional.silu,
            "gelu": lambda t: torch.nn.functional.gelu(t, approximate="tanh")}


def _pair_shape(m, k, ff, n):
    """Nested mm+mm chain extents for x[m,k] @ wu[k,ff] -> @ wd[ff,n]."""
    return ((m, ff, k), (m, n, ff))


def _decide_pair(m, k, ff, n, dtypes, act: str):
    """(FusedPlan, fallback_reason) for one up->down projection pair."""
    if not planned_enabled():
        return None, "disabled"
    if act not in _ACT_FNS:
        return None, f"act:{act}"
    names = sorted({dtype_name(d) for d in dtypes})
    if len(names) != 1 or names[0] not in SUPPORTED_DTYPES:
        return None, "dtype:" + "x".join(names)
    shape = _pair_shape(m, k, ff, n)
    _OBSERVED.add(("mm+mm", shape, names[0]))
    plan = resolve(plan_request("mm+mm", shape, names[0]))
    if plan is None:
        return None, "infeasible"
    return plan, None


def _execute_pair(plan, act: str, x, wu, bu, wd):
    from repro_torch.core import fusion  # late: fusion pulls the registry

    # the resolver fuses the bare chain; the boundary op is a call-site
    # property, stamped here (operand layout follows: x, wu, bias, wd)
    plan = dataclasses.replace(plan, interstage=("bias_" + act,))
    # a measured chip-level winner clamps to xla, as in the reference
    backend = plan.backend if plan.backend in ("xla", "pallas") else "xla"
    return fusion.lower_fused(plan, backend=backend)(x, wu, bu, wd)


class _MLPPairPlanned(torch.autograd.Function):
    """The fused pair on its plan (the reference's ``_mlp_pair_planned``).
    The fused forward keeps no intermediate, so the backward recomputes
    ``h`` through planned GEMMs, with the reference's casts at each step."""

    @staticmethod
    def forward(ctx, plan, site, act, x, wu, bu, wd):
        ctx.site, ctx.act = site, act
        ctx.save_for_backward(x, wu, bu, wd)
        with _executing():
            return _execute_pair(plan, act, x, wu, bu, wd)

    @staticmethod
    def backward(ctx, g):
        x, wu, bu, wd = ctx.saved_tensors
        site = ctx.site
        h_pre = _dispatch_mm(_a_rows(x), wu, site + "/bwd_up") + bu
        with torch.enable_grad():
            h_in = h_pre.detach().requires_grad_()
            h = _ACT_FNS[ctx.act](h_in)
        dwd = _dispatch_mm(_a_rows(h.detach().T, g.dtype), g,
                           site + "/bwd_dwd")
        dh = _dispatch_mm(_a_rows(g), wd.T.to(g.dtype), site + "/bwd_dh")
        (dh_pre,) = torch.autograd.grad(h, h_in, dh.to(h_pre.dtype))
        dbu = dh_pre.sum(0).to(bu.dtype)
        dwu = _dispatch_mm(_a_rows(x.T), dh_pre.to(x.dtype),
                           site + "/bwd_dwu")
        dx = _dispatch_mm(_a_rows(dh_pre, x.dtype), wu.T, site + "/bwd_dx")
        return None, None, None, dx, dwu, dbu, dwd


def planned_mlp_pair(x: torch.Tensor, wu: torch.Tensor, bu: torch.Tensor,
                     wd: torch.Tensor, *, act: str = "gelu",
                     site: str = "mlp.pair") -> torch.Tensor:
    """The transformer up -> bias+activation -> down projection pair,
    planned as one ``mm+mm`` chain.

    ``x``: [..., K]; ``wu``: [K, FF]; ``bu``: [FF]; ``wd``: [FF, N].  A
    chain that fuses runs ``fusion.lower_fused`` at the plan's backend
    under ``_MLPPairPlanned``; one that does not runs the unfused
    semantics through the planned GEMMs: ``planned_dense(x, wu,
    site="mlp.up")`` + bias + activation, then ``planned_dense(..., wd,
    site="mlp.down")``.
    """
    lead = x.shape[:-1]
    k = x.shape[-1]
    ff, n = wu.shape[-1], wd.shape[-1]
    m = int(math.prod(lead)) if lead else 1
    plan, reason = _decide_pair(
        m, k, ff, n, (x.dtype, wu.dtype, bu.dtype, wd.dtype), act)
    _record(site, _pair_shape(m, k, ff, n), plan=plan, reason=reason)
    if plan is None:
        act_fn = _ACT_FNS.get(act, _ACT_FNS["gelu"])
        h = act_fn(planned_dense(x, wu, site="mlp.up") + bu)
        return planned_dense(h, wd, site="mlp.down")
    out = _MLPPairPlanned.apply(plan, site, act, x.reshape(m, k), wu, bu, wd)
    return out.reshape(*lead, n)


# -- signal-processing frontend (fir / fused fft2d chain / conv2d) ----------
#
# The streaming audio frontend (serve/frontend.py) runs its filter bank,
# FFT tiles and feature extractor through these — the same
# resolve(plan_request(...)) path as the model GEMMs, with per-site report
# rows.  Inference-only surfaces: no backward (the frontend never trains).

def planned_fir(x: torch.Tensor, h: torch.Tensor, *,
                site: str = "frontend.fir") -> torch.Tensor:
    """1-D FIR filter bank ``y[n] = sum_t x[n+t] * h[t]`` routed through
    the mapper.

    ``x``: [N]; ``h``: [T]; returns [N-T+1] in the kernel's accumulator
    dtype (int32 for integer inputs, float32 for float32) — identical to
    ``ref.fir``, so planned and fallback paths agree.
    """
    n_out = int(x.shape[-1]) - int(h.shape[-1]) + 1
    taps = int(h.shape[-1])
    plan, reason = _decide("fir", (n_out, taps), x.dtype, h.dtype)
    _record(site, (n_out, taps), plan=plan, reason=reason)
    if plan is None:
        _fallback_allowed(x, site, (n_out, taps), reason)
        return ref.fir(x, h)
    return execute_plan(plan, x.contiguous(), h.contiguous())


def planned_conv2d(img: torch.Tensor, filt: torch.Tensor, *,
                   site: str = "frontend.conv2d") -> torch.Tensor:
    """VALID 2-D cross-correlation routed through the mapper.

    ``img``: [H, W]; ``filt``: [P, Q]; returns [H-P+1, W-Q+1] in the
    accumulator dtype (int32 for integer inputs, float32 for float32).
    """
    p, q = (int(d) for d in filt.shape)
    oh = int(img.shape[0]) - p + 1
    ow = int(img.shape[1]) - q + 1
    plan, reason = _decide("conv2d", (oh, ow, p, q), img.dtype, filt.dtype)
    _record(site, (oh, ow, p, q), plan=plan, reason=reason)
    if plan is None:
        _fallback_allowed(img, site, (oh, ow, p, q), reason)
        return ref.conv2d(img, filt)
    return execute_plan(plan, img.contiguous(), filt.contiguous())


def _decide_fft2d(rows: int, cols: int, dtypes):
    """(FusedPlan, fallback_reason) for one fft2d stage1->stage2 chain."""
    if not planned_enabled():
        return None, "disabled"
    names = sorted({dtype_name(d) for d in dtypes})
    if names != ["float32"]:
        return None, "dtype:" + "x".join(names)
    shape = ((rows, cols), (rows, cols))
    _OBSERVED.add(("fft2d_stage+fft2d_stage", shape, "float32"))
    plan = resolve(plan_request("fft2d_stage+fft2d_stage", shape, "float32"))
    if plan is None:
        return None, "infeasible"
    return plan, None


def planned_fft2d(x_re: torch.Tensor, x_im: torch.Tensor, *,
                  site: str = "frontend.fft2d"):
    """Whole 2-D FFT of one [rows, cols] tile, planned as the fused
    ``fft2d_stage+fft2d_stage`` chain.

    ``x_re``/``x_im``: float32 [rows, cols] planes; returns the
    ``(real, imag)`` float32 pair, as ``ref.fft2d``.  The chain's plan is
    stamped ``xla`` (the reference's default), so this runs
    ``torch.fft.fft2``; a ``pallas`` stamp would run the fused fft2d
    kernel (``kernels/fft2d.py``).
    """
    from repro_torch.core import fusion  # late: fusion pulls the registry

    rows, cols = (int(d) for d in x_re.shape)
    shape = ((rows, cols), (rows, cols))
    plan, reason = _decide_fft2d(rows, cols, (x_re.dtype, x_im.dtype))
    _record(site, shape, plan=plan, reason=reason)
    if plan is None:
        _fallback_allowed(x_re, site, shape, reason)
        return ref.fft2d(x_re, x_im)
    return fusion.lower_fused(plan)(x_re, x_im)
