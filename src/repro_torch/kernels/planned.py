"""Planned-execution facade: model GEMMs and the audio frontend routed
through the mapper.

The port of ``repro.kernels.planned`` for the serving paths.
``planned_dense(x, w)`` and ``planned_bmm(a, b)`` normalize call-site
shapes onto the registered ``mm``/``bmm`` recurrences, resolve one
``PlanRequest`` per shape through the copied planner, and run the plan
(``runtime.execute_plan``: the hand-written Hopper kernel for the
mapper's ``pallas`` stamp).  ``planned_fir``/``planned_conv2d`` do the
same for the frontend's filter bank and feature extractor.
``planned_fft2d`` and ``planned_mlp_pair`` resolve a two-stage chain
(``fft2d_stage+fft2d_stage``, ``mm+mm``) to a ``FusedPlan`` whose
backend is the reference's default ``xla``: they run the plain versions
(``torch.fft.fft2``; ``torch.matmul`` in fp32 with the bias and gelu
between), which is the plan's own stamp, not a fallback.  These are
inference-only surfaces (no backward).  The target, the supported dtypes and the
fallback rules are the reference's, so both packages make the same
decision with the same reason at every call site:

  * planning disabled (``configure(enabled=False)``) -> ``"disabled"``;
  * mismatched or unsupported operand dtypes -> ``"dtype:AxB"``;
  * shapes the mapper has no feasible plan for -> ``"infeasible"``.

A fallback runs the plain PyTorch version in ``ref.py`` for tensors on
the CPU.  Off the CPU only the explicit ``"disabled"`` switch runs it: a
card tensor whose call has no plan (``dtype:…``, ``infeasible``) raises,
so the serving path never leaves the hand kernels unseen.  The port's
default policy is ``PlanPolicy(mode="modelled")``: the reference's
committed crossover table holds winners timed for its own backends.

``planned_report()`` keeps per-call-site counters.  PyTorch runs eagerly,
so a decision is counted on every call (the reference counts once per
trace).
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

DEFAULT_POLICY = PlanPolicy(mode="modelled")


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


def _operand(t: torch.Tensor) -> torch.Tensor:
    """A kernel operand: row-major, or (for B) the transpose of a
    row-major tensor; anything else is made contiguous."""
    if t.is_contiguous() or t.transpose(-1, -2).is_contiguous():
        return t
    return t.contiguous()


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
    x2 = x.reshape(m, k).contiguous()
    plan, reason = _decide("mm", (m, n, k), x.dtype, w.dtype)
    _record(site, (m, n, k), plan=plan, reason=reason)
    if plan is None:
        _fallback_allowed(x, site, (m, n, k), reason)
        out = ref.mm(x2, w)
    else:
        out = execute_plan(plan, x2, _operand(w))
    return out.reshape(*lead, n)


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
    b3 = _operand(b.reshape(nb, k, n))
    plan, reason = _decide("bmm", (nb, m, n, k), a.dtype, b.dtype)
    _record(site, (nb, m, n, k), plan=plan, reason=reason)
    if plan is None:
        _fallback_allowed(a, site, (nb, m, n, k), reason)
        out = ref.bmm(a3, b3, out_dtype)
    else:
        out = execute_plan(plan, a3, b3, out_dtype=out_dtype)
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
    return fusion.lower_fused(plan)(x, wu, bu, wd)


def planned_mlp_pair(x: torch.Tensor, wu: torch.Tensor, bu: torch.Tensor,
                     wd: torch.Tensor, *, act: str = "gelu",
                     site: str = "mlp.pair") -> torch.Tensor:
    """The transformer up -> bias+activation -> down projection pair,
    planned as one ``mm+mm`` chain.

    ``x``: [..., K]; ``wu``: [K, FF]; ``bu``: [FF]; ``wd``: [FF, N].  A
    chain that fuses runs ``fusion.lower_fused`` at the plan's backend;
    one that does not runs the unfused semantics through the planned
    GEMMs: ``planned_dense(x, wu, site="mlp.up")`` + bias + activation,
    then ``planned_dense(..., wd, site="mlp.down")``.
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
    out = _execute_pair(plan, act, x.reshape(m, k), wu, bu, wd)
    return out.reshape(*lead, n)


# -- signal-processing frontend (fir / fused fft2d chain / conv2d) ----------
#
# The streaming audio frontend (serve/frontend.py) runs its filter bank,
# FFT tiles and feature extractor through these — the same
# resolve(plan_request(...)) path as the model GEMMs, with per-site report
# rows.  Inference-only surfaces.

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
    ``torch.fft.fft2``; a ``pallas`` stamp would run the composition over
    the mm kernel (``kernels/fft2d.py``).
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
