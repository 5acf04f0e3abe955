"""Cross-recurrence fusion — the port's copy of ``repro.core.fusion`` for
one card.

  * ``RecurrenceChain`` — an ordered producer->consumer tuple of
    registered ``UniformRecurrence``s; stage ``i+1``'s leading operand(s)
    are stage ``i``'s output(s).
  * ``fuse(chain, target)`` — the legality pass (registration, length, no
    flow dependence, ``fusable_with``, one dtype, shape agreement, one
    family, mesh) that returns a ``FusedPlan`` or raises ``FusionError``
    with a typed ``reason``; ``try_fuse`` returns None instead.
  * ``lower_fused(plan, backend)`` — the ``xla`` composition (each stage's
    plain version, ``reference_chain``) and the ``pallas`` composition
    (each stage's plan through ``runtime.execute_plan``, i.e. the hand
    kernels on the card).

Three chain families, as in the reference: the non-GLU MLP pair
``mm+mm`` (``cannon``), the 2-D FFT ``fft2d_stage+fft2d_stage``
(``fft``), and ``halo`` chains of conv2d and the single-sweep stencils
(``conv2d -> jacobi2d``, ``jacobi2d <-> jacobi2d_9pt``), whose consumer
reads the producer's output as its padded grid.  The reference's
one-shard_map ``fused_systolic`` schedules are multi-device work
(ROADMAP A12): that backend raises ``NotImplementedError``.

``FusedPlan.backend`` defaults to ``"xla"``, as in the reference: the
modelled policy never restamps it, so both serving chains run their
plain versions (``torch.matmul`` in fp32, ``torch.fft.fft2``) — the
plan's own stamp, not a fallback.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
import torch.nn.functional as F

from .mapper import ExecutionPlan, Target, best_plan as _stage_best_plan
from .partition import DTYPE_BYTES
from .recurrence import UniformRecurrence, halo_radius

#: Interstage elementwise ops a boundary may apply to the intermediate (the
#: MLP pair needs ``bias_silu``/``bias_gelu``).  A ``bias``-prefixed op
#: adds one extra (vector) chain operand after the producer's operands.
INTERSTAGE_OPS = (None, "relu", "silu", "gelu",
                  "bias", "bias_relu", "bias_silu", "bias_gelu")

_STENCIL_NAMES = frozenset({"jacobi2d", "jacobi2d_9pt"})
_HALO_NAMES = _STENCIL_NAMES | {"conv2d"}


class FusionError(ValueError):
    """A chain failed the fusion legality pass.  ``reason`` is a stable
    machine-checkable tag: unregistered | length | flow | unfusable-pair
    | dtype-mismatch | shape-mismatch | family | mesh-mismatch |
    halo-exceeds-shard | infeasible | interstage."""

    def __init__(self, reason: str, message: str):
        super().__init__(f"[{reason}] {message}")
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class RecurrenceChain:
    """Producer->consumer list of uniform recurrences (the chain IR)."""

    stages: tuple[UniformRecurrence, ...]

    @property
    def name(self) -> str:
        return "+".join(s.name for s in self.stages)

    @property
    def dtype(self) -> str:
        return self.stages[0].dtype


def chain(*stages: UniformRecurrence) -> RecurrenceChain:
    return RecurrenceChain(tuple(stages))


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """A legal chain's plan: per-stage modelled plans plus the chain-level
    backend decision."""

    chain: RecurrenceChain
    stage_plans: tuple[ExecutionPlan, ...]
    target: Target
    family: str                        # "halo" | "cannon" | "fft"
    interstage: tuple[str | None, ...]  # one op per stage boundary
    systolic_ok: bool                  # target mesh carries the fused ring
    predicted_bytes_saved: int         # HBM bytes the fusion removes
    backend: str = "xla"
    provenance: str = "modelled"

    @property
    def recurrence(self) -> RecurrenceChain:
        """Duck-type parity with ExecutionPlan."""
        return self.chain

    @property
    def feasible(self) -> bool:
        return all(p.feasible for p in self.stage_plans)

    def describe(self) -> str:
        return (
            f"[fused {self.chain.name}/{self.chain.dtype}] "
            f"family={self.family} stages={len(self.stage_plans)} "
            f"bytes_saved={self.predicted_bytes_saved} "
            f"backend={self.backend}[{self.provenance}]"
        )


# ---------------------------------------------------------------------------
# shape algebra and the legality pass
# ---------------------------------------------------------------------------

def _io_shape(rec: UniformRecurrence) -> tuple[tuple[int, ...],
                                               tuple[int, ...]]:
    """(input-operand shape, output shape) of one stage, from the IR."""
    if rec.name == "conv2d":
        h, w, p, q = (rec.extent(l) for l in ("h", "w", "p", "q"))
        return (h + p - 1, w + q - 1), (h, w)
    if rec.name in _STENCIL_NAMES:
        r = halo_radius(rec, ("i", "j"))
        h, w = rec.extent("i"), rec.extent("j")
        return (h + 2 * r, w + 2 * r), (h, w)
    if rec.name == "mm":
        m, n, k = (rec.extent(l) for l in ("i", "j", "k"))
        return (m, k), (m, n)
    if rec.name == "fft2d_stage":
        r, c = rec.extent("i"), rec.extent("j")
        return (r, c), (r, c)
    raise FusionError(
        "family", f"no fused shape algebra for recurrence {rec.name!r}")


def chain_family(ch: RecurrenceChain) -> str:
    names = [s.name for s in ch.stages]
    if all(n in _HALO_NAMES for n in names):
        return "halo"
    if all(n == "mm" for n in names):
        return "cannon"
    if all(n == "fft2d_stage" for n in names):
        return "fft"
    raise FusionError(
        "family",
        f"chain {'+'.join(names)} mixes fusion families (halo: "
        f"{sorted(_HALO_NAMES)}; cannon: mm; fft: fft2d_stage)")


def halo_shrink(ch: RecurrenceChain) -> tuple[int, int]:
    """Total (rows, cols) a halo chain consumes beyond its final output:
    each conv2d stage its (p - 1, q - 1), each stencil stage twice its
    star's radius (``halo_radius``, from the IR accesses)."""
    s_h = s_w = 0
    for rec in ch.stages:
        if rec.name == "conv2d":
            s_h += rec.extent("p") - 1
            s_w += rec.extent("q") - 1
        else:
            r = halo_radius(rec, ("i", "j"))
            s_h += 2 * r
            s_w += 2 * r
    return s_h, s_w


def _check_mesh(ch: RecurrenceChain, family: str,
                mesh_shape: tuple[int, ...]) -> bool:
    """Mesh-level legality, as the reference's.  Raises FusionError when
    the fused schedule cannot run on this mesh at all; returns whether
    the one-shard_map schedule would be available (a degenerate 1-wide
    axis still permits the composition for the cannon / fft families,
    just not the ring)."""
    n0, n1 = (mesh_shape + (1, 1))[:2]
    if family == "halo":
        out_h, out_w = _io_shape(ch.stages[-1])[1]
        if out_h % n0 or out_w % n1:
            raise FusionError(
                "mesh-mismatch",
                f"fused output {out_h}x{out_w} does not shard over the "
                f"{n0}x{n1} mesh (both extents must divide the axis "
                "widths)")
        s_h, s_w = halo_shrink(ch)
        bh, bw = out_h // n0, out_w // n1
        if (n0 > 1 and s_h > bh) or (n1 > 1 and s_w > bw):
            raise FusionError(
                "halo-exceeds-shard",
                f"deep halo {s_h}x{s_w} exceeds the {bh}x{bw} shard — a "
                "one-hop exchange can only import the adjacent shard; "
                "use fewer chips or a larger grid")
        return True
    if n0 != n1:
        if n0 > 1 and n1 > 1:
            raise FusionError(
                "mesh-mismatch",
                f"fused {family} ring needs a square space mesh, got "
                f"{n0}x{n1} — the shared pre-skew/rotation sequence only "
                "closes on a square array")
        return False
    if n0 > 1:
        for rec in ch.stages:
            for loop in ("i", "j", "k"):
                if rec.extent(loop) % n0:
                    raise FusionError(
                        "mesh-mismatch",
                        f"{rec.name} extent {loop}={rec.extent(loop)} "
                        f"does not divide the {n0}-wide ring")
    return True


def _out_dtype_name(dtype: str) -> str:
    """The accumulator's output dtype name: int accumulations widen to
    int32 (the reference's ``runtime.out_dtype``)."""
    return "int32" if dtype.startswith("int") else dtype


def _bytes_saved(ch: RecurrenceChain, family: str) -> int:
    """Predicted HBM bytes fusion removes vs standalone launches: one
    write + one read of every intermediate (the fft family's complex
    intermediate rides as two float32 planes)."""
    total = 0
    planes = 2 if family == "fft" else 1
    for rec in ch.stages[:-1]:
        out_shape = _io_shape(rec)[1]
        exec_dtype = "float32" if family == "fft" else rec.dtype
        per_el = DTYPE_BYTES.get(_out_dtype_name(exec_dtype), 4)
        total += 2 * planes * per_el * math.prod(out_shape)
    return total


def fuse(ch: RecurrenceChain, target: Target = Target(),
         interstage: tuple[str | None, ...] | None = None) -> FusedPlan:
    """The fusion pass: legality checks (module docstring) then a
    ``FusedPlan`` carrying the per-stage modelled plans.  Raises
    ``FusionError`` (typed ``reason``) on any illegal chain."""
    from repro_torch.kernels import registry

    if len(ch.stages) < 2:
        raise FusionError(
            "length", f"a chain needs >= 2 stages, got {len(ch.stages)}")
    specs = []
    for rec in ch.stages:
        try:
            specs.append(registry.get(rec.name))
        except registry.UnregisteredRecurrenceError as e:
            raise FusionError("unregistered", str(e)) from e
    for rec in ch.stages:
        flows = [d for d in rec.dependences() if d.kind == "flow"]
        if flows:
            raise FusionError(
                "flow",
                f"stage {rec.name} carries a flow dependence "
                f"({flows[0].array} along {flows[0].distance}) — the "
                "carried loop must stay host-sequential, so the stage "
                "cannot join a fused space mapping")
    for prod, cons_spec in zip(ch.stages[:-1], specs[1:]):
        if prod.name not in cons_spec.fusable_with:
            raise FusionError(
                "unfusable-pair",
                f"{cons_spec.name} does not declare {prod.name!r} in "
                f"fusable_with={cons_spec.fusable_with!r}")
    dtypes = {s.dtype for s in ch.stages}
    if len(dtypes) > 1:
        raise FusionError(
            "dtype-mismatch",
            f"stages disagree on dtype: {sorted(dtypes)} — the "
            "intermediate has one acc dtype")
    family = chain_family(ch)
    for prod, cons in zip(ch.stages[:-1], ch.stages[1:]):
        out_shape = _io_shape(prod)[1]
        in_shape = _io_shape(cons)[0]
        if out_shape != in_shape:
            raise FusionError(
                "shape-mismatch",
                f"{prod.name} output {out_shape} != {cons.name} read "
                f"footprint {in_shape} — the consumer must cover exactly "
                "the producer's output domain")
    n_bound = len(ch.stages) - 1
    inter = tuple(interstage) if interstage is not None else (
        (None,) * n_bound)
    if len(inter) != n_bound:
        raise FusionError(
            "interstage",
            f"{len(inter)} interstage ops for {n_bound} boundaries")
    for op in inter:
        if op not in INTERSTAGE_OPS:
            raise FusionError(
                "interstage", f"unknown interstage op {op!r} "
                f"(supported: {INTERSTAGE_OPS})")
        if op is not None and family != "cannon":
            raise FusionError(
                "interstage",
                f"interstage op {op!r} is only supported on the cannon "
                "(dense) family")
    systolic_ok = _check_mesh(ch, family, tuple(target.mesh_shape))
    try:
        stage_plans = tuple(
            _stage_best_plan(rec, target) for rec in ch.stages)
    except RuntimeError as e:
        raise FusionError("infeasible", str(e)) from e
    return FusedPlan(
        chain=ch,
        stage_plans=stage_plans,
        target=target,
        family=family,
        interstage=inter,
        systolic_ok=systolic_ok,
        predicted_bytes_saved=_bytes_saved(ch, family),
    )


def try_fuse(ch: RecurrenceChain, target: Target = Target(),
             interstage: tuple[str | None, ...] | None = None
             ) -> FusedPlan | None:
    """``fuse`` with the fallback contract: None on any illegal chain."""
    try:
        return fuse(ch, target, interstage=interstage)
    except FusionError:
        return None


def chain_from_request(kind: str, shapes, dtype: str) -> RecurrenceChain:
    """Build the chain a ``PlanRequest(kind="a+b", shape=((...), (...)))``
    names — the ``autotune.resolve`` entry point for chains."""
    from repro_torch.kernels import registry

    names = kind.split("+")
    if len(names) != len(shapes):
        raise FusionError(
            "length",
            f"chain kind {kind!r} has {len(names)} stages but "
            f"{len(shapes)} shape tuples")
    stages = []
    for nm, args in zip(names, shapes):
        try:
            stages.append(registry.get(nm).builder(*tuple(args), dtype))
        except registry.UnregisteredRecurrenceError as e:
            raise FusionError("unregistered", str(e)) from e
    return RecurrenceChain(tuple(stages))


# ---------------------------------------------------------------------------
# operand contract
# ---------------------------------------------------------------------------

def interstage_has_bias(op: str | None) -> bool:
    return op is not None and op.startswith("bias")


def interstage_apply(op: str | None, mid, bias=None):
    """Apply one boundary's elementwise op to the intermediate.  gelu is
    the tanh form, ``jax.nn.gelu``'s default."""
    if op is None:
        return mid
    parts = op.split("_")
    if parts[0] == "bias":
        mid = mid + bias
        parts = parts[1:]
    if parts:
        act = {"relu": torch.relu, "silu": F.silu,
               "gelu": functools.partial(F.gelu, approximate="tanh")}
        mid = act[parts[0]](mid)
    return mid


def operand_counts(ch: RecurrenceChain,
                   interstage: tuple[str | None, ...]) -> tuple[int, ...]:
    """Chain operand layout: stage 0 contributes its full spec arity;
    each boundary contributes one bias vector when its interstage op is
    bias-prefixed; each later stage contributes its arity minus the
    producer's ``n_outputs`` (the intermediate is passed on)."""
    from repro_torch.kernels import registry

    specs = [registry.get(s.name) for s in ch.stages]
    counts = [specs[0].arity]
    for b, spec in enumerate(specs[1:]):
        counts.append(1 if interstage_has_bias(interstage[b]) else 0)
        counts.append(spec.arity - specs[b].n_outputs)
    return tuple(counts)


def split_operands(plan: FusedPlan, operands) -> tuple[list, list]:
    """(per-stage operand tuples, per-boundary bias-or-None) from the
    flat chain operand list."""
    counts = operand_counts(plan.chain, plan.interstage)
    n = sum(counts)
    if len(operands) != n:
        raise ValueError(
            f"fused chain {plan.chain.name} expects {n} operands "
            f"(layout {counts}), got {len(operands)}")
    it = iter(operands)
    stage_ops = [tuple(next(it) for _ in range(counts[0]))]
    biases = []
    for b in range(len(plan.chain.stages) - 1):
        n_bias, n_fresh = counts[1 + 2 * b], counts[2 + 2 * b]
        biases.append(next(it) if n_bias else None)
        stage_ops.append(tuple(next(it) for _ in range(n_fresh)))
    return stage_ops, biases


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

def _composed(plan: FusedPlan, stage_fn: Callable[[int], Callable]
              ) -> Callable:
    """Composition of the per-stage lowerings.  The fft family's
    registered lowerings compute the *whole* 2-D FFT (both DFT stages),
    so its composition is one call, not two."""
    if plan.family == "fft":
        fn0 = stage_fn(0)

        def run_fft(*operands):
            stage_ops, _ = split_operands(plan, operands)
            return fn0(*stage_ops[0])

        return run_fft

    def run(*operands):
        stage_ops, biases = split_operands(plan, operands)
        cur = stage_fn(0)(*stage_ops[0])
        for b in range(len(plan.chain.stages) - 1):
            cur = interstage_apply(plan.interstage[b], cur, biases[b])
            cur = stage_fn(b + 1)(cur, *stage_ops[b + 1])
        return cur

    return run


def reference_chain(plan: FusedPlan) -> Callable:
    """The unfused oracle: each stage's plain version, composed."""
    from repro_torch.kernels import registry

    specs = [registry.get(s.name) for s in plan.chain.stages]
    return _composed(plan, lambda i: specs[i].ref)


def lower_fused(plan: FusedPlan, backend: str | None = None) -> Callable:
    """Executable for a fused plan: ``xla`` composes the plain versions,
    ``pallas`` composes ``execute_plan`` over the stage plans (the hand
    kernels on the card).  ``fused_systolic`` is not ported."""
    backend = backend or plan.backend
    if backend == "xla":
        return reference_chain(plan)
    if backend == "pallas":
        from repro_torch.kernels import runtime

        return _composed(plan, lambda i: functools.partial(
            runtime.execute_plan, plan.stage_plans[i]))
    if backend in ("fused_systolic", "systolic"):
        raise NotImplementedError(
            "the one-shard_map fused_systolic schedules are multi-device "
            "work the port has not done yet (ROADMAP A12); the port runs "
            "the xla/pallas compositions")
    raise ValueError(f"unknown fused backend {backend!r}")
