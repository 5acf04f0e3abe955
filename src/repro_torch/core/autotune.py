"""Measured autotuning with a persisted crossover table (the port of
``repro.core.autotune``).

The mapper's ``best_plan`` ranks mappings with the modelled cost
pipeline; it does not know which backend lowering of a mapping wins on a
given machine.  This module measures that, as the reference's does:

  * ``race(rec, target, policy)`` times every backend lowering this
    process can execute (``available_backends``) on seeded operands on
    ``policy.device`` (the card unless the caller asks for the CPU) —
    ``warmup`` untimed calls, then the median of ``reps`` timed ones
    (CUDA events on the card, ``time.perf_counter`` on the CPU) — and
    returns the winner;
  * winners persist to a JSON crossover table keyed by ``(spec, shape,
    dtype, mesh)`` (``autotune_key``: the reference's strings, byte for
    byte);
  * the port's committed table (``default_autotune.json`` next to this
    file, generated on the H100 by ``python -m
    repro_torch.launch.gen_autotune``; never the reference's table, whose
    timings are its own backends') covers every registered spec's smoke
    and bench shapes, the serving census of the smoke configs and the
    fused MLP-pair chains;
  * ``PlanPolicy`` decides how ``mapper.best_plan`` consults it:
    ``modelled`` never touches the table; ``cached`` stamps a hit's
    measured winner and leaves a miss modelled, timing nothing;
    ``measured`` races a miss and persists the winner when the policy
    names a ``table_path``.

The backends are the reference's: ``pallas`` is the hand-written Hopper
kernel (``runtime.execute_plan``), ``xla`` the registry's plain PyTorch
version (``codegen.lower_plan``), and, where ``parallel.mesh`` counts
enough logical devices for the target's mesh (one for a 1 x 1 mesh, so
always on one card), the chip-level schedules ``systolic`` and
``allgather`` (``kernels/systolic.py``) and, for a ring-legal fused
chain, ``fused_systolic``, each on a mesh of the target's shape and axes
built from ``policy.device``'s logical devices.  A hierarchical target
(``core/hierarchy.py``) races the compositions of its groups
(``hierarchy.lower_hierarchical``) at the recurrence's own shape, and
its chip backends where ``dp * tp`` inner meshes exist, keyed with the
reference's five-field ``...|outer<DPxTP>|mesh<RxC>`` keys.  A stored
winner this process cannot run clamps to the fastest runnable backend
by its stored timings, as in the reference.  As in the reference, bench
shapes race at their spec's smoke proxy and
``measured_shape``/``measured_dtype`` record the proxy.

Timings are raw microseconds of the generating card; ``machine_factor``
relates fresh timings to a table's.  A corrupt, stale or
version-mismatched table raises ``TableError`` from ``load_table``;
``best_plan`` treats every such failure as a miss (the modelled plan and
a one-time warning).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import statistics
import time
import warnings
from pathlib import Path
from typing import Any

from .mapper import ExecutionPlan, Target

#: On-disk table schema this build reads and writes (the reference's).
TABLE_SCHEMA = 1

#: The port's committed table (regenerate: python -m
#: repro_torch.launch.gen_autotune on the card).
DEFAULT_TABLE_PATH = Path(__file__).with_name("default_autotune.json")

#: Backend lowerings a table may name, in dispatch order (the
#: reference's).
BACKENDS = ("pallas", "xla", "systolic", "allgather", "fused_systolic")

#: Declared dtypes a race executes as another: int32 races as int16,
#: complex as float32 real planes.  The table key keeps the declared one.
EXEC_DTYPE = {"int32": "int16", "cfloat": "float32", "cint16": "int16"}


def exec_dtype(kind: str, dtype: str) -> str:
    """The dtype a race runs spec ``kind``'s ``dtype`` cases on: its
    ``EXEC_DTYPE``, or the spec's first parity dtype where its kernel
    takes no such operands (fft2d_stage's cint16 runs on the float32
    real planes ``registry.operands`` draws for it, as the recurrence
    pipeline runs it: there are no integer DFT matrices)."""
    from repro_torch.kernels import registry

    dtypes = registry.get(kind).parity_dtypes
    run = EXEC_DTYPE.get(dtype, dtype)
    return run if run in dtypes else dtypes[0]

MODES = ("modelled", "cached", "measured")


class TableError(RuntimeError):
    """A crossover table failed validation (corrupt/stale/wrong schema)."""


@dataclasses.dataclass(frozen=True)
class PlanPolicy:
    """How ``best_plan`` consults the crossover table (module docstring).

    ``table_path=None`` means the committed table.  ``reps``/``warmup``
    set the ``measured`` race's protocol; ``device`` is where it runs
    (``"cuda"``, or ``"cpu"`` when the caller asks for it)."""

    mode: str = "modelled"
    table_path: str | None = None
    reps: int = 3
    warmup: int = 1
    device: str = "cuda"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f"PlanPolicy.mode must be modelled|cached|measured, got "
                f"{self.mode!r}")

    def path(self) -> Path:
        return (Path(self.table_path) if self.table_path
                else DEFAULT_TABLE_PATH)


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One shape-keyed planning request: ``kind`` names a registered
    KernelSpec, ``shape`` holds that spec's builder arguments.  A fused
    chain is requested as ``kind="producer+consumer"`` with ``shape`` a
    tuple of per-stage builder-argument tuples; it resolves to a
    ``FusedPlan`` (or None when the chain is illegal)."""

    kind: str
    shape: tuple
    dtype: str
    target: Target
    policy: PlanPolicy = PlanPolicy()


@functools.lru_cache(maxsize=4096)
def resolve(req: PlanRequest) -> ExecutionPlan | None:
    """Best *feasible* plan for a request, or None (the caller falls
    back).  Memoized per request; the None outcome of an infeasible shape
    is cached too, so it never re-runs the mapper search.  A hierarchical
    target with no legal outer split (``HierarchyError``) gives None, and
    so does a chain against a hierarchical target: chains do not compose
    hierarchically, and the facade's unfused stages do.  A plan kind the
    port has not ported (``NotImplementedError``) raises rather than
    reading as infeasible."""
    if any(d <= 0 for d in _flat_dims(req.shape)):
        return None
    from .hierarchy import HierarchyError
    from .mapper import best_plan

    if "+" in req.kind:  # fused chain request (core/fusion.py)
        if getattr(req.target, "outer_shape", None) is not None:
            return None
        from . import fusion

        try:
            chain = fusion.chain_from_request(
                req.kind, req.shape, req.dtype)
            plan = best_plan(chain, req.target, policy=req.policy)
        except NotImplementedError:
            raise
        except (fusion.FusionError, RuntimeError, TypeError):
            return None
        return plan if plan.feasible else None
    from repro_torch.kernels import registry  # late: kernels import core

    try:
        rec = registry.get(req.kind).builder(*req.shape, req.dtype)
    except (registry.UnregisteredRecurrenceError, TypeError):
        return None
    try:
        plan = best_plan(rec, req.target, policy=req.policy)
    except NotImplementedError:
        raise
    except (RuntimeError, HierarchyError):
        # HierarchyError: no legal outer split for this shape; the
        # facade falls back rather than erroring, as in the reference
        return None
    return plan if plan.feasible else None


def _flat_dims(shape):
    """Flatten a (possibly chain-nested) request shape for validation."""
    for d in shape:
        if isinstance(d, (tuple, list)):
            yield from d
        else:
            yield d


# ---------------------------------------------------------------------------
# key schema
# ---------------------------------------------------------------------------

def autotune_key(rec, mesh_shape: tuple[int, ...],
                 outer_shape: tuple[int, ...] | None = None) -> str:
    """``<name>|<dtype>|<extents joined by 'x', IR loop order>|mesh<RxC>``,
    the reference's key; a fused chain joins its stage names and stage
    extents with ``+``, and a hierarchical target adds ``outer<DPxTP>|``
    before the mesh."""
    mesh = "x".join(str(m) for m in mesh_shape)
    stages = getattr(rec, "stages", None)
    if stages is not None:
        extents = "+".join(
            "x".join(str(e) for e in s.extents) for s in stages)
    else:
        extents = "x".join(str(e) for e in rec.extents)
    outer = ""
    if outer_shape is not None:
        outer = "outer" + "x".join(str(o) for o in outer_shape) + "|"
    return f"{rec.name}|{rec.dtype}|{extents}|{outer}mesh{mesh}"


def request_key(req: PlanRequest) -> str:
    """The table key a PlanRequest resolves to (builder args -> IR)."""
    from repro_torch.kernels import registry

    outer = getattr(req.target, "outer_shape", None)
    if "+" in req.kind:
        from . import fusion

        chain = fusion.chain_from_request(req.kind, req.shape, req.dtype)
        return autotune_key(chain, req.target.mesh_shape, outer_shape=outer)
    rec = registry.get(req.kind).builder(*req.shape, req.dtype)
    return autotune_key(rec, req.target.mesh_shape, outer_shape=outer)


# ---------------------------------------------------------------------------
# table I/O + validation
# ---------------------------------------------------------------------------

def _validate(table: Any, path: Path) -> dict:
    if not isinstance(table, dict):
        raise TableError(f"{path}: table root must be an object")
    if table.get("schema") != TABLE_SCHEMA:
        raise TableError(
            f"{path}: schema {table.get('schema')!r} != supported "
            f"{TABLE_SCHEMA} (version-mismatched table)")
    entries = table.get("entries")
    if not isinstance(entries, dict):
        raise TableError(f"{path}: missing 'entries' object")
    for key, entry in entries.items():
        if not isinstance(entry, dict):
            raise TableError(f"{path}: entry {key!r} is not an object")
        backend = entry.get("backend")
        us = entry.get("us")
        if backend not in BACKENDS:
            raise TableError(
                f"{path}: entry {key!r} names unknown backend "
                f"{backend!r} (stale table?)")
        if (not isinstance(us, dict) or backend not in us
                or not all(isinstance(v, (int, float)) and v > 0
                           for v in us.values())):
            raise TableError(
                f"{path}: entry {key!r} has no positive 'us' timing "
                f"for its winner (stale table?)")
    return table


@functools.lru_cache(maxsize=32)
def _load_cached(path_str: str, mtime_ns: int) -> dict:
    path = Path(path_str)
    try:
        raw = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError) as e:
        raise TableError(f"{path}: unreadable/corrupt table: {e}") from e
    return _validate(raw, path)


def load_table(path: str | Path) -> dict:
    """Load and validate a crossover table; ``TableError`` on any
    corruption.  Cached by (path, mtime), so a rewrite is picked up."""
    path = Path(path)
    try:
        mtime = path.stat().st_mtime_ns
    except OSError as e:
        raise TableError(f"{path}: no table file: {e}") from e
    return _load_cached(str(path), mtime)


def save_table(path: str | Path, table: dict) -> None:
    """Write ``table`` atomically (a temporary file, then a rename), with
    its schema and the median of its winners' timings."""
    path = Path(path)
    table = dict(table, schema=TABLE_SCHEMA)
    us = [e["us"][e["backend"]] for e in table.get("entries", {}).values()]
    if us:
        table["suite_median_us"] = round(statistics.median(us), 1)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(table, indent=2, sort_keys=True) + "\n",
                   encoding="utf-8")
    tmp.replace(path)


def new_table(note: str = "") -> dict:
    return {"schema": TABLE_SCHEMA, "note": note, "entries": {}}


def machine_factor(table: dict, fresh_us: dict[str, float]) -> float:
    """Median over shared keys of fresh / table winner microseconds:
    dividing a fresh timing by it lands in the table's time base."""
    ratios = []
    for key, us in fresh_us.items():
        entry = table.get("entries", {}).get(key)
        if entry:
            ratios.append(us / entry["us"][entry["backend"]])
    if not ratios:
        return 1.0
    return statistics.median(ratios)


# ---------------------------------------------------------------------------
# observability counters
# ---------------------------------------------------------------------------

_COUNTERS = {"hits": 0, "misses": 0, "measure_calls": 0, "table_errors": 0}
_WARNED_PATHS: set[str] = set()


def counters() -> dict[str, int]:
    """Table hits and misses, in-process races and rejected tables, each
    counted once per unique resolution (requests memoize)."""
    return dict(_COUNTERS)


def counters_clear() -> None:
    for k in _COUNTERS:
        _COUNTERS[k] = 0


# ---------------------------------------------------------------------------
# measurement (warmup + median-of-k race)
# ---------------------------------------------------------------------------

def available_backends(target: Target) -> tuple[str, ...]:
    """Backends this process can execute for ``target``: pallas/xla
    always; the chip-level schedules only when ``parallel.mesh`` counts
    enough logical devices to build the target mesh.  A hierarchical
    target needs ``dp * tp`` disjoint inner meshes for its chip backends
    (delegated to ``hierarchy.hierarchical_available_backends``)."""
    import math

    from repro_torch.parallel import mesh

    if getattr(target, "outer_shape", None) is not None:
        from .hierarchy import hierarchical_available_backends

        return hierarchical_available_backends(target)
    avail = ["pallas", "xla"]
    if mesh.local_device_count() >= math.prod(target.mesh_shape) \
            and len(target.mesh_shape) >= 2:
        avail += ["systolic", "allgather"]
    return tuple(avail)


def _mesh(target: Target, device: str):
    """The target's (R, C) mesh over ``device``'s logical devices, for the
    chip-level backends of a race."""
    import torch

    from repro_torch.parallel import mesh

    return mesh.make_mesh(tuple(target.mesh_shape[:2]),
                          tuple(target.mesh_axes[:2]),
                          mesh.devices(torch.device(device).type))


def _time_backend(fn, operands, *, warmup: int, reps: int,
                  device: str) -> float:
    """Median microseconds of ``fn(*operands)`` over ``reps`` calls after
    ``warmup`` untimed ones: CUDA events on the card, the host clock on
    the CPU."""
    import torch

    for _ in range(max(warmup, 1)):
        fn(*operands)
    samples = []
    cuda = torch.device(device).type == "cuda"
    for _ in range(max(reps, 1)):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*operands)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(*operands)
            samples.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(samples)


def _generator(device: str):
    import torch

    return torch.Generator(device=device).manual_seed(0)


def _timed(fns: dict, operands, policy: PlanPolicy, name: str) -> dict:
    """``{backend: µs}`` of each lowering in ``fns``.  Another backend
    that cannot lower or run this recurrence leaves the race with a
    warning, as in the reference; the hand kernel (``pallas``) raises:
    a race without it would stamp the plain version by default."""
    us: dict[str, float] = {}
    for backend, make in fns.items():
        try:
            us[backend] = round(_time_backend(
                make(), operands, warmup=policy.warmup, reps=policy.reps,
                device=policy.device), 1)
        except Exception as e:  # noqa: BLE001 - mirror the reference race
            if backend == "pallas":
                raise RuntimeError(
                    f"autotune race: the hand kernel failed for {name}: "
                    f"{type(e).__name__}: {e}") from e
            warnings.warn(f"autotune race: {backend} failed for {name}: "
                          f"{type(e).__name__}: {e}", stacklevel=3)
    if not us:
        raise RuntimeError(f"autotune race: no backend ran for {name}")
    return us


def _race_chain(chain, target: Target, policy: PlanPolicy,
                backends: tuple[str, ...] | None) -> dict:
    """Chain variant of ``race``: times the fused backends (the one-mesh
    schedule where the mesh and devices permit it, and the xla / pallas
    compositions) on seeded chain operands at the chain's real shapes."""
    from . import fusion

    _COUNTERS["measure_calls"] += 1
    run_dtype = exec_dtype(chain.stages[0].name, chain.dtype)
    exec_chain = (chain if run_dtype == chain.dtype
                  else chain.with_dtype(run_dtype))
    plan = fusion.fuse(exec_chain, target)  # FusionError propagates
    operands = fusion.chain_operands(exec_chain, _generator(policy.device),
                                     device=policy.device)
    avail = backends or fusion.fused_available_backends(plan)
    mesh = (_mesh(target, policy.device) if "fused_systolic" in avail
            else None)
    us = _timed({b: functools.partial(fusion.lower_fused, plan, b,
                                      mesh=mesh)
                 for b in avail}, operands, policy, f"chain {chain.name}")
    return {
        "backend": min(us, key=us.get),
        "us": us,
        "measured_shape": [list(s.extents) for s in exec_chain.stages],
        "measured_dtype": run_dtype,
    }


def race(rec, target: Target,
         policy: PlanPolicy = PlanPolicy(mode="measured"),
         backends: tuple[str, ...] | None = None) -> dict:
    """Race the available backend lowerings of ``rec`` on seeded operands
    on ``policy.device``.

    Returns a table entry: ``{"backend": winner, "us": {backend: µs},
    "measured_shape": extents, "measured_dtype": dtype}``.  Dtypes the
    race does not execute as declared race as their ``exec_dtype``.  A
    ``fusion.RecurrenceChain`` races its fused backends instead; a
    hierarchical ``target`` races the backends of its modelled
    ``HierarchicalPlan`` (``HierarchyError`` where no split is legal)."""
    if hasattr(rec, "stages"):
        return _race_chain(rec, target, policy, backends)
    from repro_torch.kernels import registry

    from .codegen import lower_plan
    from .mapper import best_plan

    _COUNTERS["measure_calls"] += 1
    run_dtype = exec_dtype(rec.name, rec.dtype)
    exec_rec = (rec if run_dtype == rec.dtype
                else dataclasses.replace(rec, dtype=run_dtype))
    # the modelled plan's tiles; for a hierarchical target its split and
    # the groups' inner plan
    plan = best_plan(exec_rec, target)
    operands = registry.operands(exec_rec, _generator(policy.device),
                                 policy.device)
    avail = backends or available_backends(target)
    mesh = None
    if (any(b in ("systolic", "allgather") for b in avail)
            and getattr(target, "outer_shape", None) is None):
        # hierarchical plans build their own per-group inner meshes in
        # lower_hierarchical; only flat chip schedules need one here
        mesh = _mesh(target, policy.device)
    us = _timed({b: functools.partial(lower_plan, plan, b, mesh=mesh)
                 for b in avail}, operands, policy, rec.name)
    return {
        "backend": min(us, key=us.get),
        "us": us,
        "measured_shape": list(rec.extents),
        "measured_dtype": run_dtype,
    }


# ---------------------------------------------------------------------------
# the policy hook mapper.best_plan calls
# ---------------------------------------------------------------------------

def apply_policy(plan, policy: PlanPolicy):
    """Stamp a modelled plan with the policy's backend decision.

    ``cached``: a table hit stamps the measured winner (clamped to the
    backends this process can execute, by stored timings); a miss leaves
    the modelled plan and times nothing.  ``measured``: a miss is raced
    and, with a ``table_path``, persisted.  Any table failure counts as a
    miss (one warning per path)."""
    if policy.mode == "modelled":
        return plan
    key = autotune_key(plan.recurrence, plan.target.mesh_shape,
                       outer_shape=getattr(plan.target, "outer_shape", None))
    path = policy.path()
    table: dict | None
    try:
        table = load_table(path)
    except TableError as e:
        table = None
        _COUNTERS["table_errors"] += 1
        if str(path) not in _WARNED_PATHS:
            _WARNED_PATHS.add(str(path))
            warnings.warn(
                f"autotune: rejecting table ({e}); planning falls back "
                "to the modelled choice", stacklevel=2)
    entry = (table or {}).get("entries", {}).get(key)
    if entry is not None:
        _COUNTERS["hits"] += 1
    else:
        _COUNTERS["misses"] += 1
        if policy.mode == "measured":
            entry = race(plan.recurrence, plan.target, policy)
            if policy.table_path is not None:
                import copy

                # load_table memoizes by (path, mtime): never mutate it
                table = (copy.deepcopy(table) if table is not None
                         else new_table("measured in-process by the port's "
                                        "core/autotune.py"))
                table.setdefault("entries", {})[key] = entry
                save_table(path, table)
    if entry is None:
        return plan
    backend = entry["backend"]
    if hasattr(plan, "chain"):  # FusedPlan: clamp to the fused backends
        from . import fusion

        runnable = set(fusion.fused_available_backends(plan))
    else:
        # flat and hierarchical plans alike: available_backends
        # dispatches on the target kind
        runnable = set(available_backends(plan.target))
    if backend not in runnable:
        timed = {b: u for b, u in entry["us"].items() if b in runnable}
        backend = (min(timed, key=timed.get) if timed
                   else plan.backend)
    return dataclasses.replace(plan, backend=backend,
                               provenance="measured")


# ---------------------------------------------------------------------------
# default-table generation (driven by launch/gen_autotune.py)
# ---------------------------------------------------------------------------

def build_default_table(meshes: tuple[tuple[int, ...], ...] = ((1, 1), (1, 8)),
                        policy: PlanPolicy = PlanPolicy(mode="measured"),
                        verbose: bool = True,
                        extra_cases: tuple = (),
                        chain_cases: tuple = (),
                        note: str = "") -> dict:
    """Measure a crossover table covering every registered spec's smoke
    and bench cases (``registry.autotune_cases``) for ``meshes``, raced at
    each spec's smoke proxy on ``policy.device``; ``extra_cases`` (the
    serving census, ``(kind, builder_args, dtype)``) are keyed at their
    real shapes and raced at the proxy too; ``chain_cases`` (fused chains,
    ``(kind, per_stage_args, dtype)``) race at their real shapes, skipped
    on meshes where the chain does not fuse.  ``note`` goes into the
    table."""
    from repro_torch.kernels import registry

    from . import fusion

    table = new_table(note or (
        "the port's crossover table: winners measured at each spec's "
        "smoke proxy shape; regenerate with python -m "
        "repro_torch.launch.gen_autotune"))
    proxy_cache: dict[tuple[str, str], dict] = {}

    def proxy_entries(spec, run_dtype: str) -> dict:
        cache_key = (spec.name, run_dtype)
        if cache_key not in proxy_cache:
            for mesh_shape in meshes:
                target = Target(name=f"autotune_{mesh_shape}",
                                mesh_shape=mesh_shape)
                proxy = spec.builder(*spec.smoke_args, run_dtype)
                entry = race(proxy, target, policy)
                proxy_cache.setdefault(cache_key, {})[mesh_shape] = entry
            if verbose:
                e = proxy_cache[cache_key][meshes[0]]
                print(f"  raced {spec.name:13s} {run_dtype:8s} "
                      f"-> {e['backend']:6s} {e['us']}", flush=True)
        return proxy_cache[cache_key]

    cases = [(spec.name, args, dtype) for spec in registry.specs()
             for dtype, args in registry.autotune_cases(spec)]
    for kind, args, dtype in (*cases, *extra_cases):
        spec = registry.get(kind)
        entries = proxy_entries(spec, exec_dtype(kind, dtype))
        for mesh_shape in meshes:
            key = autotune_key(spec.builder(*args, dtype), mesh_shape)
            table["entries"][key] = dict(entries[mesh_shape])
    for kind, shapes, dtype in chain_cases:
        chain = fusion.chain_from_request(kind, shapes, dtype)
        for mesh_shape in meshes:
            target = Target(name=f"autotune_{mesh_shape}",
                            mesh_shape=mesh_shape)
            try:
                entry = race(chain, target, policy)
            except fusion.FusionError as e:
                if verbose:
                    print(f"  chain {kind} skipped on mesh "
                          f"{mesh_shape}: [{e.reason}]", flush=True)
                continue
            table["entries"][autotune_key(chain, mesh_shape)] = entry
            if verbose:
                print(f"  raced chain {kind:20s} {dtype:8s} mesh"
                      f"{mesh_shape} -> {entry['backend']} "
                      f"{entry['us']}", flush=True)
    return table
