"""The port's crossover table and plan policies against the JAX package's.

* ``autotune_key``/``request_key`` give the reference's strings for every
  registry case (``registry.autotune_cases``) and every serving-census
  case (the port's ``launch.gen_autotune.serving_cases`` equals the
  reference's ``tools/gen_autotune.py`` census) on both keyed meshes.
* ``load_table`` rejects the same corrupt, schema-mismatched and
  malformed tables with the same ``TableError``; ``machine_factor``
  gives the same value on the same dicts.
* ``cached`` policy on one synthetic table: every plan's backend and
  provenance equal the reference's (chip-level winners served at 1 x 1,
  one clamped by its stored timings at 1 x 8, a fused chain, a miss),
  and so do the hit and miss counters; ``measured`` mode persists an
  entry with the reference's fields and serves it back; a race's
  candidates are the reference's (the chip-level schedules at 1 x 1);
  the facade clamps a chip-level winner to ``xla``.
* The committed table covers every key, times the reference's backends
  at each, names its card, and each race ran on a dtype its kernel takes.
* A race the hand kernel cannot enter raises; the generator writes no
  table that lacks its timing.
"""

import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from repro.core import Target as JaxTarget  # noqa: E402
from repro.core import autotune as jat  # noqa: E402
from repro.core import best_plan as jax_best_plan  # noqa: E402
from repro.core import fusion as jfusion  # noqa: E402
from repro.kernels import registry as jreg  # noqa: E402
from repro_torch.core import Target, best_plan  # noqa: E402
from repro_torch.core import autotune as tat  # noqa: E402
from repro_torch.core import fusion  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.launch import gen_autotune  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((1, 1), (1, 8))


def _reference_census():
    spec = importlib.util.spec_from_file_location(
        "ref_gen_autotune", ROOT / "tools" / "gen_autotune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.serving_cases()


@pytest.fixture(scope="module")
def census():
    return gen_autotune.serving_cases(), _reference_census()


def _registry_cases():
    return [(spec.name, args, dtype) for spec in treg.specs()
            for dtype, args in treg.autotune_cases(spec)]


def test_registry_cases_equal_the_reference():
    assert _registry_cases() == [
        (spec.name, args, dtype) for spec in jreg.specs()
        for dtype, args in jreg.autotune_cases(spec)]


def test_keys_equal_the_reference_for_every_case(census):
    (extra, chains), (jextra, jchains) = census
    assert sorted(extra) == sorted(jextra) and extra
    assert sorted(chains) == sorted(jchains) and chains
    keys = set()
    for mesh in MESHES:
        target = Target(name="t", mesh_shape=mesh)
        jtarget = JaxTarget(name="t", mesh_shape=mesh)
        for kind, args, dtype in (*_registry_cases(), *extra, *chains):
            req = tat.PlanRequest(kind, args, dtype, target)
            jreq = jat.PlanRequest(kind, args, dtype, jtarget)
            key = tat.request_key(req)
            assert key == jat.request_key(jreq)
            if "+" in kind:
                rec = fusion.chain_from_request(kind, args, dtype)
            else:
                rec = treg.get(kind).builder(*args, dtype)
            assert tat.autotune_key(rec, mesh) == key
            keys.add(key)
    keys |= _hier_keys(extra)
    reference = json.loads((ROOT / "src/repro/core/default_autotune.json")
                           .read_text())["entries"]
    assert keys == set(reference)
    assert sum("|outer1x2|mesh1x8" in k for k in keys) == 11


def _hier_keys(extra) -> set:
    """The five-field keys of the single-GEMM census cases with a legal
    split under the serving hierarchical target, each equal to the
    reference's ``request_key``."""
    from repro.core import SERVING_HIERARCHICAL_TARGET as JHT
    from repro.core.hierarchy import HierarchyError as JHierarchyError
    from repro_torch.core import SERVING_HIERARCHICAL_TARGET as HT
    from repro_torch.core.hierarchy import HierarchyError, plan_hierarchy

    keys = set()
    for kind, args, dtype in extra:
        rec = treg.get(kind).builder(*args, dtype)
        try:
            plan_hierarchy(rec, HT)
        except HierarchyError:
            with pytest.raises(JHierarchyError):
                jax_best_plan(jreg.get(kind).builder(*args, dtype), JHT)
            continue
        key = tat.request_key(tat.PlanRequest(kind, args, dtype, HT))
        assert key == jat.request_key(jat.PlanRequest(kind, args, dtype, JHT))
        keys.add(key)
    return keys


def test_committed_table_covers_every_key_and_names_its_card(census):
    table = tat.load_table(tat.DEFAULT_TABLE_PATH)
    (extra, chains), _ = census
    want = {tat.request_key(tat.PlanRequest(kind, args, dtype,
                                            Target(name="t", mesh_shape=m)))
            for m in MESHES
            for kind, args, dtype in (*_registry_cases(), *extra, *chains)}
    assert want | _hier_keys(extra) == set(table["entries"])
    assert "H100" in table["note"] and " W" in table["note"]
    reference = jat.load_table(jat.DEFAULT_TABLE_PATH)["entries"]
    for key, entry in table["entries"].items():
        # the reference's backends at every key it has: the chip-level
        # ones at mesh1x1, where one device builds the mesh
        want = (set(reference[key]["us"]) if key in reference
                else {"pallas", "xla"})
        assert set(entry["us"]) == want, key
        assert entry["backend"] == min(entry["us"], key=entry["us"].get)
        assert set(entry) == {"backend", "us", "measured_shape",
                              "measured_dtype"}


def _entry(backend="pallas", us=None):
    return {"backend": backend,
            "us": us if us is not None else {backend: 10.0}}


BAD_TABLES = [
    "{not json",
    json.dumps([1, 2, 3]),
    json.dumps({"schema": 99, "entries": {}}),
    json.dumps({"schema": 1}),
    json.dumps({"schema": 1, "entries": {"k": 3}}),
    json.dumps({"schema": 1, "entries": {"k": _entry(backend="vitis")}}),
    json.dumps({"schema": 1, "entries": {"k": {"backend": "pallas",
                                               "us": {"pallas": -1}}}}),
    json.dumps({"schema": 1, "entries": {"k": {"backend": "xla",
                                               "us": {"pallas": 3.0}}}}),
]


@pytest.mark.parametrize("payload", BAD_TABLES + [None],
                         ids=["corrupt", "list", "schema", "no-entries",
                              "entry-not-object", "stale-backend",
                              "bad-timing", "winner-untimed", "missing"])
def test_bad_tables_raise_the_references_error(tmp_path, payload):
    path = tmp_path / "table.json"
    if payload is not None:
        path.write_text(payload, encoding="utf-8")
    with pytest.raises(tat.TableError) as got:
        tat.load_table(path)
    with pytest.raises(jat.TableError) as want:
        jat.load_table(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fresh", [
    {"a": 20.0, "b": 200.0, "c": 80.0, "unshared": 1.0},
    {"a": 5.0, "b": 300.0},
    {"unshared": 1.0},
    {},
])
def test_machine_factor_equals_the_reference(fresh):
    table = {"entries": {"a": _entry("pallas", {"pallas": 10.0}),
                         "b": _entry("xla", {"xla": 100.0, "pallas": 9.0}),
                         "c": _entry("pallas", {"pallas": 40.0})}}
    assert tat.machine_factor(table, fresh) == jat.machine_factor(
        table, fresh)


#: (kind, builder args, dtype, mesh, stored entry or None for a miss)
POLICY_CASES = [
    ("mm", (256, 256, 256), "float32", (1, 8), _entry("xla", {
        "xla": 2.0, "pallas": 3.0})),
    ("bmm", (4, 128, 128, 64), "int8", (1, 8), _entry("pallas", {
        "xla": 2.5, "pallas": 1.0})),
    # mesh 1x1: one device builds it, so both packages serve the stored
    # chip-level winners there
    ("conv2d", (64, 61, 4, 4), "float32", (1, 1), _entry("systolic", {
        "systolic": 1.0, "xla": 7.0, "pallas": 3.0})),
    ("fir", (1024, 15), "float32", (1, 1), _entry("allgather", {
        "allgather": 1.0, "xla": 2.0, "pallas": 3.0})),
    # mesh 1x8 needs eight: a chip-level winner clamps by its timings
    ("jacobi2d", (126, 126), "float32", (1, 8), _entry("systolic", {
        "systolic": 1.0})),
    ("mm+mm", ((24, 128, 64), (24, 64, 128)), "float32", (1, 8), _entry(
        "pallas", {"xla": 2.0, "pallas": 1.0})),
    ("mm+mm", ((16, 128, 64), (16, 64, 128)), "float32", (1, 1), _entry(
        "fused_systolic", {"fused_systolic": 1.0, "xla": 2.0, "pallas": 3.0})),
    ("mttkrp", (128, 64, 16, 8), "float32", (1, 8), None),
]


def _plan(pkg, kind, args, dtype, mesh, policy):
    target = (Target if pkg is tat else JaxTarget)(name="t", mesh_shape=mesh)
    reg = treg if pkg is tat else jreg
    if "+" in kind:
        rec = (fusion if pkg is tat else jfusion).chain_from_request(
            kind, args, dtype)
    else:
        rec = reg.get(kind).builder(*args, dtype)
    plan = (best_plan if pkg is tat else jax_best_plan)(rec, target,
                                                        policy=policy)
    return plan.backend, plan.provenance


def test_cached_policy_stamps_and_counts_as_the_reference(tmp_path):
    path = tmp_path / "t.json"
    table = tat.new_table("synthetic")
    for kind, args, dtype, mesh, entry in POLICY_CASES:
        if entry is not None:
            key = tat.request_key(tat.PlanRequest(
                kind, args, dtype, Target(name="t", mesh_shape=mesh)))
            table["entries"][key] = entry
    tat.save_table(path, table)
    stamps = {}
    for pkg in (tat, jat):
        policy = pkg.PlanPolicy(mode="cached", table_path=str(path))
        before = pkg.counters()
        stamps[pkg] = [_plan(pkg, *case[:4], policy)
                       for case in POLICY_CASES]
        after = pkg.counters()
        stamps[pkg].append({k: after[k] - before[k] for k in after})
    assert stamps[tat] == stamps[jat]
    assert stamps[tat][2] == ("systolic", "measured")  # served at 1x1
    assert stamps[tat][3] == ("allgather", "measured")
    assert stamps[tat][4] == ("pallas", "measured")  # nothing runnable timed
    assert stamps[tat][6] == ("fused_systolic", "measured")
    assert stamps[tat][-2] == ("pallas", "modelled")  # a miss
    assert stamps[tat][-1] == {"hits": 7, "misses": 1, "measure_calls": 0,
                               "table_errors": 0}


def test_measured_mode_persists_the_references_fields(tmp_path):
    rec_args = ("mm", (24, 64, 64), "float32", (1, 8))
    fields = {}
    for pkg, kw in ((tat, {"device": "cpu"}), (jat, {})):
        path = tmp_path / f"{pkg.__name__}.json"
        policy = pkg.PlanPolicy(mode="measured", table_path=str(path),
                                reps=1, warmup=1, **kw)
        before = pkg.counters()["measure_calls"]
        backend, provenance = _plan(pkg, *rec_args, policy)
        assert provenance == "measured"
        assert pkg.counters()["measure_calls"] == before + 1
        table = json.loads(path.read_text())
        (key, entry), = table["entries"].items()
        assert entry["backend"] == backend
        assert entry["backend"] == min(entry["us"], key=entry["us"].get)
        fields[pkg] = (key, sorted(entry), sorted(entry["us"]),
                       entry["measured_shape"], entry["measured_dtype"],
                       sorted(table))
        cached = pkg.PlanPolicy(mode="cached", table_path=str(path))
        assert _plan(pkg, *rec_args, cached) == (backend, "measured")
        assert pkg.counters()["measure_calls"] == before + 1
    assert fields[tat] == fields[jat]


def test_race_times_both_backends_and_chains_on_the_cpu():
    policy = tat.PlanPolicy(mode="measured", reps=1, warmup=1,
                            device="cpu")
    target = Target(name="t", mesh_shape=(1, 8))
    spec = treg.get("jacobi2d_ms")
    entry = tat.race(spec.builder(*spec.smoke_args, "int32"), target, policy)
    assert set(entry["us"]) == {"pallas", "xla"}
    assert entry["measured_dtype"] == "int16"
    chain = fusion.chain_from_request(
        "mm+mm", ((16, 128, 64), (16, 64, 128)), "float32")
    entry = tat.race(chain, target, policy)
    assert set(entry["us"]) == {"pallas", "xla"}
    assert entry["measured_shape"] == [[16, 128, 64], [16, 64, 128]]


def test_every_case_races_on_a_dtype_its_kernel_takes():
    for kind, _, dtype in _registry_cases():
        assert tat.exec_dtype(kind, dtype) in treg.get(kind).parity_dtypes
    # no integer DFT matrices: cint16 runs on the float32 real planes
    assert tat.exec_dtype("fft2d_stage", "cint16") == "float32"
    assert tat.exec_dtype("mm", "int32") == tat.EXEC_DTYPE["int32"]
    table = tat.load_table(tat.DEFAULT_TABLE_PATH)
    for key, entry in table["entries"].items():
        kind = key.split("|")[0].split("+")[0]
        assert entry["measured_dtype"] in treg.get(kind).parity_dtypes, key


@pytest.mark.parametrize("broken", ["pallas", "xla", "systolic"])
def test_only_the_plain_version_may_leave_the_race(monkeypatch, broken):
    """The hand kernel cannot leave the race; the plain version and the
    chip-level schedules can, with a warning, as in the reference."""
    from repro_torch.core import codegen

    lower = codegen.lower_plan

    def lower_plan(plan, backend, mesh=None):
        if backend == broken:
            raise ValueError("no lowering")
        return lower(plan, backend, mesh=mesh)

    monkeypatch.setattr(codegen, "lower_plan", lower_plan)
    policy = tat.PlanPolicy(mode="measured", reps=1, warmup=1,
                            device="cpu")
    spec = treg.get("fir")
    rec = spec.builder(*spec.smoke_args, "float32")
    target = Target(name="t", mesh_shape=(1, 1))
    if broken == "pallas":
        with pytest.raises(RuntimeError, match="hand kernel failed"):
            tat.race(rec, target, policy)
    else:
        with pytest.warns(UserWarning, match=f"{broken} failed"):
            entry = tat.race(rec, target, policy)
        assert set(entry["us"]) == {"pallas", "xla", "systolic",
                                    "allgather"} - {broken}
        assert entry["backend"] == min(entry["us"], key=entry["us"].get)


@pytest.mark.parametrize("mesh", [(1, 1), (1, 8)])
def test_race_candidates_equal_the_references(mesh):
    """On one device both packages race the chip-level schedules at a
    1 x 1 mesh (a fused chain's one-mesh schedule too) and not at 1 x 8."""
    spec, jspec = treg.get("conv2d"), jreg.get("conv2d")
    kinds = {}
    for pkg, target, rec, chain in (
            (tat, Target(name="t", mesh_shape=mesh),
             spec.builder(*spec.smoke_args, "int16"),
             fusion.chain_from_request(
                 "mm+mm", ((16, 128, 64), (16, 64, 128)), "float32")),
            (jat, JaxTarget(name="t", mesh_shape=mesh),
             jspec.builder(*jspec.smoke_args, "int16"),
             jfusion.chain_from_request(
                 "mm+mm", ((16, 128, 64), (16, 64, 128)), "float32"))):
        policy = pkg.PlanPolicy(mode="measured", reps=1, warmup=1,
                                **({"device": "cpu"} if pkg is tat else {}))
        kinds[pkg] = (sorted(pkg.race(rec, target, policy)["us"]),
                      sorted(pkg.race(chain, target, policy)["us"]))
    assert kinds[tat] == kinds[jat]
    chip = mesh == (1, 1)
    assert ("systolic" in kinds[tat][0]) == chip
    assert ("fused_systolic" in kinds[tat][1]) == chip


def test_facade_clamps_a_chip_level_winner_to_xla():
    """A hierarchical plan or a fused pair stamped with a chip-level
    winner runs the plain composition in the facade, as the reference's
    ``_execute`` / ``_execute_pair`` do."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from repro.core import HierarchicalTarget as JHT
    from repro.kernels import planned as jplanned
    from repro_torch.core import HierarchicalTarget
    from repro_torch.kernels import planned

    rng = np.random.default_rng(5)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    w = rng.standard_normal((64, 128)).astype(np.float32)
    w2 = rng.standard_normal((128, 64)).astype(np.float32)
    bias = rng.standard_normal((128,)).astype(np.float32)
    inner = (1, 8)
    plans = {}
    for pkg, ht, reg in ((planned, HierarchicalTarget(
            name="h", outer_shape=(1, 2), inner=Target(
                name="c", mesh_shape=inner)), treg),
            (jplanned, JHT(name="h", outer_shape=(1, 2), inner=JaxTarget(
                name="c", mesh_shape=inner)), jreg)):
        bp = best_plan if pkg is planned else jax_best_plan
        plans[pkg] = dataclasses.replace(
            bp(reg.get("mm").builder(16, 128, 64, "float32"), ht),
            backend="systolic")
    got = planned._execute(plans[planned], torch.from_numpy(x),
                           torch.from_numpy(w))
    want = jplanned._execute(plans[jplanned], jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    pair = dataclasses.replace(fusion.fuse(
        fusion.chain_from_request("mm+mm", ((16, 128, 64), (16, 64, 128)),
                                  "float32"), Target(mesh_shape=(1, 1))),
        backend="fused_systolic")
    jpair = dataclasses.replace(jfusion.fuse(
        jfusion.chain_from_request("mm+mm", ((16, 128, 64), (16, 64, 128)),
                                   "float32"), JaxTarget(mesh_shape=(1, 1))),
        backend="fused_systolic")
    got = planned._execute_pair(pair, "gelu", *(torch.from_numpy(a) for a in
                                                (x, w, bias, w2)))
    want = jplanned._execute_pair(jpair, "gelu", *(jnp.asarray(a) for a in
                                                   (x, w, bias, w2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_generator_writes_no_table_without_the_hand_kernels_timing(
        tmp_path, monkeypatch):
    table = tat.new_table("t")
    table["entries"]["mm|float32|256x256x256|mesh1x1"] = {
        "backend": "xla", "us": {"xla": 1.0},
        "measured_shape": [256, 256, 256], "measured_dtype": "float32"}
    monkeypatch.setattr(tat, "build_default_table", lambda **kw: table)
    out = tmp_path / "table.json"
    with pytest.raises(SystemExit, match="no timing"):
        gen_autotune.main(["--device", "cpu", "--no-serving",
                           "--out", str(out)])
    assert not out.exists()


def test_generator_refuses_hierarchy_and_planning_refuses_outer_targets(
        tmp_path, monkeypatch):
    """Despite the name, nothing here is refused any more:
    ``--no-hierarchy`` writes no two-level key and the default
    ``--hierarchy`` writes the five-field keys of the census cases with a
    legal split (skipping those without); a hierarchical target's
    backends on one device are the single-device pair, and the
    chip-level lowering of a two-level plan raises for want of its 16
    devices."""
    from repro_torch.core import SERVING_HIERARCHICAL_TARGET as HT
    from repro_torch.core import lower_plan

    cases = (("mm", (24, 128, 64), "float32"),
             ("mm", (3, 5, 7), "float32"),           # no legal split
             ("mm+mm", ((8, 16, 8), (8, 8, 16)), "float32"))
    table = tat.new_table("t")
    table["entries"]["mm|float32|256x256x256|mesh1x1"] = {
        "backend": "pallas", "us": {"pallas": 2.0, "xla": 1.0},
        "measured_shape": [256, 256, 256], "measured_dtype": "float32"}
    monkeypatch.setattr(tat, "build_default_table",
                        lambda **kw: json.loads(json.dumps(table)))
    monkeypatch.setattr(gen_autotune, "serving_cases",
                        lambda: (cases[:2], cases[2:]))
    flat, hier = tmp_path / "flat.json", tmp_path / "hier.json"
    gen_autotune.main(["--device", "cpu", "--no-serving", "--no-hierarchy",
                       "--out", str(flat)])
    assert set(tat.load_table(flat)["entries"]) == set(table["entries"])
    gen_autotune.main(["--device", "cpu", "--no-serving", "--out", str(hier),
                       "--reps", "1", "--warmup", "1"])
    entries = tat.load_table(hier)["entries"]
    assert set(entries) == {*table["entries"],
                            "mm|float32|24x128x64|outer1x2|mesh1x8"}
    assert set(entries["mm|float32|24x128x64|outer1x2|mesh1x8"]["us"]) == \
        {"pallas", "xla"}
    assert tat.available_backends(HT) == ("pallas", "xla")
    plan = best_plan(treg.get("mm").builder(24, 128, 64, "float32"), HT)
    with pytest.raises(RuntimeError, match="16 devices needed"):
        lower_plan(plan, "systolic")
