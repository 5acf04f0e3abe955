"""The port's two-level planner and its composition against the JAX
package's ``repro.core.hierarchy``.

* ``best_plan(rec, HierarchicalTarget)``: the same split, sub-extents,
  outer bytes, modelled times (relative 1e-12) and inner plan as the
  reference's, for mm, bmm and the single-sweep stars at qwen1.5-0.5b's
  SMOKE and full-width serving shapes, the reference bench's
  ``CI_HIERARCHY_CASES`` and the stencils' bench sizes, on outer meshes
  (1, 2), (2, 1), (2, 2) and (4, 2).
* The typed rejections, chains ``unsupported``, the byte models, the
  five-field keys, ``resolve`` giving None.
* ``lower_hierarchical`` on the plain versions (both backends on the CPU)
  against the reference's ``xla`` composition for every split: int16 bit
  for bit, float32 within the registry's ``atol``; the serving layouts
  (the tied lm_head's B, a row split's A) in place.
* The facade under ``planned.override(target=...)``: every site's
  decisions, reasons, shapes and ``last_plan`` equal to the reference's
  (the reference counts once per trace, the port every call), the MLP pair's
  per-stage fallback; the slot and paged engines' greedy tokens under
  the serving target equal to the reference engine's.
* ``gen_autotune --hierarchy --merge`` writes the reference's keys.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import HierarchicalTarget as JHT  # noqa: E402
from repro.core import PlanPolicy as JPolicy  # noqa: E402
from repro.core import Target as JTarget  # noqa: E402
from repro.core import autotune as jat  # noqa: E402
from repro.core import best_plan as jbest_plan  # noqa: E402
from repro.core import hierarchy as jh  # noqa: E402
from repro.core import lower_plan as jlower_plan  # noqa: E402
from repro.core.recurrence import JACOBI2D_9PT_OFFSETS  # noqa: E402
from repro.core.recurrence import JACOBI2D_OFFSETS  # noqa: E402
from repro.kernels import registry as jreg  # noqa: E402
from repro.parallel import collectives as jcoll  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (HierarchicalPlan, HierarchicalTarget,  # noqa: E402
                              HierarchyError, PlanPolicy, Target, best_plan,
                              lower_plan)
from repro_torch.core import SERVING_HIERARCHICAL_TARGET as HT  # noqa: E402
from repro_torch.core import autotune as tat  # noqa: E402
from repro_torch.core import hierarchy  # noqa: E402
from repro_torch.core.roofline import collective_time_s  # noqa: E402
from repro_torch.kernels import planned, ref  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402

INNER = Target(name="planned_chip", mesh_shape=(1, 8))
JINNER = JTarget(name="planned_chip", mesh_shape=(1, 8))
OUTERS = ((1, 2), (2, 1), (2, 2), (4, 2))
MODELLED = PlanPolicy(mode="modelled")
JMODELLED = JPolicy(mode="modelled")


def _targets(outer):
    return (HierarchicalTarget(outer_shape=outer, inner=INNER),
            JHT(outer_shape=outer, inner=JINNER))


def _full_width_cases():
    """qwen1.5-0.5b's serving GEMMs at full width: 4-lane decode and
    prompts of 9, 127 and 512 tokens (projections, the tied lm_head, the
    scores and values), decode over a 528-row cache."""
    cfg = get_config("qwen1.5-0.5b")
    d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.vocab
    heads, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    cases = []
    for m in (4, 9, 127, 512):
        cases += [("mm", (m, d, d)), ("mm", (m, ff, d)), ("mm", (m, d, ff)),
                  ("mm", (m, vocab, d))]
    for p in (9, 127, 512):
        cases += [("bmm", (heads, p, p, hd)), ("bmm", (heads, p, hd, p))]
    cases += [("bmm", (4 * heads, 1, 528, hd)),
              ("bmm", (4 * heads, 1, hd, 528))]
    return [(kind, shape, "bfloat16") for kind, shape in cases]


def _smoke_cases():
    """The serving census of qwen1.5-0.5b's and whisper-base's SMOKE (the
    facade's single GEMMs), and the reference bench's CI cases."""
    from benchmarks.run import CI_HIERARCHY_CASES
    from repro_torch.launch import gen_autotune

    extra, _ = gen_autotune.serving_cases()
    return sorted({*extra, *CI_HIERARCHY_CASES})


STENCIL_CASES = (("jacobi2d", (128, 128), "int16"),
                 ("jacobi2d_9pt", (64, 64), "float32"),
                 ("jacobi2d", (10238, 10238), "float32"),
                 ("jacobi2d_9pt", (10236, 10236), "float32"))


def _same_plan(plan, jplan):
    """The port's plan (or rejection reason) equal to the reference's."""
    assert isinstance(plan, HierarchicalPlan)
    assert plan.outer_split == jplan.outer_split
    assert plan.sub_recurrence.extents == jplan.sub_recurrence.extents
    assert plan.outer_bytes == jplan.outer_bytes
    assert plan.outer_us == pytest.approx(jplan.outer_us, rel=1e-12)
    assert plan.inner_us == pytest.approx(jplan.inner_us, rel=1e-12)
    inner, jinner = plan.inner_plan, jplan.inner_plan
    assert inner.partition.block == jinner.partition.block
    assert inner.partition.describe() == jinner.partition.describe()
    assert inner.schedule.describe() == jinner.schedule.describe()
    assert (inner.backend, inner.provenance) == (jinner.backend,
                                                 jinner.provenance)
    assert plan.describe() == jplan.describe()


def _compare(kind, shape, dtype, outer):
    ht, jht = _targets(outer)
    rec = treg.get(kind).builder(*shape, dtype)
    jrec = jreg.get(kind).builder(*shape, dtype)
    try:
        plan = best_plan(rec, ht)
    except HierarchyError as e:
        with pytest.raises(jh.HierarchyError) as je:
            jbest_plan(jrec, jht)
        assert e.reason == je.value.reason
        return None
    _same_plan(plan, jbest_plan(jrec, jht))
    return plan.outer_split


@pytest.mark.parametrize("outer", OUTERS, ids=lambda o: f"{o[0]}x{o[1]}")
@pytest.mark.parametrize("cases", ["smoke", "full_width", "stencils"])
def test_best_plan_equals_the_reference(cases, outer):
    table = {"smoke": _smoke_cases, "full_width": _full_width_cases,
             "stencils": lambda: STENCIL_CASES}[cases]()
    splits = [_compare(kind, shape, dtype, outer)
              for kind, shape, dtype in table]
    assert any(splits)


@pytest.mark.parametrize("build,reason", [
    (lambda ir: ir.matmul(127, 127, 127, "int16"), "outer-divisibility"),
    (lambda ir: ir.jacobi2d_9pt(4, 64, "int16"), "halo-exceeds-outer-shard"),
    (lambda ir: ir.jacobi2d(126, 126, "int16"), "outer-divisibility"),
    (lambda ir: ir.jacobi2d_multisweep(62, 62, 3, "int16"), "flow"),
    (lambda ir: ir.mttkrp(128, 64, 16, 8, "int16"), "unsupported"),
])
def test_typed_rejections_equal_the_reference(build, reason):
    from repro.core import recurrence as jir
    from repro_torch.core import recurrence as ir

    ht, jht = _targets((2, 2))
    with pytest.raises(HierarchyError) as exc:
        hierarchy.plan_hierarchy(build(ir), ht)
    with pytest.raises(jh.HierarchyError) as jexc:
        jh.plan_hierarchy(build(jir), jht)
    assert exc.value.reason == jexc.value.reason == reason
    assert str(exc.value) == str(jexc.value)


def test_chains_are_unsupported_and_resolve_to_none():
    from repro.core import fusion as jfusion
    from repro_torch.core import fusion

    ht, jht = _targets((2, 2))
    shapes = ((64, 128, 64), (64, 64, 128))
    with pytest.raises(HierarchyError) as exc:
        hierarchy.plan_hierarchy(
            fusion.chain_from_request("mm+mm", shapes, "int16"), ht)
    assert exc.value.reason == "unsupported"
    with pytest.raises(jh.HierarchyError):
        jh.plan_hierarchy(
            jfusion.chain_from_request("mm+mm", shapes, "int16"), jht)
    for kind, shape in (("mm+mm", shapes), ("mm", (127, 127, 127))):
        assert tat.resolve(tat.PlanRequest(kind, shape, "int16", ht,
                                           MODELLED)) is None
        assert jat.resolve(jat.PlanRequest(kind, shape, "int16", jht,
                                           JMODELLED)) is None


def test_byte_models_and_link_time_equal_the_reference():
    from repro.core.roofline import collective_time_s as jtime

    for payload in (0, 1, 100, 4096, 123457):
        for group in (0, 1, 2, 3, 4, 8):
            assert collectives.ring_allgather_bytes(payload, group) == \
                jcoll.ring_allgather_bytes(payload, group)
            assert collectives.ring_allreduce_bytes(payload, group) == \
                jcoll.ring_allreduce_bytes(payload, group)
            assert collectives.halo_exchange_bytes(payload, group) == \
                jcoll.halo_exchange_bytes(payload, group)
        assert collective_time_s(payload) == jtime(payload)
        assert collective_time_s(payload, 12.5) == jtime(payload, 12.5)
    assert hierarchy.halo_fits(2, 8, 4) and not hierarchy.halo_fits(2, 4, 4)


def test_targets_and_keys_equal_the_reference():
    from repro.core import SERVING_HIERARCHICAL_TARGET as JSERVE

    for field in ("name", "outer_shape", "outer_axes", "interconnect_gbps",
                  "mesh_shape", "mesh_axes", "groups", "n_devices"):
        assert getattr(HT, field) == getattr(JSERVE, field), field
    assert hierarchy.SPLITTABLE == jh.SPLITTABLE
    assert hierarchy.GEMM_SPLITS == jh.GEMM_SPLITS
    assert hierarchy.hierarchical_available_backends(HT) == \
        jh.hierarchical_available_backends(JSERVE)
    for outer in OUTERS:
        ht, jht = _targets(outer)
        for kind, shape in (("mm", (128, 128, 128)), ("bmm", (4, 8, 8, 16))):
            req = tat.PlanRequest(kind, shape, "int16", ht)
            key = tat.request_key(req)
            assert key == jat.request_key(jat.PlanRequest(kind, shape,
                                                          "int16", jht))
            assert key.split("|")[3] == f"outer{outer[0]}x{outer[1]}"
            assert len(key.split("|")) == 5


def test_resolve_none_counts_infeasible_at_the_facade():
    ht, _ = _targets((4, 2))
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -8, 8, (126, 126)).astype(np.int16))
    w = torch.from_numpy(np.random.default_rng(2).integers(
        -8, 8, (126, 127)).astype(np.int16))
    planned.planned_report_clear()
    with planned.override(enabled=True, target=ht, policy=MODELLED):
        got = planned.planned_dense(x, w, site="hier.fb")
    assert torch.equal(got, ref.mm(x, w))
    rep = planned.planned_report()["hier.fb"]
    assert (rep["planned"], rep["fallback"], rep["reasons"]) == \
        (0, 1, {"infeasible": 1})
    planned.planned_report_clear()


# -- lower_hierarchical against the reference's composition ---------------

SPLIT_CASES = (
    ("mm", (128, 128, 128), (2, 2), "column"),
    ("mm", (128, 127, 128), (2, 2), "row"),
    ("mm", (24, 128, 64), (1, 2), "column"),
    ("mm", (4, 51, 64), (1, 2), "row"),
    ("mm", (8, 64, 32), (4, 2), "column"),
    ("bmm", (4, 64, 64, 64), (2, 2), "batch"),
    ("bmm", (2, 64, 64, 63), (2, 2), "column"),
    ("bmm", (2, 64, 63, 64), (2, 2), "row"),
    ("bmm", (3, 12, 16, 12), (1, 2), "column"),
    ("bmm", (3, 12, 15, 12), (1, 2), "row"),
    ("jacobi2d", (128, 128), (2, 2), "halo"),
    ("jacobi2d_9pt", (64, 64), (2, 2), "halo"),
    ("jacobi2d", (126, 62), (2, 1), "halo"),
)


def _operands(kind, shape, dtype, rng):
    """Numpy operands of one case: mm's B as the transpose of a row-major
    [N, K] table (the tied lm_head's layout) where N is odd."""
    if dtype == "int16":
        def draw(s):
            return rng.integers(-8, 8, s).astype(np.int16)
    else:
        def draw(s):
            return rng.standard_normal(s).astype(np.float32)
    if kind == "mm":
        m, n, k = shape
        return draw((m, k)), (draw((n, k)).T if n % 2 else draw((k, n)))
    if kind == "bmm":
        b, m, n, k = shape
        return draw((b, m, k)), draw((b, k, n))
    pad = 1 if kind == "jacobi2d" else 2
    offsets = JACOBI2D_OFFSETS if pad == 1 else JACOBI2D_9PT_OFFSETS
    h, w = shape
    return draw((h + 2 * pad, w + 2 * pad)), draw((len(offsets),))


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("kind,shape,outer,split", SPLIT_CASES,
                         ids=[f"{c[0]}-{c[3]}-{c[2][0]}x{c[2][1]}"
                              for c in SPLIT_CASES])
def test_composition_equals_the_reference(kind, shape, outer, split, dtype):
    ht, jht = _targets(outer)
    plan = best_plan(treg.get(kind).builder(*shape, dtype), ht)
    jplan = jbest_plan(jreg.get(kind).builder(*shape, dtype), jht)
    assert plan.outer_split == jplan.outer_split == split
    ops = _operands(kind, shape, dtype, np.random.default_rng(7))
    want = np.asarray(jlower_plan(jplan, backend="xla")(
        *(jnp.asarray(o) for o in ops)))
    tops = [torch.from_numpy(np.ascontiguousarray(o.T)).T
            if o.ndim == 2 and not o.flags.c_contiguous
            else torch.from_numpy(o) for o in ops]
    flat = treg.get(kind).ref(*tops)
    for backend in ("xla", "pallas"):
        got = lower_plan(plan, backend)(*tops)
        assert got.dtype == flat.dtype and got.shape == flat.shape
        if dtype == "int16":
            assert np.array_equal(got.numpy(), want), backend
            assert torch.equal(got, flat), backend
        else:
            atol = treg.get(kind).atol
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=atol)


def test_row_split_sums_partials_before_the_cast():
    """bf16 row partials are summed in fp32 and rounded once; integer
    partials in int32 with wraparound, as the flat plan's sum."""
    ht, _ = _targets((1, 2))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 51)).astype(np.float32))
    plan = best_plan(treg.get("mm").builder(4, 51, 64, "bfloat16"), ht)
    assert plan.outer_split == "row"
    got = lower_plan(plan, "pallas")(x.bfloat16(), w.bfloat16())
    want = (x.bfloat16().float() @ w.bfloat16().float()).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    big = torch.full((2, 4), 2**30, dtype=torch.int32)
    ones = torch.ones((4, 3), dtype=torch.int32)
    plan = best_plan(treg.get("mm").builder(2, 3, 4, "int32"), ht)
    assert plan.outer_split == "row"
    assert torch.equal(lower_plan(plan, "pallas")(big, ones),
                       ref.mm(big, ones))


# -- the facade and the engines under the serving target -------------------

def _census_reports(arch):
    """Both facades' reports over one forward and loss of ``arch``'s SMOKE
    (tokens [2, 12]; whisper's frames [2, 8, d]) under the serving
    hierarchical target, modelled policy."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.core import SERVING_HIERARCHICAL_TARGET as JSERVE
    from repro.kernels import planned as jplanned
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model

    jcfg, cfg = jsmoke(arch), get_smoke_config(arch)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 12)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": toks}
    if not cfg.mlp_glu:
        batch["frames"] = np.random.default_rng(5).standard_normal(
            (2, 8, cfg.d_model)).astype(np.float32)
    jplanned.planned_report_clear()
    with jplanned.override(enabled=True, policy=JMODELLED, target=JSERVE):
        jloss = jbuild(jcfg).loss(jparams, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    jrep = jplanned.planned_report()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    planned.planned_report_clear()
    with torch.no_grad(), planned.override(enabled=True, policy=MODELLED,
                                           target=HT):
        loss = build_model(cfg, "cpu").loss(
            tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    rep = planned.planned_report()
    planned.planned_report_clear()
    return (float(loss), rep), (float(jloss), jrep)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-base"])
def test_facade_sites_decide_as_the_reference(arch):
    (loss, rep), (jloss, jrep) = _census_reports(arch)
    assert loss == pytest.approx(jloss, rel=1e-4)
    assert set(rep) == set(jrep)
    for site, st in rep.items():
        # the reference counts a call once per trace (its layers run in a
        # scan), the port on every call: what is compared is which
        # decisions each site made, on which shapes, and its last plan
        want = jrep[site]
        for field in ("planned", "fallback"):
            assert bool(st[field]) == bool(want[field]), (site, field)
            assert st[field] >= want[field], (site, field)
        for field in ("reasons", "backends", "shapes"):
            assert set(st[field]) == set(want[field]), (site, field)
        assert st["last_plan"] == want["last_plan"], site
        if st["planned"]:
            assert st["last_plan"].startswith("[hier "), site
    if arch == "whisper-base":
        # the MLP pair does not compose hierarchically: it falls back and
        # runs its per-stage calls, which do
        assert rep["mlp.pair"]["reasons"] == {"infeasible":
                                              rep["mlp.pair"]["fallback"]}
        assert rep["mlp.pair"]["planned"] == 0
        for stage in ("mlp.up", "mlp.down"):
            assert rep[stage]["planned"] == rep["mlp.pair"]["fallback"]
            assert "split=" in rep[stage]["last_plan"]


@pytest.fixture(scope="module")
def served():
    """qwen1.5-0.5b's SMOKE (float32 weights and cache) on the reference's
    slot engine and the port's slot and paged engines, all under the
    serving hierarchical target."""
    from repro.configs import get_smoke_config as jsmoke
    from repro.core import SERVING_HIERARCHICAL_TARGET as JSERVE
    from repro.models import build_model as jbuild
    from repro.serve import ServeEngine as JEngine
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.serve import make_engine

    arch = "qwen1.5-0.5b"
    jcfg, cfg = jsmoke(arch), get_smoke_config(arch)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(42))
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 13, 4, 17, 7)]

    def drain(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
        return {r.rid: list(r.output) for r in eng.run_until_drained(4000)}

    jeng = JEngine(jcfg, max_slots=4, max_seq=64, policy=JMODELLED,
                   target=JSERVE)
    jeng.load(jparams)
    want = drain(jeng)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    got, engines = {}, {}
    for kind, kw in (("slot", {"max_slots": 4}),
                     ("paged", {"max_lanes": 4, "block_size": 8})):
        eng = make_engine(cfg, kind=kind, max_seq=64, device="cpu",
                          policy=MODELLED, target=HT, **kw)
        eng.load(tparams)
        planned.planned_report_clear()
        got[kind] = drain(eng)
        engines[kind] = (eng, planned.planned_report())
    planned.planned_report_clear()
    return want, got, engines, jeng


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_engines_serve_the_reference_tokens(served, kind):
    want, got, engines, jeng = served
    assert got[kind] == want
    eng, drained = engines[kind]
    # the load window's plans and the drain's (the CPU's decode steps run
    # under the engine's target, as the card's captured step does)
    for report in (eng.plan_report, drained):
        assert report and all(st["last_plan"].startswith("[hier ")
                              and st["fallback"] == 0
                              for st in report.values())
    if kind == "slot":
        assert set(eng.plan_report) == set(jeng.plan_report)
    else:
        assert eng.stats["decode_compiles"] == 1
        assert {"attn.paged_scores", "attn.paged_values"} <= set(drained)


def test_engines_without_target_keep_the_ambient_one():
    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import make_engine

    eng = make_engine(get_smoke_config("qwen1.5-0.5b"), kind="slot",
                      max_slots=1, max_seq=16, device="cpu")
    assert eng.target is None
    with planned.override(target=HT):
        with eng._plan_ctx():
            assert planned.current_config().target == HT
    with eng._plan_ctx():
        assert planned.current_config().target is None


# -- the generator's two-level keys ------------------------------------------

def test_generator_merges_the_references_two_level_keys(tmp_path,
                                                        monkeypatch):
    from repro_torch.launch import gen_autotune

    cases = (("mm", (24, 128, 64), "float32"),
             ("bmm", (8, 12, 16, 12), "float32"),
             ("mm", (3, 5, 7), "float32"))
    monkeypatch.setattr(gen_autotune, "serving_cases", lambda: (cases, ()))
    path = tmp_path / "table.json"
    table = tat.new_table("a card note")
    table["entries"]["mm|float32|256x256x256|mesh1x1"] = {
        "backend": "xla", "us": {"pallas": 2.5, "xla": 1.25},
        "measured_shape": [256, 256, 256], "measured_dtype": "float32"}
    tat.save_table(path, table)
    before = json.loads(path.read_text())["entries"]
    gen_autotune.main(["--device", "cpu", "--hierarchy", "--merge", "--out",
                       str(path), "--reps", "1", "--warmup", "1"])
    entries = json.loads(path.read_text())["entries"]
    from repro.core import SERVING_HIERARCHICAL_TARGET as JSERVE

    want = set()
    for kind, args, dtype in cases:
        try:
            jh.plan_hierarchy(jreg.get(kind).builder(*args, dtype), JSERVE)
        except jh.HierarchyError:
            continue
        want.add(jat.request_key(jat.PlanRequest(kind, args, dtype, JSERVE)))
    assert want == {"mm|float32|24x128x64|outer1x2|mesh1x8",
                    "bmm|float32|8x12x16x12|outer1x2|mesh1x8"}
    assert set(entries) == set(before) | want
    for key, entry in before.items():
        assert json.dumps(entries[key], sort_keys=True) == \
            json.dumps(entry, sort_keys=True)
    for key in want:
        assert set(entries[key]["us"]) == {"pallas", "xla"}
        assert entries[key]["measured_shape"] == [
            int(x) for x in key.split("|")[2].split("x")]
    assert "two-level keys" in json.loads(path.read_text())["note"]


def test_b_layout_reads_group_slices_in_place():
    """What the GEMM kernels read B as (``runtime.b_layout``): a column
    split's slice of a row-major B keeps its rows' pitch, a row split's
    slice of a column-major B (the tied lm_head's ``embed.T``) its
    columns', a batched slice its batch stride; a layout without a unit
    stride is refused; contiguous B and its transpose read as before."""
    from repro_torch.kernels import runtime

    w = torch.zeros((64, 96), dtype=torch.bfloat16)
    embed = torch.zeros((95, 64), dtype=torch.bfloat16)
    assert runtime.b_layout(w) == (0, 96, 64 * 96)
    assert runtime.b_layout(embed.T) == (1, 64, 95 * 64)
    assert runtime.b_layout(w[:, 48:]) == (0, 96, 64 * 96)
    assert runtime.b_pitch(w[:, 48:]) == 96
    assert runtime.b_layout(embed.T[32:]) == (1, 64, 95 * 64)
    assert runtime.b_col_major(embed.T[32:]) == 1
    assert runtime.b_layout(w[:, ::2]) is None
    assert runtime.b_pitch(w[:, ::2]) is None and runtime.b_copy_bytes(
        w[:, ::2]) == 0
    batched = torch.zeros((3, 64, 96))
    assert runtime.b_layout(batched[:, :, 48:]) == (0, 96, 64 * 96)
    assert runtime.b_layout(batched.transpose(1, 2)[:, 32:]) == \
        (1, 96, 64 * 96)
    assert runtime.b_layout(batched[:, 32:]) == (0, 96, 64 * 96)
    # copies keep the row's length, the pitch and the batch stride aligned
    assert runtime.b_copy_bytes(w[:, 48:]) == 16
    assert runtime.b_copy_bytes(embed.T[32:]) == 16
    assert runtime.b_copy_bytes(w[:, 48:95]) < 4   # 47 bf16: 94 bytes
    assert runtime.b_copy_bytes(w[:, 2:50]) == 4   # base 4 bytes in
