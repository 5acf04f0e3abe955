"""The port's WideSA mapper -> kernel pipeline against the JAX package's,
for the star stencils (jacobi2d, jacobi2d_9pt, jacobi2d_ms) and mttkrp.

* The builders give the reference's IR, and ``best_plan`` the reference's
  plans (schedule, block, backend, ``feasible``, description) at the
  registry's smoke and bench sizes on the single-chip target, the 16 x 16
  ``Target()`` and the VCK5000 ``AIE_TARGET``; ``predict_bounds`` equals
  the reference's for every ``PAPER_BENCHMARKS`` entry.
* On the CPU the wrappers run their plain versions (``ref.py``).  The
  port's ``execute_plan`` / ``lower_plan(plan, "pallas")`` is held
  against the reference's ``execute_plan``, which runs the Pallas
  kernels in interpret mode, on the same numpy operands (full-range
  integers, so int32 wraparound is exercised), at the smoke sizes and at
  ragged ones, in every parity dtype and int32 for jacobi2d_ms: integers
  bit-exact, float32 within the registry's atol 1e-3 (sums of at most
  128 products in another order).  The plain versions equal the
  reference's oracles (``repro.kernels.ref``) within 1e-5 in float32.
* A ``conv2d -> jacobi2d`` halo chain gets the reference's fusion verdict
  and result, and illegal halo chains the reference's typed rejection.
* ``python -m repro_torch.launch.recurrences --device cpu`` runs to its
  end.

The kernels themselves run only on the card: ``tests/test_torch_gpu.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import AIE_TARGET as JAX_AIE  # noqa: E402
from repro.core import Target as JaxTarget  # noqa: E402
from repro.core import best_plan as jax_best_plan  # noqa: E402
from repro.core import fusion as jax_fusion  # noqa: E402
from repro.core import plio as jax_plio  # noqa: E402
from repro.core.mapper import predict_bounds as jax_predict_bounds  # noqa: E402
from repro.core.recurrence import PAPER_BENCHMARKS as JAX_PAPER  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.kernels.runtime import execute_plan as jax_execute  # noqa: E402
from repro_torch.core import (AIE_TARGET, PAPER_BENCHMARKS, Target,  # noqa: E402
                              best_plan, fusion, lower_plan, plio,
                              predict_bounds)
from repro_torch.kernels import (build, jacobi2d, mttkrp, ref,  # noqa: E402
                                 registry, runtime)
from repro_torch.launch import recurrences  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NEW = ("jacobi2d", "jacobi2d_9pt", "jacobi2d_ms", "mttkrp")
SINGLE_CHIP = Target(name="single_chip", mesh_shape=(1, 1))
JAX_SINGLE_CHIP = JaxTarget(name="single_chip", mesh_shape=(1, 1))
TARGETS = {"single_chip": (SINGLE_CHIP, JAX_SINGLE_CHIP),
           "tpu_16x16": (Target(), JaxTarget()),
           "vck5000": (AIE_TARGET, JAX_AIE)}

#: builder arguments whose outputs are no multiple of any plan or compiled
#: tile
RAGGED = {"jacobi2d": (61, 59), "jacobi2d_9pt": (37, 70),
          "jacobi2d_ms": (45, 33, 4), "mttkrp": (37, 45, 7, 5)}


def _plan_cases():
    for name in NEW:
        spec = jax_registry.get(name)
        cases = ((spec.parity_dtypes[0], spec.smoke_args), *spec.bench_cases)
        for dtype, args in cases:
            for target in TARGETS:
                yield pytest.param(
                    name, dtype, args, target,
                    id=f"{name}-{dtype}-{'x'.join(map(str, args))}-{target}")


@pytest.mark.parametrize("name,dtype,args,target", list(_plan_cases()))
def test_plans_match_reference(name, dtype, args, target):
    port_target, jax_target = TARGETS[target]
    rec = registry.get(name).builder(*args, dtype)
    want_rec = jax_registry.get(name).builder(*args, dtype)
    # the IR dataclasses are two packages' classes: compare their fields
    assert repr(rec) == repr(want_rec)
    assert repr(rec.dependences()) == repr(want_rec.dependences())
    port, want = best_plan(rec, port_target), jax_best_plan(want_rec,
                                                           jax_target)
    assert port.schedule.describe() == want.schedule.describe()
    assert port.partition.block == want.partition.block
    assert port.feasible == want.feasible
    assert port.backend == want.backend == "pallas"
    assert port.plio_assignment == want.plio_assignment
    assert port.describe() == want.describe()


def test_single_chip_plans_are_the_tpu_tiles():
    """The tiles the reference planner picks at the bench sizes, and the
    compiled Hopper tiles the runtime maps them onto (float32 mttkrp: the
    tensor-core kernel, K split over clusters of 8 blocks)."""
    want = {"jacobi2d": ((2, 2), (32, 128)),
            "jacobi2d_9pt": ((12, 12), (32, 128)),
            "jacobi2d_ms": ((89, 89), (32, 128)),
            "mttkrp": ((128, 8, 64, 128),
                       runtime.MttkrpTile(split=8, copy=16))}
    for name, (plan_tile, tile) in want.items():
        spec = registry.get(name)
        dtype, args = spec.bench_cases[0]
        plan = best_plan(spec.builder(*args, dtype), SINGLE_CHIP)
        assert not plan.feasible
        tile_of = runtime.mttkrp_tile if name == "mttkrp" \
            else runtime.stencil_tile
        assert tile_of(plan) == runtime.HopperTiles(plan=plan_tile, tile=tile)


def _paper_cases():
    for name, (_, sizes) in JAX_PAPER.items():
        for dtype, dims in sizes.items():
            yield pytest.param(name, dtype, dims, id=f"{name}-{dtype}")


@pytest.mark.parametrize("name,dtype,dims", list(_paper_cases()))
def test_compiler_report_matches_reference(name, dtype, dims):
    """The Table II report: the same design and bounds on the VCK5000."""
    builder, sizes = PAPER_BENCHMARKS[name]
    assert sizes == JAX_PAPER[name][1]
    rec = builder(*dims, dtype)
    want_rec = JAX_PAPER[name][0](*dims, dtype)
    plan, want = best_plan(rec, AIE_TARGET), jax_best_plan(want_rec, JAX_AIE)
    assert plan.describe() == want.describe()
    assert predict_bounds(rec, plan.partition, AIE_TARGET) == \
        jax_predict_bounds(want_rec, want.partition, JAX_AIE)


def test_plio_feasibility_and_naive_assignment_match_reference():
    """Algorithm 1 against the naive left-to-right packing on the mapped
    graph of a stencil plan: the same assignments and verdicts."""
    rec = registry.get("jacobi2d").builder(126, 126, "float32")
    want_rec = jax_registry.get("jacobi2d").builder(126, 126, "float32")
    target = Target(name="t", mesh_shape=(4, 4))
    plan = best_plan(rec, target)
    graph = plio.build_mapped_graph(rec, plan.schedule,
                                    plan.partition.array_tiles)
    want = jax_plio.build_mapped_graph(
        want_rec, jax_best_plan(want_rec, JaxTarget(name="t",
                                                    mesh_shape=(4, 4))).schedule,
        plan.partition.array_tiles)
    pairs = ((plio.naive_assignment(graph), jax_plio.naive_assignment(want)),
             (plio.assign_plios(graph, ports_per_col=8),
              jax_plio.assign_plios(want, ports_per_col=8)))
    for got, expect in pairs:
        assert got == expect
        for rc in (1, 2, 4, 8):
            assert plio.is_feasible(graph, got, rc, rc) == \
                jax_plio.is_feasible(want, expect, rc, rc)


def test_registry_entries_match_the_reference():
    assert registry.registered_names() == jax_registry.registered_names()
    assert [s.name for s in registry.specs()] == \
        list(jax_registry.registered_names())
    for name in NEW:
        port, want = registry.get(name), jax_registry.get(name)
        for field in ("arity", "grid_loops", "parity_dtypes", "atol",
                      "fusable_with", "n_outputs", "smoke_args",
                      "bench_cases"):
            assert getattr(port, field) == getattr(want, field), field


@pytest.mark.parametrize("name", registry.registered_names())
def test_operands_have_the_reference_layout(name):
    """Seeded draws with the reference's shapes and dtypes: integers in
    [-8, 8), the complex dtypes' planes float32."""
    spec = jax_registry.get(name)
    for dtype in (*spec.parity_dtypes, *(d for d, _ in spec.bench_cases)):
        rec = spec.builder(*spec.smoke_args, dtype)
        want = spec.operands(rec, np.random.default_rng(0))
        got = registry.operands(rec, torch.Generator().manual_seed(0))
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        assert [str(g.dtype).removeprefix("torch.") for g in got] == \
            [jnp.dtype(w.dtype).name for w in want]
        for g in got:
            if not g.dtype.is_floating_point:
                assert -8 <= int(g.min()) and int(g.max()) < 8


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _operands(name, args, dtype, seed):
    """numpy operands of the reference registry's layout, full range for
    integers."""
    shapes = registry.get(name).operand_shapes(
        registry.get(name).builder(*args, "float32"))
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return [rng.standard_normal(s).astype(np.float32) for s in shapes]
    info = np.iinfo(dtype)
    return [rng.integers(info.min, info.max, s, endpoint=True).astype(dtype)
            for s in shapes]


def _check(got, want, dtype, atol):
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).removeprefix("torch.") == jnp.dtype(want.dtype).name
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _exec_cases():
    for name in NEW:
        spec = jax_registry.get(name)
        dtypes = spec.parity_dtypes + (("int32",) if name == "jacobi2d_ms"
                                       else ())
        for args in (spec.smoke_args, RAGGED[name]):
            for dtype in dtypes:
                yield pytest.param(
                    name, args, dtype,
                    id=f"{name}-{dtype}-{'x'.join(map(str, args))}")


@pytest.mark.parametrize("name,args,dtype", list(_exec_cases()))
def test_ref_matches_jax_oracle(name, args, dtype):
    ops = _operands(name, args, dtype, seed=0)
    want = getattr(jax_ref, name)(*(jnp.asarray(o) for o in ops))
    got = getattr(ref, name)(*(torch.from_numpy(o) for o in ops))
    _check(got, want, dtype, 1e-5)


@pytest.mark.parametrize("name,args,dtype", list(_exec_cases()))
def test_execute_plan_matches_jax_kernel(name, args, dtype):
    """The single-chip plan through the port's ``lower_plan(plan,
    "pallas")`` (the wrapper's CPU path) against the reference's Pallas
    kernel in interpret mode on its own plan."""
    ops = _operands(name, args, dtype, seed=1)
    rec = registry.get(name).builder(*args, dtype)
    want = jax_execute(
        jax_best_plan(jax_registry.get(name).builder(*args, dtype),
                      JAX_SINGLE_CHIP),
        *(jnp.asarray(o) for o in ops))
    mod = mttkrp if name == "mttkrp" else jacobi2d
    before = mod.launches
    got = lower_plan(best_plan(rec, SINGLE_CHIP), "pallas")(
        *(torch.from_numpy(o) for o in ops))
    assert mod.launches == before  # CPU tensors: the plain version
    _check(got, want, dtype, jax_registry.get(name).atol)


def test_lower_plan_backends():
    spec = registry.get("jacobi2d")
    plan = best_plan(spec.builder(*spec.smoke_args, "float32"), SINGLE_CHIP)
    assert lower_plan(plan, "xla") is spec.ref
    for backend in ("systolic", "allgather"):
        with pytest.raises(NotImplementedError, match="A12"):
            lower_plan(plan, backend)
    with pytest.raises(ValueError, match="unknown backend"):
        lower_plan(plan, "mosaic")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Checks that run before any launch: meta tensors stand in for card
    tensors (they do not lie on the CPU, so no plain version runs)."""
    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    with pytest.raises(ValueError, match="CUDA"):
        jacobi2d.jacobi2d(meta((10, 10)), meta((5,)),
                          tiles=build.STENCIL_TILE)
    with pytest.raises(ValueError, match="weights for a star"):
        jacobi2d.jacobi2d_9pt(meta((10, 10)), meta((5,)),
                              tiles=build.STENCIL_TILE)
    with pytest.raises(TypeError, match="mix float and integer"):
        jacobi2d.jacobi2d_ms(meta((10, 10)), meta((3, 5), torch.int8),
                             tiles=build.STENCIL_TILE)
    with pytest.raises(ValueError, match="chain"):
        mttkrp.mttkrp(meta((4, 3, 2)), meta((3, 5)), meta((3, 5)),
                      tiles=(64, 64))
    with pytest.raises(TypeError, match="differ"):
        mttkrp.mttkrp(meta((4, 3, 2)), meta((3, 5), torch.int8),
                      meta((2, 5)), tiles=(64, 64))


# ---------------------------------------------------------------------------
# halo chains
# ---------------------------------------------------------------------------

def _chains(pkg_registry, pkg_fusion, dtype):
    def build_chain(*stages):
        return pkg_fusion.chain(*(pkg_registry.get(n).builder(*a, dtype)
                                  for n, a in stages))
    return build_chain


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_conv_jacobi_halo_chain_matches_reference(dtype):
    """conv2d (64, 61, 4, 4) -> jacobi2d (62, 59): the same fused plan, and
    the port's xla and pallas compositions equal the reference's pallas
    composition (interpret mode) on the same operands."""
    stages = (("conv2d", (64, 61, 4, 4)), ("jacobi2d", (62, 59)))
    port = fusion.fuse(_chains(registry, fusion, dtype)(*stages), SINGLE_CHIP)
    want = jax_fusion.fuse(_chains(jax_registry, jax_fusion, dtype)(*stages),
                           JAX_SINGLE_CHIP)
    assert port.family == want.family == "halo"
    for field in ("interstage", "systolic_ok", "predicted_bytes_saved",
                  "backend", "provenance"):
        assert getattr(port, field) == getattr(want, field), field
    assert port.describe() == want.describe()
    for p, w in zip(port.stage_plans, want.stage_plans):
        assert p.describe() == w.describe()
    assert fusion.halo_shrink(port.chain) == jax_fusion.halo_shrink(
        want.chain) == (5, 5)
    img, filt = _operands("conv2d", (64, 61, 4, 4), dtype, seed=2)
    weights = _operands("jacobi2d", (62, 59), dtype, seed=3)[1]
    ops = (img, filt, weights)
    expect = jax_fusion.lower_fused(want, backend="pallas", interpret=True)(
        *(jnp.asarray(o) for o in ops))
    for backend in ("xla", "pallas"):
        got = lower_plan(port, backend)(*(torch.from_numpy(o) for o in ops))
        _check(got, expect, dtype, 1e-3)
    with pytest.raises(NotImplementedError, match="A12"):
        lower_plan(port, "fused_systolic")


def test_stencil_chain_matches_reference():
    stages = (("jacobi2d", (68, 68)), ("jacobi2d", (66, 66)),
              ("jacobi2d_9pt", (62, 62)))
    port = fusion.fuse(_chains(registry, fusion, "int8")(*stages),
                       Target(mesh_shape=(2, 2)))
    want = jax_fusion.fuse(_chains(jax_registry, jax_fusion, "int8")(*stages),
                           JaxTarget(mesh_shape=(2, 2)))
    assert port.describe() == want.describe()
    assert fusion.halo_shrink(port.chain) == (8, 8)


REJECTIONS = {
    # conv2d output (64, 61) against a 60 x 60 grid's 62 x 62 footprint
    "shape-mismatch": ((("conv2d", (64, 61, 4, 4)), ("jacobi2d", (60, 60))),
                       "int16", (1, 1)),
    # 59 output columns do not shard over 8
    "mesh-mismatch": ((("conv2d", (64, 61, 4, 4)), ("jacobi2d", (62, 59))),
                      "int16", (1, 8)),
    # a 5 x 5 deep halo over 3 x 3 shards
    "halo-exceeds-shard": ((("conv2d", (8, 8, 4, 4)), ("jacobi2d", (6, 6))),
                           "int16", (2, 2)),
    # jacobi2d_ms carries its flow dependence along t
    "flow": ((("conv2d", (64, 61, 4, 4)), ("jacobi2d_ms", (62, 62, 3))),
             "float32", (1, 1)),
    # the stencils and mm are different families
    "unfusable-pair": ((("jacobi2d", (64, 64)), ("mm", (64, 48, 96))),
                       "int16", (1, 1)),
}


@pytest.mark.parametrize("reason", list(REJECTIONS))
def test_halo_rejections_match_reference(reason):
    stages, dtype, mesh = REJECTIONS[reason]
    for pkg_registry, pkg_fusion, target in (
            (registry, fusion, Target(mesh_shape=mesh)),
            (jax_registry, jax_fusion, JaxTarget(mesh_shape=mesh))):
        with pytest.raises(pkg_fusion.FusionError) as err:
            pkg_fusion.fuse(_chains(pkg_registry, pkg_fusion, dtype)(*stages),
                            target)
        assert err.value.reason == reason


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def test_float_bound_counts_each_outputs_terms():
    spec = registry.get("mttkrp")
    assert recurrences.summed_terms(spec.builder(4096, 400, 256, 256)) == \
        65536
    assert recurrences.summed_terms(
        registry.get("jacobi2d_ms").builder(4094, 4094, 8)) == 40
    assert recurrences.summed_terms(registry.get("mm").builder(8, 8, 32)) \
        == 32


def _tf32(t):
    """``t`` with its significand rounded to TF32's 10 bits."""
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("name,args", [("mm", (64, 48, 4096)),
                                       ("mttkrp", (32, 48, 64, 64))])
def test_float_bound_takes_fp32_and_rejects_tf32(name, args):
    """At 4096 terms an output, a sequential fp32 sum (the hand kernels'
    order, with a rounding after each product and each sum) stays within
    ``float_bound``; the same operands rounded to TF32 do not."""
    spec = registry.get(name)
    rec = spec.builder(*args, "float32")
    ops = registry.operands(rec, torch.Generator().manual_seed(3), "cpu")
    if name == "mm":
        a, b = ops
    else:
        x, kb, kc = ops
        a = x.reshape(x.shape[0], -1)
        b = (kb[:, None, :] * kc[None, :, :]).reshape(a.shape[1], -1)
    want = spec.ref(*ops)
    seq = torch.zeros_like(want)
    for k in range(a.shape[1]):
        seq += a[:, k:k + 1] * b[k:k + 1, :]
    assert recurrences.compare(spec, rec, ops, seq, want)[1]
    rounded = (_tf32(a).double() @ _tf32(b).double()).float()
    assert not recurrences.compare(spec, rec, ops, rounded, want)[1]


def test_recurrences_entry_point_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.recurrences",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300, check=True)
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "recurrences: 26 cases on cpu (smoke) within " \
        "tolerance"
    assert sum(line.startswith("table2 ") for line in lines) == 14
    for name in registry.registered_names():
        assert any(line.startswith(f"{name} ") for line in lines), name
