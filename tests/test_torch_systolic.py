"""The port's chip-level schedules (``kernels/systolic.py`` on
``parallel/mesh.py``) against the JAX package's ``repro.kernels.systolic``.

The reference runs the way its own ``systolic`` sweeps run: one
subprocess per forced host device count (1, 4, 8 and 16), every case of
that count's meshes in it, its operands and outputs written to an
``.npz`` under ``tmp_path``.  The four subprocesses start together.  The
port runs in this process on logical CPU meshes of the same shapes
(``parallel.mesh.logical_devices``), on the same operands:

* every spec's ``systolic`` and ``allgather`` lowering at its smoke size
  and parity dtypes on 1 x 1 and 2 x 2, conv2d / fir / jacobi2d_9pt on
  2 x 4 too;
* the fused chains' ``fused_systolic`` schedule on 2 x 2 (mm+mm with and
  without the bias and gelu, the fft2d pair) and 2 x 4 (conv2d ->
  jacobi2d);
* ``lower_hierarchical`` on both chip backends at outer 2 x inner 2 x 2;
* integers bit-exact, floats within the registry's ``atol``;
* the reference's error text for an indivisible extent, a non-square
  Cannon mesh and a halo or window wider than its shard;
* ``available_backends``, ``fused_available_backends`` and
  ``hierarchical_available_backends`` at 1, 4, 8 and 16 devices.

In this process: ``ppermute`` gives zeros to a member that receives
nothing, and every block it delivers is a copy, never the sender's
tensor.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from repro_torch.core import (HierarchicalTarget, Target,  # noqa: E402
                              best_plan, fusion, hierarchy, lower_plan)
from repro_torch.core import autotune  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.parallel import mesh as pm  # noqa: E402

pytestmark = pytest.mark.systolic

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
HIER_AXES = ("row", "col")

#: (mesh, spec, dtype, backend) of every single-recurrence case
FLAT = [((1, 1), s.name, d, b) for s in registry.specs()
        for d in s.parity_dtypes for b in ("systolic", "allgather")] + [
    ((2, 2), s.name, d, b) for s in registry.specs()
    for d in s.parity_dtypes for b in ("systolic", "allgather")] + [
    ((2, 4), n, d, b) for n in ("conv2d", "fir", "jacobi2d_9pt")
    for d in registry.get(n).parity_dtypes
    for b in ("systolic", "allgather")]

#: (mesh, per-stage builder args, dtype, interstage) of the fused chains
FUSED = [
    ((2, 2), (("mm", (64, 96, 32)), ("mm", (64, 48, 96))), "int16", None),
    ((2, 2), (("mm", (64, 96, 32)), ("mm", (64, 48, 96))), "float32",
     ("bias_gelu",)),
    ((2, 2), (("fft2d_stage", (16, 16)), ("fft2d_stage", (16, 16))),
     "cfloat", None),
    ((2, 4), (("conv2d", (66, 66, 4, 4)), ("jacobi2d", (64, 64))), "int16",
     None),
    ((2, 4), (("conv2d", (66, 66, 4, 4)), ("jacobi2d", (64, 64))),
     "float32", None),
]

#: (spec, builder args, backend) at outer 2 x 1 over inner 2 x 2, int16
HIER = [(n, a, b) for n, a in (("mm", (128, 128, 128)),
                               ("bmm", (4, 128, 128, 64)),
                               ("jacobi2d", (128, 128)))
        for b in ("systolic", "allgather")]

#: (mesh, spec, builder args, backend) that each raise a ValueError
ERRORS = [
    ((2, 2), "mm", (63, 64, 64), "systolic"),         # indivisible rows
    ((2, 4), "mm", (64, 64, 64), "systolic"),         # non-square ring
    ((2, 2), "jacobi2d_9pt", (2, 2), "systolic"),     # halo > shard
    ((2, 2), "conv2d", (4, 8, 4, 4), "systolic"),     # window > shard
]

#: the targets whose available backends both packages report
AVAIL_FLAT = [(1, 1), (2, 2), (2, 4), (4, 4), (1, 8), (8,)]
AVAIL_HIER = [((2, 1), (2, 2)), ((1, 2), (1, 8)), ((2, 2), (2, 2)),
              ((2, 2), (1, 1))]
AVAIL_FUSED = [(("mm", (64, 96, 32)), ("mm", (64, 48, 96)), m)
               for m in ((1, 1), (2, 2), (1, 8))] + [
    (("conv2d", (66, 66, 4, 4)), ("jacobi2d", (64, 64)), m)
    for m in ((1, 1), (2, 4), (2, 2))]

COUNTS = (1, 4, 8, 16)


def _count(mesh) -> int:
    return int(np.prod(mesh))


def _flat_cases(n):
    return [(i, c) for i, c in enumerate(FLAT) if _count(c[0]) == n]


def _fused_cases(n):
    return [(i, c) for i, c in enumerate(FUSED) if _count(c[0]) == n]


_REFERENCE = r"""
import os, sys, json
n_dev = int(sys.argv[1])
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
    f" --xla_force_host_platform_device_count={n_dev}").strip()
sys.path.insert(0, "src")
import numpy as np, jax
from repro.compat import make_mesh
from repro.core import HierarchicalTarget, Target, best_plan, lower_plan
from repro.core import autotune, fusion
from repro.kernels import registry

jobs = json.loads(sys.argv[2])
out_path = sys.argv[3]
assert jax.local_device_count() == n_dev, jax.local_device_count()
arrays, info = {}, {"errors": {}}

def mesh_of(shape, axes):
    return make_mesh(tuple(shape), tuple(axes),
                     devices=jax.devices()[:int(np.prod(shape))])

def keep(key, ops, out):
    outs = out if isinstance(out, tuple) else (out,)
    for j, o in enumerate(ops):
        arrays[f"{key}_op{j}"] = np.asarray(o)
    for j, o in enumerate(outs):
        arrays[f"{key}_out{j}"] = np.asarray(o)

for i, (shape, name, dtype, backend) in jobs["flat"]:
    spec = registry.get(name)
    rec = spec.builder(*spec.smoke_args, dtype)
    plan = best_plan(rec, Target(mesh_shape=tuple(shape)))
    ops = spec.operands(rec, np.random.default_rng(100 + i))
    fn = lower_plan(plan, backend=backend, mesh=mesh_of(shape, ("data", "model")))
    keep(f"flat{i}", ops, jax.jit(fn)(*ops))

for i, (shape, stages, dtype, inter) in jobs["fused"]:
    inter = tuple(inter) if inter else None
    ch = fusion.chain(*(registry.get(nm).builder(*a, dtype) for nm, a in stages))
    plan = fusion.fuse(ch, Target(mesh_shape=tuple(shape)), interstage=inter)
    ops = fusion.chain_operands(ch, np.random.default_rng(200 + i),
                                interstage=inter)
    fn = fusion.lower_fused(plan, backend="fused_systolic",
                            mesh=mesh_of(shape, ("data", "model")))
    keep(f"fused{i}", ops, jax.jit(fn)(*ops))

if jobs["hier"]:
    inner = Target(name="hier_inner", mesh_shape=(2, 2),
                   mesh_axes=("row", "col"))
    ht = HierarchicalTarget(outer_shape=(2, 1), inner=inner)
    for i, (name, args, backend) in jobs["hier"]:
        spec = registry.get(name)
        rec = spec.builder(*args, "int16")
        ops = spec.operands(rec, np.random.default_rng(300 + i))
        hier = best_plan(rec, ht)
        info.setdefault("hier_split", {})[str(i)] = hier.outer_split
        keep(f"hier{i}", ops, lower_plan(hier, backend=backend)(*ops))

for i, (shape, name, args, backend) in jobs["errors"]:
    spec = registry.get(name)
    rec = spec.builder(*args, "int16")
    ops = spec.operands(rec, np.random.default_rng(400 + i))
    try:
        plan = best_plan(rec, Target(mesh_shape=tuple(shape)))
        lower_plan(plan, backend=backend,
                   mesh=mesh_of(shape, ("data", "model")))(*ops)
        info["errors"][str(i)] = None
    except ValueError as e:
        info["errors"][str(i)] = str(e)

info["flat"] = [autotune.available_backends(Target(mesh_shape=tuple(m)))
                for m in jobs["avail_flat"]]
info["hier"] = [autotune.available_backends(HierarchicalTarget(
    outer_shape=tuple(o), inner=Target(mesh_shape=tuple(m))))
    for o, m in jobs["avail_hier"]]
fused = []
for a, b, m in jobs["avail_fused"]:
    ch = fusion.chain(*(registry.get(nm).builder(*args, "float32")
                        for nm, args in (a, b)))
    fused.append(fusion.fused_available_backends(
        fusion.fuse(ch, Target(mesh_shape=tuple(m)))))
info["fused"] = fused
np.savez(out_path, **arrays)
with open(out_path + ".json", "w") as f:
    json.dump(info, f)
"""


def _jobs(n):
    return {
        "flat": _flat_cases(n),
        "fused": _fused_cases(n),
        "hier": list(enumerate(HIER)) if n == 8 else [],
        "errors": [(i, e) for i, e in enumerate(ERRORS)
                   if _count(e[0]) == n],
        "avail_flat": AVAIL_FLAT, "avail_hier": AVAIL_HIER,
        "avail_fused": AVAIL_FUSED,
    }


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs at every device count: four subprocesses,
    started together, one per count."""
    tmp = tmp_path_factory.mktemp("systolic_reference")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for n in COUNTS:
        out = tmp / f"devices{n}.npz"
        procs[n] = (out, subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(n), json.dumps(_jobs(n)),
             str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    results = {}
    for n, (out, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        results[n] = (dict(np.load(out)),
                      json.loads(Path(str(out) + ".json").read_text()))
    return results


def _operands(arrays, key):
    ops, j = [], 0
    while f"{key}_op{j}" in arrays:
        ops.append(torch.from_numpy(arrays[f"{key}_op{j}"].copy()))
        j += 1
    return tuple(ops)


def _check(arrays, key, got, dtype, atol):
    gots = got if isinstance(got, tuple) else (got,)
    wants = [arrays[f"{key}_out{j}"] for j in range(len(gots))]
    assert f"{key}_out{len(gots)}" not in arrays
    for g, w in zip(gots, wants):
        g = g.numpy()
        assert g.shape == w.shape, (g.shape, w.shape)
        if dtype.startswith("int"):
            assert g.dtype == w.dtype, (g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g.astype(np.float64),
                                       w.astype(np.float64), atol=atol,
                                       rtol=0)


def _mesh(shape, axes=AXES):
    return pm.make_mesh(shape, axes, [torch.device("cpu")] * _count(shape))


@pytest.mark.parametrize("i", range(len(FLAT)), ids=[
    f"{m[0]}x{m[1]}-{n}-{d}-{b}" for m, n, d, b in FLAT])
def test_schedule_matches_the_reference(reference, i):
    shape, name, dtype, backend = FLAT[i]
    arrays, _ = reference[_count(shape)]
    spec = registry.get(name)
    rec = spec.builder(*spec.smoke_args, dtype)
    plan = best_plan(rec, Target(mesh_shape=shape))
    got = lower_plan(plan, backend, mesh=_mesh(shape))(
        *_operands(arrays, f"flat{i}"))
    _check(arrays, f"flat{i}", got, dtype, spec.atol)


@pytest.mark.parametrize("i", range(len(FUSED)), ids=[
    f"{m[0]}x{m[1]}-{'+'.join(s for s, _ in st)}-{d}-{x[0] if x else 'none'}"
    for m, st, d, x in FUSED])
def test_fused_schedule_matches_the_reference(reference, i):
    shape, stages, dtype, inter = FUSED[i]
    arrays, _ = reference[_count(shape)]
    chain = fusion.chain(*(registry.get(n).builder(*a, dtype)
                           for n, a in stages))
    plan = fusion.fuse(chain, Target(mesh_shape=shape), interstage=inter)
    assert plan.systolic_ok
    with pm.logical_devices(_count(shape)):
        assert fusion.fused_available_backends(plan)[0] == "fused_systolic"
    got = fusion.lower_fused(plan, "fused_systolic", mesh=_mesh(shape))(
        *_operands(arrays, f"fused{i}"))
    last = registry.get(stages[-1][0])
    _check(arrays, f"fused{i}", got, dtype,
           last.atol if last.n_outputs > 1 else 1e-2)


@pytest.mark.parametrize("i", range(len(HIER)), ids=[
    f"{n}-{b}" for n, _, b in HIER])
def test_hierarchical_schedule_matches_the_reference(reference, i):
    name, args, backend = HIER[i]
    arrays, info = reference[8]
    inner = Target(name="hier_inner", mesh_shape=(2, 2),
                   mesh_axes=HIER_AXES)
    ht = HierarchicalTarget(outer_shape=(2, 1), inner=inner)
    plan = best_plan(registry.get(name).builder(*args, "int16"), ht)
    assert plan.outer_split == info["hier_split"][str(i)]
    ops = _operands(arrays, f"hier{i}")
    with pytest.raises(RuntimeError, match="8 devices needed"):
        hierarchy.lower_hierarchical(plan, backend)
    with pm.logical_devices(8):
        got = hierarchy.lower_hierarchical(plan, backend)(*ops)
    _check(arrays, f"hier{i}", got, "int16", 0.0)
    # a row split sums the groups at the accumulator dtype
    with pm.logical_devices(8):
        acc = hierarchy.lower_hierarchical(plan, backend,
                                           out_dtype=torch.int32)(*ops)
    assert acc.dtype == torch.int32 and torch.equal(acc, got.to(torch.int32))


@pytest.mark.parametrize("i", range(len(ERRORS)), ids=[
    "indivisible", "non-square", "halo-exceeds-shard",
    "window-exceeds-shard"])
def test_errors_are_the_references(reference, i):
    shape, name, args, backend = ERRORS[i]
    _, info = reference[_count(shape)]
    want = info["errors"][str(i)]
    assert want, "the reference raised nothing"
    spec = registry.get(name)
    rec = spec.builder(*args, "int16")
    ops = registry.operands(rec, torch.Generator().manual_seed(0))
    plan = best_plan(rec, Target(mesh_shape=shape))
    with pytest.raises(ValueError) as e:
        lower_plan(plan, backend, mesh=_mesh(shape))(*ops)
    assert str(e.value) == want


@pytest.mark.parametrize("n", COUNTS)
def test_available_backends_equal_the_references(reference, n):
    _, info = reference[n]
    with pm.logical_devices(n):
        assert pm.local_device_count() == n == len(pm.devices("cpu"))
        flat = [autotune.available_backends(Target(mesh_shape=m))
                for m in AVAIL_FLAT]
        hier = [autotune.available_backends(HierarchicalTarget(
            outer_shape=o, inner=Target(mesh_shape=m)))
            for o, m in AVAIL_HIER]
        fused = [fusion.fused_available_backends(fusion.fuse(
            fusion.chain(*(registry.get(nm).builder(*args, "float32")
                           for nm, args in (a, b))), Target(mesh_shape=m)))
            for a, b, m in AVAIL_FUSED]
    assert [list(x) for x in flat] == info["flat"]
    assert [list(x) for x in hier] == info["hier"]
    assert [list(x) for x in fused] == info["fused"]


def test_ppermute_gives_zeros_and_copies():
    mesh = pm.make_mesh((1, 3), AXES, [torch.device("cpu")] * 3)
    blocks = pm.blocks_like(mesh)
    for member in mesh.members():
        blocks[member] = torch.full((2, 2), float(member[1] + 1))
    pm.moved_clear()
    out = pm.ppermute(mesh, blocks, "model", [(0, 1), (1, 2)])
    assert torch.equal(out[0, 0], torch.zeros(2, 2))
    assert torch.equal(out[0, 1], blocks[0, 0])
    assert torch.equal(out[0, 2], blocks[0, 1])
    assert out[0, 1].data_ptr() != blocks[0, 0].data_ptr()
    blocks[0, 0].add_(5)
    assert torch.equal(out[0, 1], torch.full((2, 2), 1.0))
    assert pm.moved["ppermute"] == 2 * 4 * 4
    # a member sending to itself copies too, and moves nothing
    same = pm.ppermute(mesh, blocks, "model", [(0, 0)])
    assert same[0, 0].data_ptr() != blocks[0, 0].data_ptr()
    assert pm.moved["ppermute"] == 2 * 4 * 4
    with pytest.raises(ValueError, match="receives twice"):
        pm.ppermute(mesh, blocks, "model", [(0, 1), (2, 1)])


def test_logical_devices_default_and_shard_round_trip():
    assert pm.local_device_count("cpu") == 1
    assert pm.devices("cpu") == [torch.device("cpu")]
    with pm.logical_devices(4):
        mesh = pm.make_mesh((2, 2), AXES, pm.devices("cpu"))
        assert mesh.shape == {"data": 2, "model": 2}
    assert pm.local_device_count("cpu") == 1
    x = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    spec = pm.P(None, "data", "model")
    blocks = pm.shard(mesh, x, spec)
    assert blocks[1, 0].shape == (4, 3, 4)
    assert torch.equal(blocks[1, 0], x[:, 3:, :4])
    assert torch.equal(pm.unshard(mesh, blocks, spec, x.device), x)
    with pytest.raises(ValueError, match="does not divide"):
        pm.shard(mesh, x[:, :5], spec)
    with pytest.raises(ValueError, match="needs 8 devices"):
        pm.make_mesh((2, 4), AXES, pm.devices("cpu"))
