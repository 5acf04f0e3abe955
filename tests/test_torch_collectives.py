"""The port's mesh collectives (``parallel/mesh.py``'s ``psum`` / ``pmax``
/ ``pmean`` / ``all_to_all``, ``parallel/collectives.py``) and the MoE
mesh paths (``models/moe.py``'s TP-MoE, ``moe_ep_alltoall``'s EP) against
the JAX package's on the CPU.

The reference runs as its own ``tests/test_collectives.py`` does: one
subprocess over 8 forced host devices, every case in it, its operands
(numpy draws from a seed) and outputs in an ``.npz`` under the test's
temporary directory.  The port runs in this process on logical CPU
meshes of the same shapes (``parallel.mesh.logical_devices``):

* the collectives on a (2, 4) ``("data", "model")`` mesh over each axis
  and both, equal to ``jax.lax``'s; ``all_to_all`` tiled and not;
* ``ring_reduce_scatter_matmul`` over 8 members: float32 within 1e-3 of
  the reference and of X @ W; int8 at k = 10240 with operands in [120,
  128) bitwise against an int64 oracle, in int32; the bytes the ring
  moved equal to ``ring_reduce_scatter_bytes``;
* ``quantized_psum`` over 8 members within 8 quantization steps of the
  sum (the reference's own bound);
* olmoe-1b-7b's and deepseek-v2-236b's SMOKE MoE block (float32,
  capacity factor 8, so nothing drops) on (2, 4), TP and EP: y and the
  load-balance term within 2e-4 of the reference's mesh outputs, and the
  gradients of sum(y * c) + 10 aux with respect to x and every weight
  within 1e-4 (the router's carries the reference's per-shard aux);
* EP at a sequence that does not divide over the expert axis raises
  ``ValueError``, as the reference's ``shard_map`` does.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.parallel import collectives as C  # noqa: E402
from repro_torch.parallel import mesh as pm  # noqa: E402
from repro_torch.parallel.mesh import P  # noqa: E402
from repro_torch.parallel.sharding import mesh_context  # noqa: E402

pytestmark = pytest.mark.systolic

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "model")
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-236b")
MOE_PATHS = ("tp", "ep")
#: (name, reduced axes) of the reductions held to jax.lax's
REDUCTIONS = [(op, ax) for op in ("psum", "pmax", "pmean")
              for ax in ("data", "model", ("data", "model"))]
#: (split_axis, concat_axis, tiled) of the all_to_all cases over "model"
A2A = [(0, 1, True), (1, 0, True), (2, 0, True), (0, 0, False),
       (0, 2, False), (1, 2, False)]

_REFERENCE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get_smoke_config
from repro.models import moe as MOE
from repro.parallel.collectives import quantized_psum, ring_reduce_scatter_matmul
from repro.parallel.sharding import mesh_context

jobs = json.loads(sys.argv[1])
out_path = sys.argv[2]
arrays, info = {}, {}
rng = np.random.default_rng(0)
mesh8 = make_mesh((8,), ("tp",))
mesh2 = make_mesh((2, 4), ("data", "model"))

ring = shard_map(lambda xl, wl: ring_reduce_scatter_matmul(xl, wl, "tp", 8),
                 mesh=mesh8, in_specs=(P(None, "tp"), P("tp", None)),
                 out_specs=P("tp", None), check=False)
x = rng.standard_normal((64, 128)).astype(np.float32)
w = rng.standard_normal((128, 32)).astype(np.float32)
arrays.update(ring_x=x, ring_w=w, ring_y=np.asarray(jax.jit(ring)(x, w)))
x8 = rng.integers(120, 128, size=(64, 10240), dtype=np.int8)
w8 = rng.integers(120, 128, size=(10240, 32), dtype=np.int8)
arrays.update(ring8_x=x8, ring8_w=w8, ring8_y=np.asarray(jax.jit(ring)(x8, w8)))

g = rng.standard_normal((8, 256)).astype(np.float32) * 3
qp = shard_map(lambda gl: quantized_psum(gl, "dp", jax.random.PRNGKey(1)),
               mesh=make_mesh((8,), ("dp",)), in_specs=P("dp", None),
               out_specs=P("dp", None), check=False)
arrays.update(qpsum_g=g, qpsum_y=np.asarray(jax.jit(qp)(g)))

blocks = rng.standard_normal((4, 8, 12)).astype(np.float32)
arrays["coll_x"] = blocks
spec = P("data", "model", None)
for i, (op, ax) in enumerate(jobs["reductions"]):
    ax = tuple(ax) if isinstance(ax, list) else ax
    fn = getattr(jax.lax, op)
    sm = shard_map(lambda b: fn(b, ax), mesh=mesh2, in_specs=spec,
                   out_specs=spec, check=False)
    arrays[f"red{i}"] = np.asarray(jax.jit(sm)(blocks))
a2a_x = rng.standard_normal((8, 16, 8)).astype(np.float32)
arrays["a2a_x"] = a2a_x
for i, (split, concat, tiled) in enumerate(jobs["a2a"]):
    sm = shard_map(lambda b: jax.lax.all_to_all(b, "model", split, concat,
                                                tiled=tiled),
                   mesh=mesh2, in_specs=P("data", "model", None),
                   out_specs=P("data", "model", None), check=False)
    arrays[f"a2a{i}"] = np.asarray(jax.jit(sm)(a2a_x))

for arch in jobs["moe"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              moe_capacity_factor=8.0)
    p = MOE.init_moe(jax.random.PRNGKey(0), cfg)
    xm = rng.standard_normal((8, 4, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal((8, 4, cfg.d_model)).astype(np.float32)
    for k, v in p.items():
        arrays[f"{arch}_p_{k}"] = np.asarray(v)
    arrays[f"{arch}_x"], arrays[f"{arch}_c"] = xm, c
    for path in ("tp", "ep"):
        cf = dataclasses.replace(cfg, moe_ep=path == "ep")

        def loss(p, x):
            y, aux = MOE.apply_moe(p, cf, x)
            return jnp.sum(y * c) + 10.0 * aux, (y, aux)

        with mesh_context(mesh2):
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(xm))
        key = f"{arch}_{path}"
        arrays[f"{key}_y"], arrays[f"{key}_aux"] = np.asarray(y), np.asarray(aux)
        arrays[f"{key}_gx"] = np.asarray(gx)
        for k, v in gp.items():
            arrays[f"{key}_g_{k}"] = np.asarray(v)
    cf = dataclasses.replace(cfg, moe_ep=True)
    try:
        with mesh_context(mesh2):
            jax.jit(lambda p, x: MOE.apply_moe(p, cf, x))(p, jnp.asarray(xm[:, :1]))
        info[f"{arch}_ep_decode"] = None
    except ValueError as e:
        info[f"{arch}_ep_decode"] = type(e).__name__
np.savez(out_path, **arrays)
with open(out_path + ".json", "w") as f:
    json.dump(info, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives_reference") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jobs = {"reductions": REDUCTIONS, "a2a": A2A, "moe": MOE_ARCHS}
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(jobs), str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out)), json.loads(Path(str(out) + ".json")
                                          .read_text())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _on(n):
    return pm.logical_devices(n)


# ---------------------------------------------------------------------------
# psum / pmax / pmean / all_to_all
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(REDUCTIONS)),
                         ids=[f"{op}-{ax}" for op, ax in REDUCTIONS])
def test_reduction_equals_jax_lax(i, reference):
    arrays, _ = reference
    op, ax = REDUCTIONS[i]
    x = _t(arrays["coll_x"])
    spec = P("data", "model", None)
    with _on(8):
        mesh = pm.make_mesh((2, 4), AXES)
        pm.moved_clear()
        out = getattr(pm, op)(mesh, pm.shard(mesh, x, spec), ax)
        got = pm.unshard(mesh, out, spec, x.device)
    np.testing.assert_allclose(got.numpy(), arrays[f"red{i}"], rtol=0,
                               atol=1e-6)
    width = pm._width(mesh, ax)
    block = x.numel() // 8 * 4
    key = "pmax" if op == "pmax" else "psum"
    assert pm.moved[key] == 8 * (width - 1) * block


@pytest.mark.parametrize("i", range(len(A2A)),
                         ids=[f"s{s}-c{c}-{'tiled' if t else 'stacked'}"
                              for s, c, t in A2A])
def test_all_to_all_equals_jax_lax(i, reference):
    arrays, _ = reference
    split, concat, tiled = A2A[i]
    x = _t(arrays["a2a_x"])
    spec = P("data", "model", None)
    with _on(8):
        mesh = pm.make_mesh((2, 4), AXES)
        blocks = pm.shard(mesh, x, spec)
        got = pm.unshard(mesh, pm.all_to_all(mesh, blocks, "model", split,
                                             concat, tiled), spec, x.device)
    np.testing.assert_array_equal(got.numpy(), arrays[f"a2a{i}"])


def test_collectives_carry_gradients():
    """autograd through shard, psum, all_to_all and unshard: the gradient
    of sum(c * psum(x)) over the model axis is each block's group sum of
    c, and all_to_all's is its inverse permutation of the cotangent."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 16, 8, generator=gen, requires_grad=True)
    c = torch.randn(4, 16, 8, generator=gen)
    spec = P("data", "model", None)
    with _on(8):
        mesh = pm.make_mesh((2, 4), AXES)
        y = pm.unshard(mesh, pm.psum(mesh, pm.shard(mesh, x, spec), "model"),
                       spec, x.device)
        (y * c).sum().backward()
        want = c.reshape(4, 4, 4, 8).sum(dim=1, keepdim=True)
        want = want.expand(4, 4, 4, 8).reshape(4, 16, 8)
        torch.testing.assert_close(x.grad, want)
        x.grad = None
        z = pm.unshard(mesh, pm.all_to_all(mesh, pm.shard(mesh, x, spec),
                                           "model", 1, 2), spec, x.device)
        (z * z).sum().backward()
        torch.testing.assert_close(x.grad, 2 * x.detach())


# ---------------------------------------------------------------------------
# ring reduce-scatter matmul, quantized psum
# ---------------------------------------------------------------------------

def _ring(x, w):
    with _on(8):
        mesh = pm.make_mesh((8,), ("tp",))
        pm.moved_clear()
        out = C.ring_reduce_scatter_matmul(
            mesh, pm.shard(mesh, x, P(None, "tp")),
            pm.shard(mesh, w, P("tp", None)), "tp", 8)
        return pm.unshard(mesh, out, P("tp", None), x.device), \
            dict(pm.moved)


def test_ring_reduce_scatter_matmul_float32(reference):
    arrays, _ = reference
    x, w = _t(arrays["ring_x"]), _t(arrays["ring_w"])
    got, moved = _ring(x, w)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), arrays["ring_y"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got.numpy(), arrays["ring_x"]
                               @ arrays["ring_w"], rtol=0, atol=1e-3)
    chunk = x.shape[0] // 8 * w.shape[1] * 4
    assert moved["ppermute"] == C.ring_reduce_scatter_bytes(chunk, 8)


def test_ring_reduce_scatter_matmul_int8_is_exact(reference):
    arrays, _ = reference
    got, _ = _ring(_t(arrays["ring8_x"]), _t(arrays["ring8_w"]))
    oracle = arrays["ring8_x"].astype(np.int64) @ arrays["ring8_w"].astype(
        np.int64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), oracle)
    np.testing.assert_array_equal(got.numpy(), arrays["ring8_y"])


@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_ring_bytes_model(group):
    """Hops of the ring: group - 1 steps of group chunks, then the
    realignment's group (none on a ring of 2, where it sends to
    itself)."""
    hops = group * (group - 1) + (group if group > 2 else 0)
    assert C.ring_reduce_scatter_bytes(10, group) == 10 * hops * (group > 1)


def test_quantized_psum_within_quantization_noise(reference):
    arrays, _ = reference
    g = _t(arrays["qpsum_g"])
    with _on(8):
        mesh = pm.make_mesh((8,), ("dp",))
        out = C.quantized_psum(mesh, pm.shard(mesh, g, P("dp", None)), "dp",
                               torch.Generator().manual_seed(1))
        got = pm.unshard(mesh, out, P("dp", None), g.device).numpy()
    true = arrays["qpsum_g"].sum(0)
    scale = np.abs(arrays["qpsum_g"]).max() / 127.0
    for row in list(got) + list(arrays["qpsum_y"]):
        assert np.abs(row - true).max() < 8 * scale
    # every member holds the same sum
    assert (got == got[0]).all()


# ---------------------------------------------------------------------------
# MoE mesh paths
# ---------------------------------------------------------------------------

def _moe_case(arrays, arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              moe_capacity_factor=8.0)
    prefix = f"{arch}_p_"
    p = {k[len(prefix):]: _t(v) for k, v in arrays.items()
         if k.startswith(prefix)}
    return cfg, p, _t(arrays[f"{arch}_x"]), _t(arrays[f"{arch}_c"])


@pytest.mark.parametrize("path", MOE_PATHS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mesh_path_equals_reference(arch, path, reference):
    arrays, _ = reference
    cfg, p, x, c = _moe_case(arrays, arch)
    cfg = dataclasses.replace(cfg, moe_ep=path == "ep")
    params = {k: v.clone().requires_grad_() for k, v in p.items()}
    x = x.clone().requires_grad_()
    with _on(8), mesh_context(pm.make_mesh((2, 4), AXES)):
        y, aux = TM.apply_moe(params, cfg, x, True)
    (torch.sum(y * c) + 10.0 * aux).backward()
    key = f"{arch}_{path}"
    np.testing.assert_allclose(y.detach().numpy(), arrays[f"{key}_y"],
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(float(aux.detach()), arrays[f"{key}_aux"],
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(x.grad.numpy(), arrays[f"{key}_gx"], rtol=0,
                               atol=1e-4)
    for k, v in params.items():
        want = arrays[f"{key}_g_{k}"]
        np.testing.assert_allclose(v.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=k)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mesh_paths_equal_one_device_when_nothing_drops(arch,
                                                             reference):
    """At capacity factor 8 nothing drops, so y of both mesh paths is the
    single-device block's (its aux is the per-shard mean, not this)."""
    arrays, _ = reference
    cfg, p, x, _ = _moe_case(arrays, arch)
    want = TM.apply_moe(p, cfg, x)
    for ep in (False, True):
        with _on(8), mesh_context(pm.make_mesh((2, 4), AXES)):
            got = TM.apply_moe(p, dataclasses.replace(cfg, moe_ep=ep), x)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ep_sequence_that_does_not_divide_raises(arch, reference):
    arrays, info = reference
    cfg, p, x, _ = _moe_case(arrays, arch)
    assert info[f"{arch}_ep_decode"] == "ValueError"
    with _on(8), mesh_context(pm.make_mesh((2, 4), AXES)):
        with pytest.raises(ValueError, match="does not divide"):
            TM.apply_moe(p, dataclasses.replace(cfg, moe_ep=True), x[:, :1])


def test_moe_local_experts_is_the_shard_contribution():
    """``moe_ffn_tokens(local_experts=...)`` of each shard adds up to the
    whole block's y (nothing drops at capacity factor 8)."""
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                              dtype="float32", moe_capacity_factor=8.0)
    p = TM.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(12, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    whole = TM.moe_ffn_tokens(cfg, p, x)
    e_loc = cfg.moe_num_experts // 4
    parts = sum(TM.moe_ffn_tokens(
        cfg, {"router": p["router"],
              **{k: p[k][i * e_loc:(i + 1) * e_loc] for k in ("wg", "wu",
                                                                 "wd")}},
        x, local_experts=(i * e_loc, e_loc)) for i in range(4))
    torch.testing.assert_close(parts, whole, rtol=0, atol=2e-5)


def test_checkpointed_mesh_layers_recompute_on_another_thread():
    """A CUDA backward recomputes a checkpointed layer on autograd's own
    thread, where the thread-local mesh context is not set: the layer
    carries its forward's context there (``sharding.carry_context``).
    Here the backward runs on another thread on purpose: the gradients
    equal those of a backward on this thread."""
    import threading

    from repro_torch import tree
    from repro_torch.models import build_model
    from repro_torch.train.step import value_and_grad

    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                              moe_capacity_factor=8.0, remat="full")
    api = build_model(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 8), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (4, 8), generator=gen)}
    with _on(4), mesh_context(pm.make_mesh((2, 2), AXES)):
        _, want = value_and_grad(api.loss, params, batch)
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        loss = api.loss(tree.unflatten(params, leaves), batch)
    out = {}
    worker = threading.Thread(target=lambda: out.update(
        grads=torch.autograd.grad(loss, leaves, allow_unused=True)))
    worker.start()
    worker.join()
    assert "grads" in out
    for g, w in zip(out["grads"], tree.leaves(want)):
        if g is None:
            assert not w.abs().max()
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
