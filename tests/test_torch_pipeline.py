"""The port's GPipe (``parallel/pipeline.py``) and the elastic restart of
its trainer on logical meshes (``Trainer(mesh=...)``,
``launch/mesh.py``'s ``make_mesh_from_devices``, the sharded restore)
against the JAX package's on the CPU.

The reference runs as its own ``tests/test_pipeline.py`` does, in one
subprocess over 8 forced host devices: ``pipeline_apply`` over a
4-stage ``pipe`` mesh (8 layers of tanh(x @ w), 16 x 32, 4
microbatches) and the elastic restart of qwen1.5-0.5b's SMOKE config
(4 steps on a 4 x 2 mesh of the 8 devices, then a resume on the 2 x 2
survivor mesh of 4 that takes 2 more).  The port runs in this process:

* GPipe within 1e-5 of the sequential fold and of the reference's, on
  the reference's stacked weights and on the port's own list of qwen
  decoder layers, its gradients those of the fold; the bytes its
  ``ppermute`` and ``psum`` moved are every tick's activations and the
  one-hot gather's; indivisible layers or batches raise;
* the elastic restart from the reference's initial parameters: its loss
  history within 1e-4 of the reference's, and bit for bit the history
  of the same restart on one device (qwen has no MoE block, so a mesh
  changes nothing it computes); the resumed parameters on the survivor
  mesh's device.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.mesh import make_mesh_from_devices  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.parallel import mesh as pm  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_apply  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402

pytestmark = pytest.mark.systolic

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen1.5-0.5b"

_REFERENCE = r"""
import os, sys, json, tempfile
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.parallel.pipeline import pipeline_apply
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec
from repro.train import Trainer, TrainConfig
from repro.launch.mesh import make_mesh_from_devices

out_path = sys.argv[1]
rng = np.random.default_rng(0)
w = (rng.standard_normal((8, 32, 32)) * 0.1).astype(np.float32)
x = rng.standard_normal((16, 32)).astype(np.float32)
mesh = make_mesh((4,), ("pipe",), devices=jax.devices()[:4])
out = pipeline_apply(lambda lp, x: jnp.tanh(x @ lp), jnp.asarray(w),
                     jnp.asarray(x), mesh=mesh, microbatches=4)
np.savez(out_path, w=w, x=x, out=np.asarray(out))

cfg = get_smoke_config("qwen1.5-0.5b")
shape = ShapeSpec("t", "train", 32, 8)
devs = jax.devices()
with tempfile.TemporaryDirectory() as d:
    tc = TrainConfig(ckpt_every=2, log_every=100, total_steps=20)
    t1 = Trainer(cfg, shape, ckpt_dir=d, tcfg=tc,
                 mesh=make_mesh_from_devices(devs, model_parallel=2))
    _, _, h1 = t1.run(4, resume=False)
    t2 = Trainer(cfg, shape, ckpt_dir=d, tcfg=tc,
                 mesh=make_mesh_from_devices(devs[:4], model_parallel=2))
    _, _, h2 = t2.run(2, resume=True)
with open(out_path + ".json", "w") as f:
    json.dump({"first": h1, "resumed": h2}, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_reference") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out)), json.loads(Path(str(out) + ".json")
                                          .read_text())


def _block(lp, x):
    return torch.tanh(x @ lp)


def _fold(w, x):
    for i in range(w.shape[0]):
        x = _block(w[i], x)
    return x


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------

def test_gpipe_equals_the_fold_and_the_reference(reference):
    arrays, _ = reference
    w, x = torch.from_numpy(arrays["w"]), torch.from_numpy(arrays["x"])
    with pm.logical_devices(4):
        mesh = pm.make_mesh((4,), ("pipe",))
        pm.moved_clear()
        out = pipeline_apply(_block, w, x, mesh=mesh, microbatches=4)
        moved = dict(pm.moved)
    np.testing.assert_allclose(out.numpy(), _fold(w, x).numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), arrays["out"], rtol=0,
                               atol=1e-5)
    # 7 ticks, each stage's microbatch (4 x 32 float32) one stage on; the
    # one-hot psum brings the last stage's [4, 4, 32] to the other three
    assert moved["ppermute"] == 7 * 4 * 4 * 32 * 4
    assert moved["psum"] == 4 * 3 * 16 * 32 * 4


@pytest.mark.parametrize("stages,microbatches", [(1, 1), (2, 4), (4, 2),
                                                 (8, 8), (2, 1)])
def test_gpipe_stage_and_microbatch_counts(stages, microbatches):
    gen = torch.Generator().manual_seed(stages * 10 + microbatches)
    w = torch.randn(8, 16, 16, generator=gen) * 0.2
    x = torch.randn(8, 16, generator=gen)
    with pm.logical_devices(stages):
        out = pipeline_apply(_block, w, x,
                             mesh=pm.make_mesh((stages,), ("pipe",)),
                             microbatches=microbatches)
    torch.testing.assert_close(out, _fold(w, x), rtol=0, atol=1e-5)


def test_gpipe_gradients_are_the_folds():
    gen = torch.Generator().manual_seed(5)
    w = (torch.randn(8, 16, 16, generator=gen) * 0.2).requires_grad_()
    x = torch.randn(8, 16, generator=gen).requires_grad_()
    c = torch.randn(8, 16, generator=gen)
    with pm.logical_devices(4):
        out = pipeline_apply(_block, w, x,
                             mesh=pm.make_mesh((4,), ("pipe",)))
    gw, gx = torch.autograd.grad((out * c).sum(), (w, x))
    ww, wx = torch.autograd.grad((_fold(w, x) * c).sum(), (w, x))
    torch.testing.assert_close(gw, ww, rtol=0, atol=1e-5)
    torch.testing.assert_close(gx, wx, rtol=0, atol=1e-5)


def test_gpipe_over_the_ports_decoder_layers():
    """qwen's SMOKE decoder layers, the port's list of per-layer trees,
    over 2 stages and 2 microbatches: the layers' sequential fold."""
    cfg = get_smoke_config(ARCH)
    p = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(4, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))

    def block(lp, h):
        return TT._block(lp, cfg, h, TT._positions(h))[0]

    want = x
    for lp in p["layers"]:
        want = block(lp, want)
    with torch.no_grad(), pm.logical_devices(2):
        got = pipeline_apply(block, p["layers"], x,
                             mesh=pm.make_mesh((2,), ("pipe",)),
                             microbatches=2)
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=1e-5)


def test_gpipe_refuses_what_does_not_divide():
    w, x = torch.zeros(6, 4, 4), torch.zeros(8, 4)
    with pm.logical_devices(4):
        mesh = pm.make_mesh((4,), ("pipe",))
        with pytest.raises(ValueError, match="6 layers over 4 stages"):
            pipeline_apply(_block, w, x, mesh=mesh)
        with pytest.raises(ValueError, match="batch 8 over 3"):
            pipeline_apply(_block, torch.zeros(4, 4, 4), x, mesh=mesh,
                           microbatches=3)


# ---------------------------------------------------------------------------
# elastic restart
# ---------------------------------------------------------------------------

def _reference_params():
    cfg = jax_smoke(ARCH)
    p = jax_build(cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


def _elastic(tmp, np_params, meshes):
    """4 steps, a checkpoint, then a resume on the second mesh that takes
    2 more, from the reference's initial parameters."""
    cfg = get_smoke_config(ARCH)
    shape = ShapeSpec("t", "train", 32, 8)
    tc = TrainConfig(ckpt_every=2, log_every=100, total_steps=20)
    hist = []
    for mesh, steps, resume in zip(meshes, (4, 2), (False, True)):
        t = Trainer(cfg, shape, ckpt_dir=str(tmp), tcfg=tc, mesh=mesh,
                    device="cpu")

        def init_state():
            params = params_from_jax(np_params, cfg, "cpu")
            return params, adamw_init(params)

        t.init_state = init_state
        params, _, h = t.run(steps, resume=resume)
        hist.append(h)
    return hist, params


def test_elastic_restart_equals_the_reference_and_one_device(tmp_path,
                                                             reference):
    _, want = reference
    np_params = _reference_params()
    with pm.logical_devices(8):
        devs = pm.devices()
        meshes = (make_mesh_from_devices(devs, model_parallel=2),
                  make_mesh_from_devices(devs[:4], model_parallel=2))
        assert [m.shape for m in meshes] == [{"data": 4, "model": 2},
                                             {"data": 2, "model": 2}]
        hist, params = _elastic(tmp_path / "mesh", np_params, meshes)
    single, _ = _elastic(tmp_path / "single", np_params, (None, None))
    np.testing.assert_allclose(hist[0], want["first"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(hist[1], want["resumed"], rtol=1e-4,
                               atol=1e-4)
    assert hist == single
    assert {leaf.device for leaf in tree.leaves(params)} == {
        meshes[1].devices.flat[0]}
