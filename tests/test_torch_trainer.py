"""The port's optimizer, train step, checkpoints, trainer, pipeline and
launcher against the JAX package on the CPU (the Functions' and the
models' gradients are in ``test_torch_train.py``, whose helpers this
file shares).

AdamW, the schedule and the global norm equal the reference's (the bf16
leaf within one bf16 step); three train steps (and with ``grad_accum``
2) from converted parameters on the pipeline's batches give the
reference's losses, metrics and parameters within atol = rtol = 1e-4;
checkpoints round-trip bf16 bits, commit atomically, reject shape and
dtype mismatches, collect old steps and read the reference's layout; a
trainer resumes the saved parameters bit for bit; the pipeline's batches
are the reference's bytes; the launcher trains SMOKE on the CPU.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShape  # noqa: E402
from repro.data import SyntheticPipeline as JaxPipeline  # noqa: E402
from repro.kernels import planned as jp  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.train.loop import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train.step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.kernels import planned as tp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               cosine_schedule, global_norm)
from repro_torch.parallel import mesh as pm  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.train.loop import batch_tensors  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

from test_torch_train import (MODELLED, ROOT, TOL, port_cfg,  # noqa: E402
                              to_np, within_bf16)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(grads, state, params, lr=0.1,
                                        weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.5
    assert int(state.count) == 200


def test_adamw_clipping():
    params = {"w": torch.ones(4)}
    _, _, metrics = adamw_update({"w": torch.full((4,), 1e6)},
                                 adamw_init(params), params, lr=0.1,
                                 clip_norm=1.0)
    assert float(metrics["clip_scale"]) < 1e-5


def test_cosine_schedule_shape():
    def lr(s):
        return float(cosine_schedule(s, base_lr=1.0, warmup=10, total=100))

    assert lr(0) == 0.0
    assert abs(lr(10) - 1.0) < 1e-6
    assert lr(100) == pytest.approx(0.1, abs=1e-6)


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(t)) == pytest.approx(5.0)


@pytest.mark.parametrize("clip", [1.0, 1e-3], ids=["no-clip", "clip"])
def test_adamw_matches_reference(clip):
    """Two AdamW steps on a float32 and a bfloat16 leaf: parameters,
    moments, the norm and the clip scale equal the reference's."""
    rng = np.random.default_rng(5)
    p_np = {"a": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    g_np = [{k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
             for k, v in p_np.items()} for _ in range(2)]
    jparams = {"a": jnp.asarray(p_np["a"]),
               "b": jnp.asarray(p_np["b"]).astype(jnp.bfloat16)}
    tparams = {"a": torch.from_numpy(p_np["a"]),
               "b": torch.from_numpy(p_np["b"]).to(torch.bfloat16)}
    jstate, tstate = jopt.adamw_init(jparams), adamw_init(tparams)
    for step, g in enumerate(g_np):
        lr = 1e-2 * (step + 1)
        jg = {"a": jnp.asarray(g["a"]),
              "b": jnp.asarray(g["b"]).astype(jnp.bfloat16)}
        tg = {"a": torch.from_numpy(g["a"]),
              "b": torch.from_numpy(g["b"]).to(torch.bfloat16)}
        jparams, jstate, jm = jopt.adamw_update(jg, jstate, jparams, lr=lr,
                                                clip_norm=clip)
        tparams, tstate, tm = adamw_update(tg, tstate, tparams, lr=lr,
                                           clip_norm=clip)
        for key in ("grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
        if clip < 1:
            assert float(tm["clip_scale"]) < 1
        np.testing.assert_allclose(to_np(tparams["a"]),
                                   np.asarray(jparams["a"]), rtol=1e-6,
                                   atol=1e-7)
        # one bf16 step where the fp32 values straddle a rounding boundary
        within_bf16(to_np(tparams["b"]),
                    np.asarray(jparams["b"].astype(jnp.float32)))
        for mom in ("m", "v"):
            for key in ("a", "b"):
                np.testing.assert_allclose(
                    to_np(getattr(tstate, mom)[key]),
                    np.asarray(getattr(jstate, mom)[key]), rtol=1e-5,
                    atol=1e-9)
        assert int(tstate.count) == int(jstate.count) == step + 1
    assert tparams["b"].dtype == torch.bfloat16


@pytest.mark.parametrize("step", [0, 1, 5, 10, 40, 100, 150])
def test_cosine_schedule_matches_reference(step):
    kw = dict(base_lr=3e-4, warmup=10, total=100)
    np.testing.assert_allclose(
        float(cosine_schedule(step, **kw)),
        float(jopt.cosine_schedule(jnp.asarray(step), **kw)), rtol=1e-6)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,accum", [("qwen1.5-0.5b", 1),
                                        ("qwen1.5-0.5b", 2),
                                        ("whisper-base", 1)])
def test_train_steps_match_reference(arch, accum):
    """Three steps of ``make_train_step`` from converted parameters on the
    pipeline's batches: every loss, metric and parameter within 1e-4 of
    the reference's steps."""
    cfg = dataclasses.replace(jax_smoke(arch), grad_accum=accum)
    tcfg_j = JaxTrainConfig(base_lr=1e-3, warmup=2, total_steps=10)
    tcfg_t = TrainConfig(base_lr=1e-3, warmup=2, total_steps=10)
    b, s = 4, 16
    jpipe = JaxPipeline(cfg, JaxShape("t", "train", s, b), seed=1)
    tpipe = SyntheticPipeline(port_cfg(cfg), ShapeSpec("t", "train", s, b),
                              seed=1)
    japi = jax_build(cfg)
    jparams = japi.init(jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              port_cfg(cfg), "cpu")
    jstep = jax.jit(jax_train_step(japi, cfg, tcfg=tcfg_j))
    tstep = make_train_step(build_model(port_cfg(cfg), "cpu"),
                            port_cfg(cfg), tcfg=tcfg_t)
    jstate, tstate = jopt.adamw_init(jparams), adamw_init(tparams)
    tp.reset_configuration()
    for step in range(3):
        with jp.override(policy=MODELLED):
            jparams, jstate, jm = jstep(
                jparams, jstate, {k: jnp.asarray(v) for k, v in
                                  jpipe.batch(step).items()},
                jnp.asarray(step))
        tparams, tstate, tm = tstep(tparams, tstate,
                                    batch_tensors(tpipe.batch(step), "cpu"),
                                    step)
        for key in ("loss", "lr", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       err_msg=key, **TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jparams), port_cfg(cfg),
                           "cpu")
    for path, g, w in zip(tree.paths(tparams), tree.leaves(tparams),
                          tree.leaves(want)):
        np.testing.assert_allclose(to_np(g), to_np(w), err_msg=path, **TOL)


# ---------------------------------------------------------------------------
# checkpoints and the trainer
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    from repro_torch.ckpt import (latest_step, restore_checkpoint,
                                  save_checkpoint)

    bits = torch.tensor([1.0, -2.5, 3.140625, 1e-3]).to(torch.bfloat16)
    t = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
         "b": {"c": bits}, "l": [torch.ones(3)]}
    save_checkpoint(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    out = restore_checkpoint(str(tmp_path), 7, t)
    assert torch.equal(out["a"], t["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["c"].view(torch.int16), bits.view(torch.int16))
    assert torch.equal(out["l"][0], t["l"][0])


def test_checkpoint_atomic_no_partial(tmp_path):
    from repro_torch.ckpt import latest_step, save_checkpoint

    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert latest_step(str(tmp_path)) == 1


@pytest.mark.parametrize("like", [torch.zeros(3),
                                  torch.zeros(2, dtype=torch.bfloat16)],
                         ids=["shape", "dtype"])
def test_checkpoint_mismatch_rejected(tmp_path, like):
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint

    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, {"x": like})


def test_async_checkpointer_gc(tmp_path):
    from repro_torch.ckpt import AsyncCheckpointer, latest_step

    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        x = torch.full((2,), float(s))
        ck.save(s, {"x": x})
        x.zero_()  # the host copy was taken at save()
    ck.close()
    steps = sorted(int(p.split("_")[1]) for p in os.listdir(tmp_path)
                   if p.startswith("step_"))
    assert steps == [3, 4]
    assert latest_step(str(tmp_path)) == 4
    from repro_torch.ckpt import restore_checkpoint

    out = restore_checkpoint(str(tmp_path), 4, {"x": torch.zeros(2)})
    assert torch.equal(out["x"], torch.full((2,), 4.0))


def test_checkpoint_reads_the_reference_layout(tmp_path):
    """A checkpoint the reference wrote (bf16 as raw bytes) restores into
    the port's tree with the same bits."""
    from repro.ckpt import save_checkpoint as jax_save
    from repro_torch.ckpt import restore_checkpoint

    vals = np.asarray([1.0, -0.5, 7.0], np.float32)
    jax_save(str(tmp_path), 3, {"a": jnp.asarray(vals).astype(jnp.bfloat16),
                                "b": jnp.arange(4, dtype=jnp.int32)})
    out = restore_checkpoint(str(tmp_path), 3, {
        "a": torch.zeros(3, dtype=torch.bfloat16),
        "b": torch.zeros(4, dtype=torch.int32)})
    np.testing.assert_array_equal(to_np(out["a"]), vals)
    np.testing.assert_array_equal(out["b"].numpy(), np.arange(4))


def test_trainer_checkpoint_resume_exact(tmp_path):
    from repro_torch.ckpt import latest_step, restore_checkpoint

    cfg = get_smoke_config("qwen1.5-0.5b")
    shape = ShapeSpec("t", "train", 32, 4)
    tc = TrainConfig(ckpt_every=4, log_every=100, total_steps=50,
                     base_lr=1e-3)
    d = str(tmp_path)
    p1, _, h1 = Trainer(cfg, shape, ckpt_dir=d, tcfg=tc,
                        device="cpu").run(8, resume=False)
    assert len(h1) == 8 and all(np.isfinite(h1))
    like, _ = Trainer(cfg, shape, ckpt_dir=d, tcfg=tc,
                      device="cpu").init_state()
    saved = restore_checkpoint(d, 8, {"p": like})["p"]
    for a, b in zip(tree.leaves(saved), tree.leaves(p1)):
        assert torch.equal(a, b)
    # a fresh trainer resumes from step 8 and sees the same data
    d_mesh = str(tmp_path / "mesh")
    shutil.copytree(d, d_mesh)
    t2 = Trainer(cfg, shape, ckpt_dir=d, tcfg=tc, device="cpu")
    p2, _, h2 = t2.run(2, resume=True)
    assert latest_step(d) == 10 and len(h2) == 2
    # the same resume on a logical (2, 2) CPU mesh: the parameters restored
    # onto it, the same losses and parameters bit for bit (qwen has no MoE
    # block, the one block a mesh computes differently)
    with pm.logical_devices(4):
        t3 = Trainer(cfg, shape, ckpt_dir=d_mesh, tcfg=tc,
                     mesh=pm.make_mesh((2, 2), ("data", "model")),
                     device="cpu")
        p3, _, h3 = t3.run(2, resume=True)
    assert latest_step(d_mesh) == 10 and h3 == h2
    for a, b in zip(tree.leaves(p3), tree.leaves(p2)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# pipeline and launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-base",
                                  "llava-next-mistral-7b"])
def test_pipeline_bytes_equal_reference(arch):
    cfg = jax_smoke(arch)
    jshape = JaxShape("t", "train", 48, 4)
    for host in (0, 1):
        want = JaxPipeline(cfg, jshape, seed=3, n_hosts=2, host_id=host)
        got = SyntheticPipeline(port_cfg(cfg), ShapeSpec("t", "train", 48, 4),
                                seed=3, n_hosts=2, host_id=host)
        for step in range(4):
            wb, gb = want.batch(step), got.batch(step)
            assert set(wb) == set(gb)
            for key in wb:
                assert gb[key].dtype == wb[key].dtype, key
                assert gb[key].tobytes() == wb[key].tobytes(), key


def test_launcher_trains_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1.5-0.5b", "--smoke", "--steps", "2", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "done"
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000002"]
