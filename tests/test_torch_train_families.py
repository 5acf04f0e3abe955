"""Training of the MoE, SSM, hybrid and vlm families against the JAX
package on the CPU (the dense and encdec families are in
``test_torch_train.py``, whose helpers this file shares).

* ``loss`` and every gradient leaf against ``jax.value_and_grad`` of the
  reference's ``api.loss`` at SMOKE width in float32 (olmoe-1b-7b with
  its load-balance term, mamba2-780m and zamba2-1.2b under
  ``remat="full"``, llava-next-mistral-7b over its text rows), within
  ``atol = rtol = 1e-4``; every forward and ``/bwd_*`` site decides as
  the reference's trace does.
* The load-balance term alone (``moe.load_balance_loss`` and the
  ``forward``'s sum over the MoE layers) against the reference's, value
  and gradient, within 1e-6.
* ``remat`` "full" and "none" give the same gradients on the SSM and
  hybrid trunks.
* Three ``grad_accum`` = 2 train steps (mamba2-780m's published value,
  and olmoe-1b-7b's) give the reference's ``make_train_step`` losses,
  metrics and parameters within 1e-4.
"""

import dataclasses

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
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.train.loop import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train.step import make_train_step as jax_train_step  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.kernels import planned as tp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train import TrainConfig  # noqa: E402
from repro_torch.train.loop import batch_tensors  # noqa: E402
from repro_torch.train.step import make_train_step, value_and_grad  # noqa: E402

from test_torch_train import (MODELLED, SHAPE, TOL, _batch,  # noqa: E402
                              _port_loss_and_grads, assert_same_decisions,
                              observed_plans, port_cfg, to_np)

AUX_TOL = dict(atol=1e-6, rtol=1e-6)
FAMILIES = ["olmoe-1b-7b", "mamba2-780m", "zamba2-1.2b",
            "llava-next-mistral-7b"]


def _jax_loss_and_grads(cfg, shape):
    api = jax_build(cfg)
    params = api.init(jax.random.PRNGKey(0))
    batch = _batch(cfg, 0, shape)
    jp.planned_report_clear()
    jp.observed_clear()
    with jp.override(policy=MODELLED):
        loss, grads = jax.value_and_grad(api.loss)(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    return (params, batch, float(loss), jax.tree.map(np.asarray, grads),
            (jp.planned_report(), observed_plans(jp)))


@pytest.fixture(scope="module", params=FAMILIES)
def loss_runs(request):
    cfg = jax_smoke(request.param)
    # a vlm's sequence counts its patch rows: SHAPE's 16 text tokens after
    # its 16 patches
    b, s = SHAPE
    shape = (b, s + cfg.vlm_patches)
    jparams, batch, jloss, jgrads, jrep = _jax_loss_and_grads(cfg, shape)
    tloss, tgrads, trep = _port_loss_and_grads(
        cfg, jax.tree.map(np.asarray, jparams), batch)
    want = params_from_jax(jgrads, port_cfg(cfg), "cpu")
    return dict(cfg=cfg, jloss=jloss, tloss=tloss, want=want, got=tgrads,
                jrep=jrep, trep=trep)


def test_loss_matches_reference(loss_runs):
    np.testing.assert_allclose(loss_runs["tloss"], loss_runs["jloss"], **TOL)


def test_every_gradient_leaf_matches_reference(loss_runs):
    got, want = loss_runs["got"], loss_runs["want"]
    assert tree.paths(got) == tree.paths(want)
    for path, g, w in zip(tree.paths(got), tree.leaves(got),
                          tree.leaves(want)):
        np.testing.assert_allclose(to_np(g), to_np(w), err_msg=path, **TOL)


def test_training_sites_decide_as_reference(loss_runs):
    """Forward and ``/bwd_*`` sites: the same shapes, plans and fallback
    reasons as the reference's trace of ``value_and_grad`` (the vlm's
    ``vlm.patch_proj`` among them).  One site differs by design: the
    patch embeddings are data, not parameters, and take no gradient, so
    the port's Function computes no ``vlm.patch_proj/bwd_dx`` (autograd
    asks for no such cotangent), where the reference's ``custom_vjp``
    plans it with every other cotangent and XLA drops it unused."""
    jrep, jobs = loss_runs["jrep"]
    sites = loss_runs["trep"][0]
    if loss_runs["cfg"].family == "vlm":
        jrep = dict(jrep)
        assert jrep.pop("vlm.patch_proj/bwd_dx")["planned"]
        assert "vlm.patch_proj/bwd_dx" not in sites
        assert "vlm.patch_proj/bwd_dw" in sites
    assert_same_decisions(jrep, jobs, *loss_runs["trep"])
    assert "lm_head/bwd_dx" in sites
    if loss_runs["cfg"].family == "moe":
        assert "moe.router/bwd_dw" in sites


# ---------------------------------------------------------------------------
# the load-balance term
# ---------------------------------------------------------------------------

def _router_logits(t, e, seed):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(
        np.float32)


@pytest.mark.parametrize("t", [1, 7, 40])
def test_load_balance_loss_matches_reference(t):
    """E · Σ f_e · P̄_e of routed logits, and its gradient with respect to
    the logits (through the softmax; the counts carry none)."""
    jcfg = jax_smoke("olmoe-1b-7b")
    cfg = port_cfg(jcfg)
    logits = _router_logits(t, cfg.moe_num_experts, t)

    def jax_aux(lg):
        _, ids, probs = JM.route(jcfg, lg)
        return JM.load_balance_loss(jcfg, probs[None], ids[None])

    jval, jgrad = jax.value_and_grad(jax_aux)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    _, ids, probs = TM.route(cfg, lg)
    val = TM.load_balance_loss(cfg, probs, ids)
    (grad,) = torch.autograd.grad(val, lg)
    np.testing.assert_allclose(float(val.detach()), float(jval), **AUX_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), **AUX_TOL)


@pytest.mark.parametrize("variant", [(0, 0), (1, 1)],
                         ids=["moe-only", "first-dense-shared"])
def test_forward_sums_the_moe_layers_terms_as_reference(variant):
    over = dict(moe_first_dense=variant[0], moe_shared_experts=variant[1])
    jcfg = dataclasses.replace(jax_smoke("olmoe-1b-7b"), **over)
    cfg = port_cfg(jcfg)
    jparams = JT.init_params(jax.random.PRNGKey(4), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 11)).astype(np.int32)
    with jp.override(policy=MODELLED):
        jh, jaux = JT.forward(jparams, jcfg, jnp.asarray(tokens))
    tp.reset_configuration()
    with torch.no_grad():
        th, aux = TT.forward(params, cfg, torch.from_numpy(tokens))
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), **AUX_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


# ---------------------------------------------------------------------------
# remat on the SSM and hybrid trunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_remat_full_and_none_give_equal_gradients(arch):
    cfg = port_cfg(jax_smoke(arch))
    assert cfg.remat == "full"
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(3))
    batch = batch_tensors(_batch(cfg), "cpu")
    tp.reset_configuration()
    runs = []
    for remat in ("full", "none"):
        api = build_model(dataclasses.replace(cfg, remat=remat), "cpu")
        runs.append(value_and_grad(api.loss, params, batch))
    (l1, g1), (l2, g2) = runs
    assert float(l1) == float(l2)
    for a, b in zip(tree.leaves(g1), tree.leaves(g2)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# grad_accum = 2 train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-780m", "olmoe-1b-7b"])
def test_grad_accum_train_steps_match_reference(arch):
    """Three ``grad_accum`` = 2 steps of ``make_train_step`` from
    converted parameters on the pipeline's batches: every loss, metric and
    parameter within 1e-4 of the reference's steps."""
    cfg = dataclasses.replace(jax_smoke(arch), grad_accum=2)
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
