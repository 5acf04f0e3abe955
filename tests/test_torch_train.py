"""The port's training path against the JAX package on the CPU.

Operands are numpy draws from a seed; parameters cross over through
``convert.params_from_jax`` and so do the reference's gradient trees.
The JAX facade runs under the modelled policy, as the port's.

* The facade's three autograd Functions (``_MMPlanned``, ``_BMMPlanned``,
  ``_MLPPairPlanned``): gradients against ``jax.grad`` through the
  reference's ``custom_vjp``s, float32 within atol = rtol = 1e-5, bf16
  within ``2^-7 |ref| + 1e-3`` (one bf16 rounding of an output, fp32 sums
  taken in another order); the ``/bwd_*`` sites' plans and fallback
  reasons equal the reference's.
* ``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` at
  SMOKE width (qwen1.5-0.5b, qwen3-32b, whisper-base; float32) within
  atol = rtol = 1e-4, with and without ``logit_chunk``; ``remat`` "full"
  and "none" give the same gradients.
The optimizer, the train step, checkpoints, the trainer, the pipeline
and the launcher are in ``test_torch_trainer.py``.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeSpec as JaxShape  # noqa: E402
from repro.core.autotune import PlanPolicy as JaxPolicy  # noqa: E402
from repro.data import SyntheticPipeline as JaxPipeline  # noqa: E402
from repro.kernels import planned as jp  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import planned as tp  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.loop import batch_tensors  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
MODELLED = JaxPolicy(mode="modelled")
SHAPE = (2, 16)  # batch, sequence of the loss and train-step checks


def port_cfg(cfg):
    """The port's ModelConfig with the reference config's fields."""
    return ModelConfig(**dataclasses.asdict(cfg))


def within_bf16(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = 2.0 ** -7 * np.abs(want) + 1e-3
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def to_np(t):
    return t.detach().float().numpy()


def jax_array(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def decisions(report):
    """Each site's decision: its shapes, whether it planned and fell back,
    and its fallback reasons (the counts differ: the port counts every
    call, the reference once per trace, and a site's last plan depends on
    the order of its calls)."""
    return {site: (sorted(st["shapes"]), st["planned"] > 0,
                   st["fallback"] > 0, sorted(st["reasons"]))
            for site, st in report.items()}


def observed_plans(pkg):
    """Every (kind, shape, dtype) the package's facade planned since its
    ``observed_clear``, with the plan it resolves to."""
    with pkg.override(policy=MODELLED if pkg is jp else None):
        return {req: getattr(pkg.plan_for(*req), "describe", str)()
                for req in pkg.observed_requests()}


def assert_same_decisions(jrep, jobs, trep, tobs):
    assert decisions(trep) == decisions(jrep)
    assert tobs == jobs


# ---------------------------------------------------------------------------
# the autograd Functions against the reference's custom_vjps
# ---------------------------------------------------------------------------

def _draws(seed, *shapes):
    """N(0, 1) for the first operand and the cotangent (the last), N(0,
    1/fan_in) for the others, as the models draw their weights (so the
    outputs stay O(1) and fp32's absolute rounding with them)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(shapes):
        scale = 1.0 if i in (0, len(shapes) - 1) else s[-2] ** -0.5 \
            if len(s) > 1 else 0.1
        out.append((rng.standard_normal(s) * scale).astype(np.float32))
    return out


def _facade_grads(kind, args, cot, dtype_name, **kw):
    """(reference grads, port grads, reference report, port report) of
    ``sum(out * cot)`` through one facade surface."""
    jfn = {"dense": jp.planned_dense, "bmm": jp.planned_bmm,
           "pair": jp.planned_mlp_pair}[kind]
    tfn = {"dense": tp.planned_dense, "bmm": tp.planned_bmm,
           "pair": tp.planned_mlp_pair}[kind]
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)

    def jloss(*a):
        return jnp.sum(jfn(*a, **kw).astype(jnp.float32) * cot)

    jp.planned_report_clear()
    jp.observed_clear()
    with jp.override(policy=MODELLED):
        jargs = [jax_array(a, jdt) for a in args]
        jgrads = jax.grad(jloss, argnums=tuple(range(len(args))))(*jargs)
    jrep = (jp.planned_report(), observed_plans(jp))
    tp.reset_configuration()
    tp.planned_report_clear()
    tp.observed_clear()
    targs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in args]
    tkw = dict(kw)
    if "out_dtype" in tkw:
        tkw["out_dtype"] = getattr(torch, jnp.dtype(kw["out_dtype"]).name)
    out = tfn(*targs, **tkw)
    tgrads = torch.autograd.grad(
        (out.float() * torch.from_numpy(cot)).sum(), targs)
    return ([np.asarray(g.astype(jnp.float32)) for g in jgrads],
            [to_np(g) for g in tgrads], jrep,
            (tp.planned_report(), observed_plans(tp)))


FACADE_CASES = [
    ("dense", ((24, 40), (40, 56)), (24, 56), {}),
    ("dense", ((2, 9, 40), (40, 24)), (2, 9, 24), {}),
    ("bmm", ((4, 18, 8), (4, 8, 18)), (4, 18, 18), {}),
    ("bmm", ((4, 18, 8), (4, 8, 18)), (4, 18, 18),
     {"out_dtype": jnp.float32}),
    ("pair", ((20, 32), (32, 48), (48,), (48, 24)), (20, 24),
     {"act": "gelu"}),
    ("pair", ((20, 32), (32, 48), (48,), (48, 24)), (20, 24),
     {"act": "silu"}),
    ("pair", ((20, 32), (32, 48), (48,), (48, 24)), (20, 24),
     {"act": "relu"}),
]
FACADE_IDS = ["mm", "mm-3d", "bmm", "bmm-fp32-out", "pair-gelu",
              "pair-silu", "pair-relu"]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,shapes,cot_shape,kw", FACADE_CASES,
                         ids=FACADE_IDS)
def test_facade_gradients_match_reference(kind, shapes, cot_shape, kw,
                                          dtype_name):
    """Every gradient of a planned mm, bmm (its fp32 flush too) and MLP
    pair equals ``jax.grad`` through the reference's custom_vjp, and
    every forward and ``/bwd_*`` site decides as the reference's.

    bf16 gelu and silu pairs are the exception to the one-rounding bound:
    the reference's bf16 activation and its vjp round every elementwise
    op to bf16 (about half of the values of ``jax.nn.gelu`` on bf16 then
    differ from one rounding of the fp32 result), where PyTorch's round
    once.  There both sides are held to the same gradients computed in
    float32 from the same bf16 inputs, and the port may not stray
    farther than the reference does (times 1.5, plus 1e-3)."""
    *args, cot = _draws(len(shapes), *shapes, cot_shape)
    want, got, jrep, trep = _facade_grads(kind, args, cot, dtype_name, **kw)
    if dtype_name == "bfloat16" and kw.get("act") in ("gelu", "silu"):
        rounded = [to_np(torch.from_numpy(a).to(torch.bfloat16))
                   for a in args]
        exact, *_ = _facade_grads(kind, rounded, cot, "float32", **kw)
        for g, w, e in zip(got, want, exact):
            ref_err = np.abs(w - e).max()
            assert np.abs(g - e).max() <= 1.5 * ref_err + 1e-3
    else:
        for g, w in zip(got, want):
            if dtype_name == "float32":
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
            else:
                within_bf16(g, w)
    assert_same_decisions(*jrep, *trep)
    assert any("/bwd_" in site for site in trep[0])


@pytest.mark.parametrize("shape,planned", [((24, 40, 56), True),
                                           ((1, 1, 1), False)],
                         ids=["plans", "infeasible"])
def test_backward_sites_decide_as_reference(shape, planned):
    """A planned mm records ``/bwd_dx`` and ``/bwd_dw`` with the
    reference's plans; a forward the mapper cannot plan falls back
    ``infeasible`` in both, and its plain autograd records no backward
    site."""
    m, n, k = shape
    x, w, cot = _draws(3, (m, k), (k, n), (m, n))
    _, _, jrep, trep = _facade_grads("dense", [x, w], cot, "float32",
                                     site="proj")
    assert_same_decisions(*jrep, *trep)
    trep = trep[0]
    if planned:
        assert {"proj", "proj/bwd_dx", "proj/bwd_dw"} == set(trep)
        assert all(st["fallback"] == 0 for st in trep.values())
    else:
        assert set(trep) == {"proj"}
        assert trep["proj"]["reasons"] == {"infeasible": 1}


@pytest.mark.parametrize("kind,node", [("dense", "_MMPlannedBackward"),
                                       ("bmm", "_BMMPlannedBackward"),
                                       ("pair", "_MLPPairPlannedBackward")])
def test_planned_output_carries_the_function_node_on_cpu(kind, node):
    """On the CPU the planned path runs inside the Function too: the
    output's graph starts at its backward node, not at the plain
    version's."""
    shapes = {"dense": ((24, 40), (40, 56)),
              "bmm": ((4, 18, 8), (4, 8, 18)),
              "pair": ((20, 32), (32, 48), (48,), (48, 24))}[kind]
    tp.reset_configuration()
    args = [torch.from_numpy(a).requires_grad_()
            for a in _draws(0, *shapes)]
    fn = {"dense": tp.planned_dense, "bmm": tp.planned_bmm,
          "pair": tp.planned_mlp_pair}[kind]
    fwd = fn(*args).grad_fn
    names = {type(fwd).__name__}
    names |= {type(f).__name__ for f, _ in fwd.next_functions if f}
    assert node in names


def test_transposed_a_operands_are_counted_copies():
    """dW's ``x^T`` is copied into padded rows once per call and counted;
    dx reads the cotangent as it is."""
    x, w, cot = _draws(4, (24, 40), (40, 56), (24, 56))
    tp.reset_configuration()
    before = dict(tp.a_copies)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (tp.planned_dense(xt, wt) * torch.from_numpy(cot)).sum().backward()
    assert tp.a_copies["calls"] - before["calls"] == 1
    assert tp.a_copies["bytes"] - before["bytes"] == 40 * 24 * 4


@pytest.mark.parametrize("n", [57, 1001])
def test_odd_cotangent_rows_are_padded_once(n):
    """A bf16 cotangent over an odd N (the head's over whisper's 51865
    logits) has rows that allow no 4-byte copy: the backward copies it
    once into rows padded to 16-byte units (``_a_rows``, counted in
    ``a_copies`` beside dW's ``x^T``), which dx reads as its A and dW as
    its B, and both gradients equal ``jax.grad`` through the reference's
    custom_vjp within one bf16 rounding."""
    x, w, cot = _draws(5, (24, 40), (40, n), (24, n))
    before = dict(tp.a_copies)
    want, got, jrep, trep = _facade_grads("dense", [x, w], cot, "bfloat16")
    assert tp.a_copies["calls"] - before["calls"] == 2
    assert tp.a_copies["bytes"] - before["bytes"] == (40 * 24 + 24 * n) * 2
    for g, ref in zip(got, want):
        within_bf16(g, ref)
    assert_same_decisions(*jrep, *trep)


@pytest.mark.parametrize("n", [75, 100])
def test_bmm_cotangent_is_cast_once_for_both_gradients(n, monkeypatch):
    """The fp32 cotangent of bf16 scores (whisper's encoder's over 1500
    frames: bf16 rows of 3000 bytes, which TMA cannot address; here rows
    of 150 and 200 bytes) is cast once, into rows padded to 16-byte units
    (``_a_rows``), which dA reads as its A and dB as its B, so that both
    products take the tensor cores' TMA producer; both gradients equal
    ``jax.grad`` through the reference's custom_vjp within one bf16
    rounding."""
    seen = {}
    dispatch = tp._dispatch_bmm

    def spy(a, b, site, out_dtype=None):
        seen[site.rsplit("/", 1)[-1]] = (a, b)
        return dispatch(a, b, site, out_dtype)

    monkeypatch.setattr(tp, "_dispatch_bmm", spy)
    *args, cot = _draws(7, (2, n, 8), (2, 8, n), (2, n, n))
    want, got, jrep, trep = _facade_grads("bmm", args, cot, "bfloat16",
                                          out_dtype=jnp.float32)
    rows = seen["bwd_da"][0]
    assert rows is seen["bwd_db"][1]
    assert rows.dtype == torch.bfloat16 and rows.shape == (2, n, n)
    assert runtime.a_pitch(rows) == -(-n // 8) * 8
    assert runtime.tc_copies(seen["bwd_db"][0], rows) == (0, 0)
    for g, ref in zip(got, want):
        within_bf16(g, ref)
    assert_same_decisions(*jrep, *trep)


# ---------------------------------------------------------------------------
# loss and gradients of the models at SMOKE width
# ---------------------------------------------------------------------------

def _batch(cfg, seed=0, shape=SHAPE):
    b, s = shape
    return JaxPipeline(cfg, JaxShape("t", "train", s, b), seed=seed).batch(0)


def _jax_loss_and_grads(cfg, seed=0, enabled=True):
    api = jax_build(cfg)
    params = api.init(jax.random.PRNGKey(seed))
    batch = _batch(cfg, seed)
    jp.planned_report_clear()
    jp.observed_clear()
    with jp.override(enabled=enabled, policy=MODELLED):
        loss, grads = jax.value_and_grad(api.loss)(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    return (params, batch, float(loss), jax.tree.map(np.asarray, grads),
            (jp.planned_report(), observed_plans(jp)))


def _port_loss_and_grads(cfg, np_params, batch):
    tcfg = port_cfg(cfg)
    params = params_from_jax(np_params, tcfg, "cpu")
    tp.reset_configuration()
    tp.planned_report_clear()
    tp.observed_clear()
    loss, grads = value_and_grad(build_model(tcfg, "cpu").loss, params,
                                 batch_tensors(batch, "cpu"))
    return float(loss), grads, (tp.planned_report(), observed_plans(tp))


LOSS_CASES = [("qwen1.5-0.5b", {}), ("qwen1.5-0.5b", {"logit_chunk": 4}),
              ("qwen3-32b", {}), ("qwen3-32b", {"logit_chunk": 4}),
              ("whisper-base", {})]
LOSS_IDS = ["qwen1.5-0.5b", "qwen1.5-0.5b-chunk4", "qwen3-32b",
            "qwen3-32b-chunk4", "whisper-base"]


@pytest.fixture(scope="module", params=LOSS_CASES, ids=LOSS_IDS)
def loss_runs(request):
    arch, change = request.param
    cfg = dataclasses.replace(jax_smoke(arch), **change)
    jparams, batch, jloss, jgrads, jrep = _jax_loss_and_grads(cfg)
    tloss, tgrads, trep = _port_loss_and_grads(
        cfg, jax.tree.map(np.asarray, jparams), batch)
    want = params_from_jax(jgrads, port_cfg(cfg), "cpu")
    return dict(cfg=cfg, jloss=jloss, tloss=tloss, want=want, got=tgrads,
                jrep=jrep, trep=trep, jparams=jparams, batch=batch)


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
    reasons as the reference's trace of ``value_and_grad``."""
    assert_same_decisions(*loss_runs["jrep"], *loss_runs["trep"])
    assert any("/bwd_" in site for site in loss_runs["trep"][0])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-base"])
def test_remat_full_and_none_give_equal_gradients(arch):
    cfg = port_cfg(jax_smoke(arch))
    gen = torch.Generator().manual_seed(3)
    params = build_model(cfg, "cpu").init(gen)
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


def test_remat_dots_and_untrained_families_raise():
    """A remat mode the reference does not have raises (``dots`` trains
    since the port's ``_dots_policy``); serving never recomputes."""
    cfg = port_cfg(dataclasses.replace(jax_smoke("qwen1.5-0.5b"),
                                       remat="all"))
    api = build_model(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(0))
    batch = batch_tensors(_batch(cfg), "cpu")
    with pytest.raises(ValueError, match="none|dots|full"):
        value_and_grad(api.loss, params, batch)
    with torch.no_grad():  # serving never recomputes
        api.prefill(params, {"tokens": batch["tokens"]}, 32)
    # every registered family trains, MLA too: deepseek-v2-236b's loss and
    # every gradient leaf through the mla.*/bwd_* sites within 1e-5 of
    # jax.value_and_grad at SMOKE in float32 (on the card it waits for the
    # multi-device item: 2 layers at full width need ~75 GB at 14 bytes a
    # parameter)
    for arch in ("olmoe-1b-7b", "mamba2-780m", "zamba2-1.2b",
                 "llava-next-mistral-7b", "deepseek-v2-236b"):
        assert build_model(get_smoke_config(arch), "cpu").loss is not None
    mla = jax_smoke("deepseek-v2-236b")
    jparams, mbatch, jloss, jgrads, jrep = _jax_loss_and_grads(mla)
    tloss, tgrads, trep = _port_loss_and_grads(
        mla, jax.tree.map(np.asarray, jparams), mbatch)
    want = params_from_jax(jgrads, port_cfg(mla), "cpu")
    np.testing.assert_allclose(tloss, jloss, atol=1e-5, rtol=1e-5)
    assert tree.paths(tgrads) == tree.paths(want)
    for path, g, w in zip(tree.paths(tgrads), tree.leaves(tgrads),
                          tree.leaves(want)):
        np.testing.assert_allclose(to_np(g), to_np(w), err_msg=path,
                                   atol=1e-5, rtol=1e-5)
    assert_same_decisions(*jrep, *trep)
    assert {f"mla.{s}/bwd_{d}" for s in ("q_down", "q_up", "kv_down",
                                         "k_rope", "k_up", "v_up", "out")
            for d in ("dx", "dw")} <= set(trep[0])


# ---------------------------------------------------------------------------
# remat="dots" and the blockwise backward
# ---------------------------------------------------------------------------

def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-base",
                                  "zamba2-1.2b"])
def test_remat_dots_gradients_equal_none_and_the_reference(arch):
    """``remat="dots"``: the loss and every gradient leaf equal the port's
    own under ``none`` (float32, 1e-6 relative L2 per leaf) and the
    reference's under ``dots`` (``jax.value_and_grad``, atol = rtol =
    1e-4; its planning off, so its policy saves the 2-D products), on the
    dense, encdec and hybrid SMOKE configs."""
    cfg = dataclasses.replace(jax_smoke(arch), remat="dots")
    jparams, batch, jloss, jgrads, _ = _jax_loss_and_grads(cfg,
                                                           enabled=False)
    np_params = jax.tree.map(np.asarray, jparams)
    tloss, tgrads, _ = _port_loss_and_grads(cfg, np_params, batch)
    nloss, ngrads, _ = _port_loss_and_grads(
        dataclasses.replace(cfg, remat="none"), np_params, batch)
    assert abs(tloss - nloss) <= 1e-6 * abs(nloss)
    for path, g, n in zip(tree.paths(tgrads), tree.leaves(tgrads),
                          tree.leaves(ngrads)):
        assert _rel_l2(g, n) <= 1e-6, path
    np.testing.assert_allclose(tloss, jloss, **TOL)
    want = params_from_jax(jgrads, port_cfg(cfg), "cpu")
    assert tree.paths(tgrads) == tree.paths(want)
    for path, g, w in zip(tree.paths(tgrads), tree.leaves(tgrads),
                          tree.leaves(want)):
        np.testing.assert_allclose(to_np(g), to_np(w), err_msg=path, **TOL)


class _OpCounts(torch.utils._python_dispatch.TorchDispatchMode):
    """aten calls that reach the kernels (a selective checkpoint's cached
    outputs never do)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_run(cfg, params, batch, remat, enabled):
    """(forward sites' decisions after loss and backward, aten mm / bmm
    calls during the backward) of one step under ``remat``."""
    api = build_model(dataclasses.replace(cfg, remat=remat), "cpu")
    live = tree.tree_map(lambda t: t.detach().requires_grad_(True), params)
    tp.planned_report_clear()
    with tp.override(enabled=enabled):
        loss = api.loss(live, batch)
        with _OpCounts() as ops:
            torch.autograd.grad(loss, tree.leaves(live))
    sites = {s: st["planned"] + st["fallback"]
             for s, st in tp.planned_report().items() if "/" not in s}
    return sites, ops.counts.get("mm", 0), ops.counts.get("bmm", 0)


def test_remat_dots_recomputes_what_the_reference_recomputes():
    """What ``dots`` saves, held to the reference's
    ``dots_with_no_batch_dims_saveable`` on one qwen SMOKE layer.

    Planning enabled: the reference saves only the block's arguments (its
    planned products are ``custom_vjp``s, which the policy cannot see
    into), and the port recomputes every planned site, as under
    ``full``.  Planning disabled: the reference saves products without
    batch dimensions and only those; the port's backward reruns none of
    the forward's ``aten.mm`` (as many as under ``none``) and every
    batched product (as many ``aten.bmm`` as under ``full``)."""
    from jax._src.ad_checkpoint import saved_residuals

    from repro.models import transformer as jtfm

    jcfg = dataclasses.replace(jax_smoke("qwen1.5-0.5b"), remat="dots",
                               n_layers=1)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: a[0], jparams["dense_layers"])
    x = jnp.asarray(_draws(5, (2, 16, jcfg.d_model))[0])
    pos = jnp.broadcast_to(jnp.arange(16), (2, 16))
    saved = {}
    for enabled in (True, False):
        # a new function each time: jax caches a trace by function
        block = jtfm._maybe_remat(lambda x, lp: jtfm._apply_block(
            lp, jcfg, x, pos, moe=False)[0], jcfg)
        with jp.override(enabled=enabled, policy=MODELLED):
            saved[enabled] = [(aval.shape, src) for aval, src in
                              saved_residuals(block, x, lp)
                              if src.startswith("output of")]
    assert saved[True] == []
    assert saved[False] and all(len(shape) == 2 and "matmul" in src
                                for shape, src in saved[False])

    cfg = port_cfg(jcfg)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = batch_tensors(_batch(cfg), "cpu")
    runs = {(remat, enabled): _backward_run(cfg, params, batch, remat,
                                            enabled)
            for remat in ("none", "full", "dots")
            for enabled in (True, False)}
    none, full, dots = (runs[(r, True)][0] for r in ("none", "full", "dots"))
    # every layer's site again in the recompute; the head is outside them
    assert dots == full == {s: n * (1 if s == "lm_head" else 2)
                            for s, n in none.items()}
    (_, mm_none, bmm_none), (_, mm_full, bmm_full), (_, mm_dots, bmm_dots) \
        = (runs[(r, False)] for r in ("none", "full", "dots"))
    assert mm_dots == mm_none < mm_full
    assert bmm_dots == bmm_full > bmm_none


def test_blockwise_backward_matches_reference_at_2112_tokens():
    """A 2-layer narrow qwen (SMOKE) over one 2112-token sequence, above
    ``BLOCKWISE_SEQ_THRESHOLD``: the port's blockwise attention in the
    forward, the remat recompute and the backward; the loss and every
    gradient leaf within 1e-4 relative L2 of the reference's
    ``jax.value_and_grad`` (its blockwise einsums, planning disabled)."""
    from unittest import mock

    from repro_torch.models import layers

    cfg = dataclasses.replace(jax_smoke("qwen1.5-0.5b"), remat="full")
    assert cfg.n_layers == 2
    api = jax_build(cfg)
    jparams = api.init(jax.random.PRNGKey(1))
    batch = _batch(cfg, seed=1, shape=(1, 2112))
    with jp.override(enabled=False):
        jloss, jgrads = jax.value_and_grad(api.loss)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg = port_cfg(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tp.reset_configuration()
    with mock.patch.object(layers, "blockwise_attention",
                           wraps=layers.blockwise_attention) as blockwise:
        tloss, tgrads = value_and_grad(build_model(tcfg, "cpu").loss,
                                       params, batch_tensors(batch, "cpu"))
    assert blockwise.call_count == 2 * cfg.n_layers  # forward, recompute
    assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg, "cpu")
    for path, g, w in zip(tree.paths(tgrads), tree.leaves(tgrads),
                          tree.leaves(want)):
        assert _rel_l2(g, w) <= 1e-4, path
