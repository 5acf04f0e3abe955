"""The port's SSM family (mamba2-780m) against the JAX reference.

mamba2's SMOKE config (float32, 2 layers, d 64, d_inner 128 in 8 heads
of 16, state 16, chunks of 8, conv 4) on numpy operands and on
parameters the reference draws (``PRNGKey``) and
``convert.params_from_jax`` carries over.  The Mamba2 block's parts
(``_causal_conv``, ``_ssd_chunked``, ``apply_mamba``,
``apply_mamba_step``) are fp32 on both sides and held within ``atol =
rtol = 1e-5``: the same products, summed in another order (the cumsum,
the einsums' contractions; ~1e-6 observed).  Whole-model logits keep the
dense tests' ``atol = rtol = 1e-4`` on an fp32 cache.  Greedy tokens
must be equal: the port's slot and paged engines against the reference's
slot and paged engines at 1 and 4 lanes (the paged one also at 2, as
the reference's ``test_paged_matches_slot_across_families``), and slot
== paged at 4 lanes (SSM lanes do not couple).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.autotune import PlanPolicy as JaxPolicy  # noqa: E402
from repro.kernels import planned as jp  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import hybrid as JH  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.serve import PagedServeEngine as JaxPaged  # noqa: E402
from repro.serve import ServeEngine as JaxSlot  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import init_params, params_from_jax  # noqa: E402
from repro_torch.kernels import planned as tp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serve import make_engine  # noqa: E402

ARCH = "mamba2-780m"
#: the Mamba2 block's parts in fp32; whole-model logits
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
JPOLICY = JaxPolicy(mode="modelled")

_PARAMS: dict = {}


def _params():
    """(port cfg, reference cfg, port params, reference params)."""
    if not _PARAMS:
        cfg, jcfg = get_smoke_config(ARCH), jax_smoke(ARCH)
        jparams = JH.init_params(jax.random.PRNGKey(42), jcfg)
        _PARAMS["m"] = (cfg, jcfg, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"), jparams)
    return _PARAMS["m"]


def _block():
    """One Mamba2 block's parameters from the reference's ``init_mamba``."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke(ARCH)
    jparams = JS.init_mamba(jax.random.PRNGKey(3), jcfg)
    tparams = {k: torch.from_numpy(np.asarray(v).copy())
               for k, v in jparams.items()}
    return cfg, jcfg, tparams, jparams


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, tol=BLOCK_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# the Mamba2 block's parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 3, 11])
def test_causal_conv_matches_the_reference(s):
    cfg, jcfg, _, _ = _block()
    c = 24
    xbc, w, b = _x((2, s, c), 1), _x((cfg.ssm_conv, c), 2), _x((c,), 3)
    got = TS._causal_conv(cfg, *map(torch.from_numpy, (xbc, w, b)))
    _close(got, JS._causal_conv(jcfg, *map(jnp.asarray, (xbc, w, b))))


def _ssd_operands(cfg, s, seed):
    nh, hp, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    x = _x((2, s, nh, hp), seed)
    dt = np.log1p(np.exp(_x((2, s, nh), seed + 1))).astype(np.float32)
    b, c = _x((2, s, n), seed + 2), _x((2, s, n), seed + 3)
    a = -np.linspace(1.0, 16.0, nh).astype(np.float32)
    return x, dt, b, c, a


@pytest.mark.parametrize("with_state", [False, True], ids=["zero", "given"])
@pytest.mark.parametrize("s", [5, 8, 13, 24],
                         ids=["below-Q", "at-Q", "ragged", "three-chunks"])
def test_ssd_chunked_matches_the_reference(s, with_state):
    """S below, at and above the chunk (Q = 8), a ragged tail zero-padded,
    from a zero state and from a given one: the outputs and the final
    state."""
    cfg, jcfg, _, _ = _block()
    ops = _ssd_operands(cfg, s, seed=4)
    state = (_x((2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), 9, 0.5)
             if with_state else None)
    y, fin = TS._ssd_chunked(
        cfg, *map(torch.from_numpy, ops),
        None if state is None else torch.from_numpy(state))
    jy, jfin = JS._ssd_chunked(
        jcfg, *map(jnp.asarray, ops),
        None if state is None else jnp.asarray(state))
    assert y.shape == (2, s, cfg.ssm_heads, cfg.ssm_headdim)
    _close(y, jy)
    _close(fin, jfin)
    assert torch.isfinite(y).all()


def test_ssd_masked_segments_never_reach_exp():
    """Steep decays make the masked (future) segments' exponents huge: the
    double where keeps them out of ``exp``, so no inf·0 NaN appears."""
    cfg, _, _, _ = _block()
    x, dt, b, c, a = _ssd_operands(cfg, 8, seed=5)
    y, fin = TS._ssd_chunked(cfg, *map(torch.from_numpy,
                                       (x, dt * 40, b, c, a * 4)))
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()


@pytest.mark.parametrize("s", [6, 13])
def test_apply_mamba_with_state_and_cache_matches_the_reference(s):
    cfg, jcfg, params, jparams = _block()
    x = _x((2, s, cfg.d_model), 6)
    state = _x((2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), 7, 0.3)
    with torch.no_grad():
        y = TS.apply_mamba(params, cfg, torch.from_numpy(x))
        ys, fin = TS.apply_mamba(params, cfg, torch.from_numpy(x),
                                 ssm_state=torch.from_numpy(state),
                                 return_state=True)
        yc, fc, tail = TS.apply_mamba(params, cfg, torch.from_numpy(x),
                                      return_cache=True)
    _close(y, JS.apply_mamba(jparams, jcfg, jnp.asarray(x)))
    jys, jfin = JS.apply_mamba(jparams, jcfg, jnp.asarray(x),
                               ssm_state=jnp.asarray(state),
                               return_state=True)
    _close(ys, jys)
    _close(fin, jfin)
    jyc, jfc, jtail = JS.apply_mamba(jparams, jcfg, jnp.asarray(x),
                                     return_cache=True)
    _close(yc, jyc)
    _close(fc, jfc)
    assert tail.shape == (2, cfg.ssm_conv - 1,
                          cfg.d_inner + 2 * cfg.ssm_state)
    _close(tail, jtail)


def test_apply_mamba_step_matches_the_reference():
    cfg, jcfg, params, jparams = _block()
    x = _x((3, 1, cfg.d_model), 8)
    conv = _x((3, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state), 9)
    ssm = _x((3, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), 10, 0.3)
    with torch.no_grad():
        y, cache = TS.apply_mamba_step(
            params, cfg, torch.from_numpy(x),
            {"conv": torch.from_numpy(conv), "ssm": torch.from_numpy(ssm)})
    jy, jcache = JS.apply_mamba_step(
        jparams, jcfg, jnp.asarray(x),
        {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)})
    _close(y, jy)
    _close(cache["conv"], jcache["conv"])
    _close(cache["ssm"], jcache["ssm"])
    assert cache["conv"].dtype == torch.float32


@pytest.mark.parametrize("s", [2, 3, 13, 17])
def test_chunked_state_equals_the_recurrent_steps(s):
    """The chunked prefill's final state and conv tail against the same
    tokens fed one at a time through ``apply_mamba_step`` from a zero
    cache, and the next token's output from either cache (prompts
    shorter than the conv window included: their tail is zero-padded as
    a zero cache would hold it)."""
    cfg, _, params, _ = _block()
    x = torch.from_numpy(_x((2, s + 1, cfg.d_model), 11))
    with torch.no_grad():
        _, state, tail = TS.apply_mamba(params, cfg, x[:, :s],
                                        return_cache=True)
        cache = TS.init_mamba_cache(cfg, 2, device="cpu")
        for t in range(s):
            _, cache = TS.apply_mamba_step(params, cfg, x[:, t:t + 1], cache)
        np.testing.assert_allclose(state.numpy(), cache["ssm"].numpy(),
                                   **BLOCK_TOL)
        np.testing.assert_allclose(tail.numpy(), cache["conv"].numpy(),
                                   **BLOCK_TOL)
        nxt, _ = TS.apply_mamba_step(params, cfg, x[:, s:],
                                     {"conv": tail, "ssm": state})
        want = TS.apply_mamba(params, cfg, x)[:, s:]
    np.testing.assert_allclose(nxt.numpy(), want.numpy(), **BLOCK_TOL)


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, 0.0, 19.0, 21.0, 40.0])
    np.testing.assert_array_equal(
        TS.softplus(x).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))))


# ---------------------------------------------------------------------------
# parameters and the model
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + str(k)] = v
    return out


def test_params_from_jax_round_trip():
    """The reference's stacked trunk becomes one dict a layer, every
    leaf's bits kept; the port's own ``init_params`` draws the same tree
    of shapes and dtypes."""
    cfg, _, params, jparams = _params()
    assert len(params["trunk"]) == cfg.n_layers
    for i, lp in enumerate(params["trunk"]):
        jl = jax.tree.map(lambda a, i=i: np.asarray(a)[i], jparams["trunk"])
        flat, jflat = _flatten(lp), _flatten(jl)
        assert flat.keys() == jflat.keys()
        for name, v in flat.items():
            np.testing.assert_array_equal(v.numpy(), jflat[name])
    for k in ("embed", "ln_f", "lm_head"):
        for name, v in _flatten({k: params[k]}).items():
            np.testing.assert_array_equal(
                v.numpy(), _flatten({k: jax.tree.map(np.asarray,
                                                     jparams[k])})[name])
    assert "shared" not in params
    drawn = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = {k: (tuple(v.shape), v.dtype) for k, v in _flatten(params).items()}
    assert {k: (tuple(v.shape), v.dtype)
            for k, v in _flatten(drawn).items()} == want
    m = drawn["trunk"][0]["mamba"]
    np.testing.assert_allclose(
        m["A_log"].numpy(), np.log(np.linspace(1, 16, cfg.ssm_heads)),
        rtol=1e-6)
    assert m["D"].eq(1).all() and m["dt_bias"].eq(0).all()


def test_prefill_and_decode_logits_match_the_reference():
    """Forward hidden states, prefill logits and three decode steps over
    a 2-lane fp32 cache, and the cache's conv and SSM states."""
    cfg, jcfg, params, jparams = _params()
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
             for _ in range(3)]
    with jp.override(policy=JPOLICY):
        jh = JH.forward(jparams, jcfg, jnp.asarray(tokens))
        jl, jc = JH.prefill(jparams, jcfg, jnp.asarray(tokens), 32,
                            cache_dtype=jnp.float32)
        jdec = []
        for nt in steps:
            lg, jc = JH.decode_step(jparams, jcfg, jc, jnp.asarray(nt))
            jdec.append(np.asarray(lg))
    tp.reset_configuration()
    with torch.no_grad():
        th = TH.forward(params, cfg, torch.from_numpy(tokens))
        tl, tc = TH.prefill(params, cfg, torch.from_numpy(tokens), 32,
                            cache_dtype=torch.float32)
        assert tc["pos"].tolist() == [13, 13]
        tdec = [TH.decode_step(params, cfg, tc, torch.from_numpy(nt))[0]
                .numpy().copy() for nt in steps]
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LOGIT_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for got, want in zip(tdec, jdec):
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert tc.keys() == jc.keys() == {"conv", "ssm", "pos"}
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   **LOGIT_TOL)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [16, 16]


def test_build_model_serves_ssm_and_refuses_a_bucketed_prefill():
    cfg = get_config(ARCH)
    api = build_model(cfg)
    assert api.device.type == "cuda"  # the card is the default
    assert api.paged_layout() == {"conv": "lane", "ssm": "lane"}
    scfg, jcfg, params, jparams = _params()
    tapi = build_model(scfg, "cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="exact prompt length"):
        tapi.prefill(params, batch, 16, last_index=torch.tensor([5]))
    with pytest.raises(ValueError, match="exact prompt length"):
        jax_build(jcfg).prefill(jparams, {"tokens": jnp.zeros((1, 8),
                                                              jnp.int32)},
                                16, last_index=jnp.asarray([5]))
    pools = tapi.paged_init(5, 8, 3)
    assert pools.keys() == {"conv", "ssm"}
    assert pools["conv"].shape == (2, 3, 3, 160)
    assert pools["conv"].dtype == torch.bfloat16
    assert pools["ssm"].shape == (2, 3, 8, 16, 16)
    assert pools["ssm"].dtype == torch.float32


@pytest.mark.parametrize("enabled", [True, False],
                         ids=["planned", "disabled"])
def test_sites_plan_as_the_reference(enabled):
    """A prefill and a decode step: the reference's one planned site,
    ``lm_head``, at the same shapes with the same plan and no fallback;
    with planning disabled, the same fallback with the same reason."""
    cfg, jcfg, params, jparams = _params()
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (2, 9))
    step = np.zeros((2, 1), np.int32)
    jp.planned_report_clear()
    with jp.override(policy=JPOLICY, enabled=enabled):
        _, jc = JH.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32), 16)
        JH.decode_step(jparams, jcfg, jc, jnp.asarray(step))
    want = jp.planned_report()
    tp.reset_configuration()
    tp.planned_report_clear()
    with torch.no_grad(), tp.override(enabled=enabled):
        _, tc = TH.prefill(params, cfg, torch.from_numpy(tokens), 16)
        TH.decode_step(params, cfg, tc, torch.from_numpy(step))
    got = tp.planned_report()
    assert set(got) == set(want) == {"lm_head"}
    for site, st in got.items():
        ref = want[site]
        assert bool(st["planned"]) == bool(ref["planned"]) == enabled
        assert bool(st["fallback"]) == bool(ref["fallback"]) != enabled
        assert set(st["reasons"]) == set(ref["reasons"])
        assert set(st["shapes"]) == set(ref["shapes"]) == {
            str((2, cfg.vocab, cfg.d_model))}
        assert st["last_plan"] == ref["last_plan"]


# ---------------------------------------------------------------------------
# the engines: greedy tokens equal
# ---------------------------------------------------------------------------

def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


def _drain(eng, prompts, max_new=5):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: list(r.output) for r in eng.run_until_drained(4000)}


def _engine(cfg, params, kind, **kw):
    eng = make_engine(cfg, kind=kind, device="cpu", **kw)
    eng.load(params)
    return eng


PROMPT_LENS = [5, 9, 13, 4, 17, 7]


@pytest.mark.parametrize("lanes", [1, 4])
def test_slot_engine_matches_the_reference_slot_engine(lanes):
    cfg, jcfg, params, jparams = _params()
    prompts = _prompts(cfg, PROMPT_LENS, seed=3)
    got = _drain(_engine(cfg, params, "slot", max_slots=lanes, max_seq=64),
                 prompts)
    jeng = JaxSlot(jcfg, max_slots=lanes, max_seq=64, policy=JPOLICY)
    jeng.load(jparams)
    assert got == _drain(jeng, prompts)


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_paged_engine_matches_the_reference_paged_engine(lanes):
    cfg, jcfg, params, jparams = _params()
    prompts = _prompts(cfg, PROMPT_LENS, seed=3)
    eng = _engine(cfg, params, "paged", max_lanes=lanes, max_seq=64,
                  block_size=8)
    got = _drain(eng, prompts)
    jeng = JaxPaged(jcfg, max_lanes=lanes, max_seq=64, block_size=8,
                    policy=JPOLICY)
    jeng.load(jparams)
    assert got == _drain(jeng, prompts)
    assert eng.stats["decode_compiles"] == 1
    assert eng.stats["prefill_compiles"] == jeng.stats["prefill_compiles"]
    # no paged leaf: the block tables are host bookkeeping only
    assert eng.kv.layout == {"conv": "lane", "ssm": "lane"}


def test_slot_equals_paged_at_four_lanes():
    """The reference's guarantee (tests/test_paged_serving.py,
    ``test_paged_matches_slot_across_families``) on the port's SSM, at 4
    lanes: a lane's state depends on its own tokens alone."""
    cfg, _, params, _ = _params()
    prompts = _prompts(cfg, [5, 9, 7, 12, 3, 16], seed=1)
    slot = _drain(_engine(cfg, params, "slot", max_slots=4, max_seq=64),
                  prompts, max_new=7)
    paged = _drain(_engine(cfg, params, "paged", max_lanes=4, max_seq=64,
                           block_size=8), prompts, max_new=7)
    assert slot == paged


def test_paged_pools_are_written_in_place_never_replaced():
    """A paged decode step writes the conv and SSM states into the very
    pool tensors the engine built (the captured graph holds their
    addresses) and returns them; a drain replaces none."""
    cfg, _, params, _ = _params()
    eng = _engine(cfg, params, "paged", max_lanes=2, max_seq=64,
                  block_size=8)
    ptrs = {k: v.data_ptr() for k, v in eng.kv.pools.items()}
    before = {k: v.clone() for k, v in eng.kv.pools.items()}
    with pytest.raises(AttributeError, match="in place"):
        eng.kv.pools = dict(eng.kv.pools)
    tokens = torch.ones((2, 1), dtype=torch.int32)
    tables = torch.zeros((2, 8), dtype=torch.int32)
    pos = torch.tensor([3, 0], dtype=torch.int32)
    with torch.no_grad():
        _, out = eng.api.paged_decode(params, eng.kv.pools, tokens, tables,
                                      pos, torch.tensor([True, False]))
    assert out is eng.kv.pools
    for k, v in eng.kv.pools.items():
        assert v.data_ptr() == ptrs[k]
        # both lanes advance, the inactive one too (the next admission
        # overwrites it), as in the reference
        assert not torch.equal(v[:, 0], before[k][:, 0]), k
        assert not torch.equal(v[:, 1], before[k][:, 1]), k
    _drain(eng, _prompts(cfg, [5, 9, 7], seed=2))
    assert {k: v.data_ptr() for k, v in eng.kv.pools.items()} == ptrs
