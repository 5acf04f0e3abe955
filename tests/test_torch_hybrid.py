"""The port's hybrid family (zamba2-1.2b) against the JAX reference.

zamba2's SMOKE config (float32, 4 Mamba2 layers of d 64 with the one
shared attention + GLU MLP block of 4 heads after every 2, state 16,
chunks of 8) on parameters the reference draws (``PRNGKey``) and
``convert.params_from_jax`` carries over; a 5-layer variant adds a
trunk tail after the last shared application.  Whole-model logits and
the cache's states are held within ``atol = rtol = 1e-4`` on an fp32
cache, as the dense tests' (the Mamba2 blocks' fp32 parts are held to
1e-5 in ``tests/test_torch_ssm.py``).  Greedy tokens must be equal: the
port's slot and paged engines against the reference's slot and paged
engines at 1 and 4 lanes, and slot == paged at 4 lanes (the shared
block's attention masks other lanes' rows, and SSM lanes do not
couple).  Every facade site plans at the reference's shapes with its
plans, and with planning disabled falls back with its reason.
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
from repro.models import hybrid as JH  # noqa: E402
from repro.serve import PagedServeEngine as JaxPaged  # noqa: E402
from repro.serve import ServeEngine as JaxSlot  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import init_params, params_from_jax  # noqa: E402
from repro_torch.kernels import planned as tp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.serve import make_engine  # noqa: E402

ARCH = "zamba2-1.2b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
JPOLICY = JaxPolicy(mode="modelled")
#: SMOKE (2 shared applications, no tail) and a trunk tail of 1 layer
LAYERS = [4, 5]

_PARAMS: dict = {}


def _params(n_layers=4):
    """(port cfg, reference cfg, port params, reference params)."""
    if n_layers not in _PARAMS:
        cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=n_layers)
        jcfg = dataclasses.replace(jax_smoke(ARCH), n_layers=n_layers)
        jparams = JH.init_params(jax.random.PRNGKey(42), jcfg)
        _PARAMS[n_layers] = (cfg, jcfg, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"), jparams)
    return _PARAMS[n_layers]


def _flatten(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + str(k)] = v
    return out


# ---------------------------------------------------------------------------
# parameters and the model
# ---------------------------------------------------------------------------

def test_shared_applications_follow_the_reference():
    for n_layers, every in ((4, 2), (5, 2), (38, 6), (48, 0)):
        cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=n_layers,
                                  attn_every=every)
        jcfg = dataclasses.replace(jax_smoke(ARCH), n_layers=n_layers,
                                   attn_every=every)
        apps = [TH._shared_after(cfg, i) for i in range(n_layers)]
        assert TH.n_attn_apps(cfg) == JH.n_attn_apps(jcfg)
        assert [a for a in apps if a is not None] == list(
            range(TH.n_attn_apps(cfg)))
        assert all(apps[i] is None for i in
                   range(TH.n_attn_apps(cfg) * max(every, 1), n_layers))
    assert TH.n_attn_apps(get_config(ARCH)) == 6


@pytest.mark.parametrize("n_layers", LAYERS)
def test_params_from_jax_round_trip(n_layers):
    """The stacked trunk becomes one dict a layer and the shared block
    stays one, every leaf's bits kept; the port's own ``init_params``
    draws the same tree of shapes and dtypes."""
    cfg, _, params, jparams = _params(n_layers)
    assert len(params["trunk"]) == cfg.n_layers
    jflat = _flatten({k: jax.tree.map(np.asarray, v)
                      for k, v in jparams.items() if k != "trunk"})
    for i in range(cfg.n_layers):
        jflat.update(_flatten(jax.tree.map(
            lambda a, i=i: np.asarray(a)[i], jparams["trunk"]),
            f"trunk.{i}."))
    flat = _flatten(params)
    assert flat.keys() == jflat.keys()
    for name, v in flat.items():
        np.testing.assert_array_equal(v.numpy(), jflat[name])
    assert params["shared"]["attn"]["wq"].shape == (64, 64)
    assert params["shared"]["mlp"]["wd"].shape == (128, 64)
    drawn = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in _flatten(drawn).items()
            } == {k: (tuple(v.shape), v.dtype) for k, v in flat.items()}


@pytest.mark.parametrize("n_layers", LAYERS)
def test_prefill_and_decode_logits_match_the_reference(n_layers):
    """Forward hidden states, prefill logits and three decode steps over
    a 2-lane fp32 cache, and every leaf of the cache after them."""
    cfg, jcfg, params, jparams = _params(n_layers)
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
             for _ in range(3)]
    with jp.override(policy=JPOLICY):
        jh = JH.forward(jparams, jcfg, jnp.asarray(tokens))
        jl, jc = JH.prefill(jparams, jcfg, jnp.asarray(tokens), 24,
                            cache_dtype=jnp.float32)
        jdec = []
        for nt in steps:
            lg, jc = JH.decode_step(jparams, jcfg, jc, jnp.asarray(nt))
            jdec.append(np.asarray(lg))
    tp.reset_configuration()
    with torch.no_grad():
        th = TH.forward(params, cfg, torch.from_numpy(tokens))
        tl, tc = TH.prefill(params, cfg, torch.from_numpy(tokens), 24,
                            cache_dtype=torch.float32)
        tdec = [TH.decode_step(params, cfg, tc, torch.from_numpy(nt))[0]
                .numpy().copy() for nt in steps]
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LOGIT_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for got, want in zip(tdec, jdec):
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert tc.keys() == jc.keys() == {"conv", "ssm", "pos", "k", "v"}
    for k in ("conv", "ssm", "k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   **LOGIT_TOL)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [14, 14]


def test_build_model_serves_hybrid_and_refuses_a_bucketed_prefill():
    cfg = get_config(ARCH)
    assert build_model(cfg).device.type == "cuda"  # the card is the default
    scfg, _, params, _ = _params()
    api = build_model(scfg, "cpu")
    assert api.paged_layout() == {"conv": "lane", "ssm": "lane",
                                  "k": "paged", "v": "paged"}
    with pytest.raises(ValueError, match="exact prompt length"):
        api.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.int32)},
                    16, last_index=torch.tensor([5]))
    pools = api.paged_init(9, 8, 3)
    assert pools["k"].shape == (2, 9, 8, 4, 16)
    assert pools["conv"].shape == (4, 3, 3, 160)
    assert pools["ssm"].shape == (4, 3, 8, 16, 16)


SITES = {"lm_head", "attn.q", "attn.k", "attn.v", "attn.scores",
         "attn.values", "attn.out", "attn.decode_scores",
         "attn.decode_values", "mlp.gate", "mlp.up", "mlp.down"}


@pytest.mark.parametrize("enabled", [True, False],
                         ids=["planned", "disabled"])
def test_sites_plan_as_the_reference(enabled):
    """A prefill (the shared block's projections, scores, values and MLP;
    its out projection a plain product) and a decode step (its decode
    attention and ``attn.out``): every site the reference plans, at the
    same shapes with the same plans and no fallback; with planning
    disabled, the same fallbacks with the same reason."""
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
    assert set(got) == set(want) == SITES
    for site, st in got.items():
        ref = want[site]
        assert bool(st["planned"]) == bool(ref["planned"]) == enabled, site
        assert bool(st["fallback"]) == bool(ref["fallback"]) != enabled, site
        assert set(st["reasons"]) == set(ref["reasons"]), site
        assert set(st["shapes"]) == set(ref["shapes"]), site
        assert st["last_plan"] == ref["last_plan"], site
    # the prefill's q/k/v over the whole prompt, the decode's over a row
    assert set(got["attn.q"]["shapes"]) == {str((18, 64, 64)),
                                            str((2, 64, 64))}
    assert set(got["attn.out"]["shapes"]) == {str((2, 64, 64))}


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


@pytest.mark.parametrize("lanes", [1, 4])
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


def test_slot_equals_paged_at_four_lanes():
    cfg, _, params, _ = _params(5)
    prompts = _prompts(cfg, [5, 9, 7, 12, 3, 16], seed=1)
    slot = _drain(_engine(cfg, params, "slot", max_slots=4, max_seq=64),
                  prompts, max_new=7)
    paged = _drain(_engine(cfg, params, "paged", max_lanes=4, max_seq=64,
                           block_size=8), prompts, max_new=7)
    assert slot == paged


def test_paged_pools_are_written_in_place_never_replaced():
    """A paged decode step writes every lane's conv and SSM states and the
    active lane's K/V row into the pool tensors the engine built, an
    inactive lane's K/V row into the sink block only; a drain with a
    preemption replaces no pool."""
    cfg, _, params, _ = _params()
    eng = _engine(cfg, params, "paged", max_lanes=2, max_seq=64,
                  block_size=8, num_blocks=4)
    ptrs = {k: v.data_ptr() for k, v in eng.kv.pools.items()}
    before = {k: v.clone() for k, v in eng.kv.pools.items()}
    tables = torch.tensor([[2, 0, 0, 0, 0, 0, 0, 0]] * 2, dtype=torch.int32)
    pos = torch.tensor([3, 5], dtype=torch.int32)
    with torch.no_grad():
        _, out = eng.api.paged_decode(params, eng.kv.pools,
                                      torch.ones((2, 1), dtype=torch.int32),
                                      tables, pos,
                                      torch.tensor([True, False]))
    assert out is eng.kv.pools
    pools = eng.kv.pools
    assert {k: v.data_ptr() for k, v in pools.items()} == ptrs
    for k in ("conv", "ssm"):
        assert not torch.equal(pools[k][:, 0], before[k][:, 0]), k
        assert not torch.equal(pools[k][:, 1], before[k][:, 1]), k
    sink = eng.num_blocks
    for k in ("k", "v"):
        changed = (pools[k] != before[k]).flatten(3).any(-1)  # [napp, NB, bs]
        assert changed[:, 2, 3].all()          # lane 0's row 3 in block 2
        assert changed[:, sink, 5].all()       # lane 1's row into the sink
        assert int(changed.sum()) == 2 * TH.n_attn_apps(cfg)
    done = _drain(eng, _prompts(cfg, [20, 20, 6], seed=2), max_new=9)
    assert eng.stats["preemptions"] > 0
    assert sorted(map(len, done.values())) == [9, 9, 9]
    assert {k: v.data_ptr() for k, v in eng.kv.pools.items()} == ptrs


# ---------------------------------------------------------------------------
# the full-width models' GEMMs: plans and the hand kernels' configurations
# ---------------------------------------------------------------------------

#: prompt lengths of the card's ssm phase (4-16 tokens, one SSD chunk, a
#: padded second, two whole) and its 4-lane decode over max_seq 528
PROMPTS = (4, 13, 64, 255, 300, 512)


def _full_width_gemms():
    """(site, kind, shape) of every planned GEMM both full-width models
    run in the card's ssm phase, bf16."""
    m2, z2 = get_config("mamba2-780m"), get_config(ARCH)
    d, ff, h, hd = z2.d_model, z2.d_ff, z2.n_heads, z2.hd
    out = [("lm_head", "mm", (m, cfg.vocab, cfg.d_model))
           for cfg in (m2, z2) for m in (1, 4)]
    for p in PROMPTS + (4,):
        out += [("attn.q", "mm", (p, h * hd, d)),
                ("mlp.gate", "mm", (p, ff, d)),
                ("mlp.down", "mm", (p, d, ff))]
    for p in PROMPTS:
        out += [("attn.scores", "bmm", (h, p, p, hd)),
                ("attn.values", "bmm", (h, p, hd, p))]
    out += [("attn.out", "mm", (4, d, h * hd)),
            ("attn.decode_scores", "bmm", (4 * h, 1, 528, hd)),
            ("attn.decode_values", "bmm", (4 * h, 1, hd, 528))]
    return out


def test_full_width_gemms_plan_as_the_reference():
    """Every planned GEMM of full-width mamba2 and zamba2 in the card's
    phase plans in the port, with the reference's plan (the reference's
    ``_decide`` under the modelled policy)."""
    for site, kind, shape in _full_width_gemms():
        with jp.override(policy=JPOLICY):
            want, why = jp._decide(kind, shape, jnp.bfloat16, jnp.bfloat16)
        tp.reset_configuration()
        got, reason = tp._decide(kind, shape, torch.bfloat16, torch.bfloat16)
        assert got is not None and reason is None, (site, shape, reason)
        assert want is not None and got.describe() == want.describe(), (
            site, shape, why)


def test_full_width_gemms_take_the_hand_kernels():
    """The skinny kernel up to 16 rows of A (every decode GEMM, the
    short prompts' and each prefill's lm_head row), the tensor-core kernel
    above (zamba2's prompt GEMMs from 64 tokens)."""
    from repro_torch.kernels import runtime

    for site, kind, shape in _full_width_gemms():
        batch, (m, n, k) = (shape[0] if kind == "bmm" else 1), shape[-3:]
        if m <= runtime.SKINNY_ROWS:
            tile = runtime.skinny_tile(m, n, k, batch, torch.bfloat16)
        else:
            tile = runtime.tc_tile(m, n, k, torch.bfloat16, batch)
        assert tile is not None, (site, shape)
