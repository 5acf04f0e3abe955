"""The port's MLA attention (deepseek-v2-236b) against the JAX reference.

deepseek-v2's SMOKE config (float32, 3 layers of d 64: one dense layer,
then two MoE layers of 8 experts of ff 64, top-2, one shared expert; 4
heads, kv_lora 32, q_lora 48, nope 16, rope 8, v 16) on numpy operands
and on parameters the reference draws (``PRNGKey``) and
``convert.params_from_jax`` carries over.

* ``_queries``, ``_latent`` and ``apply_mla`` within ``atol = rtol =
  1e-5``: a 9-token prompt (the two fp32 logit terms summed) and a
  2100-token one (blockwise attention over dqk = 24 != dv = 16, with and
  without ``block_skip``), with the q_lora path and with the plain
  ``mla.q`` (``q_lora_rank=0``).  Both sides take the same products in
  fp32, in another summation order.
* ``apply_mla_decode`` and ``apply_mla_decode_paged`` within 1e-5, the
  caches and pools too; in the paged step an inactive lane writes its
  row to the sink block, where the reference drops it.
* Prefill and decode logits within ``atol = rtol = 1e-4`` on an fp32
  cache, as the dense and MoE tests'; the absorbed decode against the
  expanded forward as the reference's ``test_mla_decode_matches_full``
  holds it (a bf16 latent cache, capacity factor 8.0).
* Greedy tokens equal to the reference's slot and paged engines at 1 and
  4 lanes, and slot == paged at 1 lane, the reference's
  ``test_paged_matches_slot_across_families`` on the port.
* Every facade site plans at the reference's shapes with its plans, and
  with planning disabled falls back with its reason; every GEMM shape of
  the card's deepseek phase (8 layers at the published width) plans as
  the reference plans it and takes a hand kernel (planning only).
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
from repro.models import mla as JMLA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import PagedServeEngine as JaxPaged  # noqa: E402
from repro.serve import ServeEngine as JaxSlot  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import planned as tp  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import make_engine  # noqa: E402

ARCH = "deepseek-v2-236b"
#: fp32 attention blocks; whole-model logits
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
JPOLICY = JaxPolicy(mode="modelled")
#: the reference's bounds of the absorbed decode against the expanded
#: forward over a bf16 latent cache (tests/test_models_smoke.py)
ABSORBED_TOL = dict(atol=8e-2, rtol=2e-2)
#: a prompt past ``BLOCKWISE_SEQ_THRESHOLD``: blockwise attention
LONG = 2100


def _cfgs(**kw):
    return (dataclasses.replace(get_smoke_config(ARCH), **kw),
            dataclasses.replace(jax_smoke(ARCH), **kw))


_PARAMS: dict = {}


def _params(q_lora=True):
    """(port cfg, reference cfg, port params, reference params)."""
    if q_lora not in _PARAMS:
        kw = {} if q_lora else {"q_lora_rank": 0}
        cfg, jcfg = _cfgs(**kw)
        # jitted: the eager draw of the 3 layers takes ~10 s
        jparams = jax.jit(JT.init_params, static_argnums=1)(
            jax.random.PRNGKey(42), jcfg)
        _PARAMS[q_lora] = (cfg, jcfg, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"), jparams)
    return _PARAMS[q_lora]


def _attn(q_lora=True, layer=1):
    """One layer's attention parameters in both packages."""
    cfg, jcfg, params, jparams = _params(q_lora)
    group, j = (("dense_layers", layer) if layer < cfg.moe_first_dense
                else ("moe_layers", layer - cfg.moe_first_dense))
    jattn = jax.tree.map(lambda a: a[j], jparams[group]["attn"])
    return cfg, jcfg, params["layers"][layer]["attn"], jattn


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol=BLOCK_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "q_plain"])
def test_params_from_jax_carries_the_mla_leaves(q_lora):
    """Every layer's MLA leaves (and the dense and MoE halves beside them)
    keep the reference's bits, the dense layer first."""
    cfg, jcfg, params, jparams = _params(q_lora)
    want = {"wdkv", "kv_norm", "wkr", "wuk", "wuv", "wo"} | (
        {"wdq", "q_norm", "wuq"} if q_lora else {"wq"})
    assert len(params["layers"]) == cfg.n_layers
    for i, lp in enumerate(params["layers"]):
        assert set(lp["attn"]) == want
        group, j = (("dense_layers", i) if i < cfg.moe_first_dense
                    else ("moe_layers", i - cfg.moe_first_dense))
        jl = jax.tree.map(lambda a, j=j: np.asarray(a)[j], jparams[group])
        flat, jflat = _flatten(lp), _flatten(jl)
        assert flat.keys() == jflat.keys()
        for name, v in flat.items():
            np.testing.assert_array_equal(v.numpy(), jflat[name])
    assert ("mlp" in params["layers"][0]) and ("moe" in params["layers"][1])
    attn = params["layers"][0]["attn"]
    h = cfg.n_heads
    assert attn["wuk"].shape == (cfg.kv_lora_rank, h * cfg.nope_head_dim)
    assert attn["wo"].shape == (h * cfg.v_head_dim, cfg.d_model)


def test_init_params_draws_mla_leaves_at_full_width_shapes():
    """``init_params`` at deepseek-v2's published widths (1 dense + 1 MoE
    layer, drawn on the meta device: shapes only)."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    p = TT.init_params(cfg, torch.Generator().manual_seed(0), "meta")
    attn = p["layers"][1]["attn"]
    assert attn["wdq"].shape == (5120, 1536)
    assert attn["wuq"].shape == (1536, 128 * 192)
    assert attn["wdkv"].shape == (5120, 512)
    assert attn["wkr"].shape == (5120, 64)
    assert attn["wuk"].shape == attn["wuv"].shape == (512, 128 * 128)
    assert attn["wo"].shape == (128 * 128, 5120)
    assert p["layers"][0]["mlp"]["wg"].shape == (5120, 12288)
    moe = p["layers"][1]["moe"]
    assert moe["wg"].shape == (160, 5120, 1536)
    assert moe["shared_wg"].shape == (5120, 2 * 1536)
    assert all(t.dtype == torch.bfloat16 for t in attn.values())


# ---------------------------------------------------------------------------
# the attention block
# ---------------------------------------------------------------------------

ATTN_CASES = [(9, True, False), (9, False, False), (LONG, True, False),
              (LONG, True, True), (LONG, False, True)]
ATTN_IDS = ["short-q_lora", "short-q_plain", "blockwise-q_lora",
            "blockwise-q_lora-skip", "blockwise-q_plain-skip"]


@pytest.mark.parametrize("s,q_lora,skip", ATTN_CASES, ids=ATTN_IDS)
def test_apply_mla_matches_the_reference(s, q_lora, skip):
    """``_queries``, ``_latent`` and the expanded ``apply_mla`` (its output
    and the cache rows it returns) within 1e-5."""
    cfg, jcfg, attn, jattn = _attn(q_lora)
    cfg = dataclasses.replace(cfg, causal_block_skip=skip)
    jcfg = dataclasses.replace(jcfg, causal_block_skip=skip)
    b = 2 if s < LONG else 1
    x = _x((b, s, cfg.d_model), seed=s)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos.copy())
    jx, jpos = jnp.asarray(x), jnp.asarray(pos)
    with torch.no_grad():
        qn, qr = TMLA._queries(attn, cfg, tx, tpos)
        ckv, kr = TMLA._latent(attn, cfg, tx, tpos)
        out, ckv2, kr2 = TMLA.apply_mla(attn, cfg, tx, tpos)
    with jp.override(policy=JPOLICY):
        jqn, jqr = JMLA._queries(jattn, jcfg, jx, jpos)
        jckv, jkr = JMLA._latent(jattn, jcfg, jx, jpos)
        jout = JMLA.apply_mla(jattn, jcfg, jx, jpos)
    for got, want in ((qn, jqn), (qr, jqr), (ckv, jckv), (kr, jkr),
                      (ckv2, jckv), (kr2, jkr)):
        assert tuple(got.shape) == want.shape
        _close(got, want)
    _close(out, jout)


def test_blockwise_and_direct_paths_agree_at_the_threshold():
    """Forced through blockwise attention, a 9-token prompt gives the
    direct path's output: the concatenated q_cat.k_cat scores equal
    qn.kn + qr.kr."""
    cfg, _, attn, _ = _attn()
    x = torch.from_numpy(_x((2, 9, cfg.d_model), seed=3))
    pos = torch.arange(9).expand(2, 9)
    with torch.no_grad():
        direct, _, _ = TMLA.apply_mla(attn, cfg, x, pos)
        threshold = TMLA.L.BLOCKWISE_SEQ_THRESHOLD
        TMLA.L.BLOCKWISE_SEQ_THRESHOLD = 4
        try:
            blockwise, _, _ = TMLA.apply_mla(attn, cfg, x, pos)
        finally:
            TMLA.L.BLOCKWISE_SEQ_THRESHOLD = threshold
    torch.testing.assert_close(blockwise, direct, **BLOCK_TOL)


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "q_plain"])
def test_apply_mla_decode_matches_the_reference(q_lora):
    """One absorbed decode step of 3 lanes at positions 0, 4 and 15 (the
    last row of a 16-row cache) over random caches: output and written
    caches within 1e-5."""
    cfg, jcfg, attn, jattn = _attn(q_lora)
    b, s = 3, 16
    x = _x((b, 1, cfg.d_model), seed=21)
    ckv = _x((b, s, cfg.kv_lora_rank), seed=22)
    kr = _x((b, s, cfg.rope_head_dim), seed=23)
    pos = np.array([0, 4, 15], np.int32)
    tckv, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    with torch.no_grad():
        out = TMLA.apply_mla_decode(attn, cfg, torch.from_numpy(x), tckv,
                                    tkr, torch.from_numpy(pos))
    with jp.override(policy=JPOLICY):
        jout, jckv, jkr = JMLA.apply_mla_decode(
            jattn, jcfg, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
            jnp.asarray(pos))
    _close(out, jout)
    _close(tckv, jckv)
    _close(tkr, jkr)


def test_apply_mla_decode_paged_matches_the_reference_and_sinks_inactive():
    """The paged step over pools of 5 blocks of 4 rows plus the sink: the
    lanes' outputs and the pools' rows within 1e-5 of the reference's;
    the inactive lane's row goes to the sink block (the reference drops
    it), every other block as the reference leaves it."""
    cfg, jcfg, attn, jattn = _attn()
    nb, bs = 5, 4
    x = _x((3, 1, cfg.d_model), seed=31)
    pool_ckv = _x((nb + 1, bs, cfg.kv_lora_rank), seed=32)
    pool_kr = _x((nb + 1, bs, cfg.rope_head_dim), seed=33)
    tables = np.array([[2, 0, 0], [4, 1, 0], [3, 0, 0]], np.int32)
    pos = np.array([2, 6, 1], np.int32)
    active = np.array([True, True, False])
    tckv, tkr = torch.from_numpy(pool_ckv.copy()), torch.from_numpy(
        pool_kr.copy())
    with torch.no_grad():
        out = TMLA.apply_mla_decode_paged(
            attn, cfg, torch.from_numpy(x), tckv, tkr,
            torch.from_numpy(tables), torch.from_numpy(pos),
            torch.from_numpy(active))
    with jp.override(policy=JPOLICY):
        jout, jckv, jkr = JMLA.apply_mla_decode_paged(
            jattn, jcfg, jnp.asarray(x), jnp.asarray(pool_ckv),
            jnp.asarray(pool_kr), jnp.asarray(tables), jnp.asarray(pos),
            jnp.asarray(active))
    _close(out, jout)
    for got, want, before in ((tckv, jckv, pool_ckv), (tkr, jkr, pool_kr)):
        _close(got[:nb], np.asarray(want)[:nb])
        assert np.array_equal(np.asarray(want)[nb], before[nb])
        changed = (got.numpy() != before).any(-1)
        assert changed[2, 2] and changed[1, 2]  # the active lanes' rows
        assert changed[nb, 1]                   # the inactive lane's: sink
        assert int(changed.sum()) == 3


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_prefill_and_decode_logits_and_cache_match_the_reference():
    """Forward hidden states, prefill logits and its latent cache, and two
    decode steps over a 2-lane fp32 cache."""
    cfg, jcfg, params, jparams = _params()
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
             for _ in range(2)]
    with jp.override(policy=JPOLICY):
        jh, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens))
        jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(tokens), 16,
                            cache_dtype=jnp.float32)
        jpre = {k: np.asarray(v) for k, v in jc.items()}
        jdec = []
        for nt in steps:
            lg, jc = JT.decode_step(jparams, jcfg, jc, jnp.asarray(nt))
            jdec.append(np.asarray(lg))
    with torch.no_grad():
        th, _ = TT.forward(params, cfg, torch.from_numpy(tokens))
        tl, tc = TT.prefill(params, cfg, torch.from_numpy(tokens), 16,
                            cache_dtype=torch.float32)
        assert set(tc) == {"ckv", "kr", "pos"}
        for k, v in tc.items():
            np.testing.assert_allclose(v.numpy(), jpre[k], **LOGIT_TOL)
        tdec = [TT.decode_step(params, cfg, tc, torch.from_numpy(nt))[0]
                .numpy().copy() for nt in steps]
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LOGIT_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for got, want in zip(tdec, jdec):
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_allclose(tc["ckv"].numpy(), np.asarray(jc["ckv"]),
                               **LOGIT_TOL)
    assert tc["pos"].tolist() == [11, 11]


def test_absorbed_decode_matches_the_expanded_forward():
    """The reference's ``test_mla_decode_matches_full`` on the port: the
    absorbed decode over the bf16 latent cache of a 9-token prefill
    against the expanded forward's logits at position 9 (capacity factor
    8.0, so no token drops in either pass)."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                              moe_capacity_factor=8.0)
    api = build_model(cfg, "cpu")
    params = api.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 10)).astype(np.int32))
    with torch.no_grad():
        hidden, _ = TT.forward(params, cfg, toks)
        full = TT.logits_fn(params, cfg, hidden)
        _, cache = api.prefill(params, {"tokens": toks[:, :9]}, 16)
        assert cache["ckv"].dtype == torch.bfloat16
        logits, _ = api.decode(params, cache, toks[:, 9:10])
    np.testing.assert_allclose(logits.numpy(), full[:, 9].numpy(),
                               **ABSORBED_TOL)


def test_paged_layout_and_pools_hold_the_latent():
    cfg, _, _, _ = _params()
    api = build_model(cfg, "cpu")
    assert api.paged_layout() == {"ckv": "paged", "kr": "paged"}
    pools = api.paged_init(7, 8, 2)
    assert pools["ckv"].shape == (cfg.n_layers, 7, 8, cfg.kv_lora_rank)
    assert pools["kr"].shape == (cfg.n_layers, 7, 8, cfg.rope_head_dim)
    assert api.init_cache(2, 16)["ckv"].shape == (cfg.n_layers, 2, 16,
                                                  cfg.kv_lora_rank)


# ---------------------------------------------------------------------------
# the engines: greedy tokens equal
# ---------------------------------------------------------------------------

PROMPT_LENS = [5, 9, 9, 5]


def _prompts(cfg, lens=PROMPT_LENS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


def _drain(eng, prompts, max_new=4):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: list(r.output) for r in eng.run_until_drained(4000)}


def _engine(cfg, params, kind, **kw):
    eng = make_engine(cfg, kind=kind, device="cpu", **kw)
    eng.load(params)
    return eng


@pytest.mark.parametrize("lanes", [1, 4])
def test_slot_engine_matches_the_reference_slot_engine(lanes):
    cfg, jcfg, params, jparams = _params()
    prompts = _prompts(cfg)
    got = _drain(_engine(cfg, params, "slot", max_slots=lanes, max_seq=32),
                 prompts)
    jeng = JaxSlot(jcfg, max_slots=lanes, max_seq=32, policy=JPOLICY)
    jeng.load(jparams)
    assert got == _drain(jeng, prompts)


@pytest.mark.parametrize("lanes", [1, 4])
def test_paged_engine_matches_the_reference_paged_engine(lanes):
    cfg, jcfg, params, jparams = _params()
    prompts = _prompts(cfg)
    eng = _engine(cfg, params, "paged", max_lanes=lanes, max_seq=32,
                  block_size=8)
    got = _drain(eng, prompts)
    jeng = JaxPaged(jcfg, max_lanes=lanes, max_seq=32, block_size=8,
                    policy=JPOLICY)
    jeng.load(jparams)
    assert got == _drain(jeng, prompts)
    assert eng.stats["decode_compiles"] == 1
    # MoE: exact-length prefills, one a prompt length
    assert eng._prefill_shapes == {(n, ("tokens",), False)
                                   for n in set(PROMPT_LENS)}


def test_slot_equals_paged_at_one_lane():
    """The reference's ``test_paged_matches_slot_across_families``
    (deepseek-v2 at 1 lane) on the port, on the plain ``mla.q`` path
    too."""
    for q_lora in (True, False):
        cfg, _, params, _ = _params(q_lora)
        prompts = _prompts(cfg, [5, 9, 7], seed=1)
        slot = _drain(_engine(cfg, params, "slot", max_slots=1,
                              max_seq=64), prompts, max_new=6)
        paged = _drain(_engine(cfg, params, "paged", max_lanes=1,
                               max_seq=64, block_size=8), prompts,
                       max_new=6)
        assert slot == paged


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

MLA_SITES = {"mla.q_down", "mla.q_up", "mla.kv_down", "mla.k_rope",
             "mla.k_up", "mla.v_up", "mla.out"}
SITES = MLA_SITES | {"lm_head", "mlp.gate", "mlp.up", "mlp.down",
                     "moe.router", "moe.gate", "moe.up", "moe.down",
                     "moe.shared_gate", "moe.shared_up", "moe.shared_down"}


@pytest.mark.parametrize("enabled", [True, False],
                         ids=["planned", "disabled"])
def test_sites_plan_as_the_reference(enabled):
    """A prefill, a decode step and a paged decode step: every site the
    reference plans, at the same shapes with the same plans and no
    fallback; with planning disabled, the same fallbacks with the same
    reason."""
    cfg, jcfg, params, jparams = _params()
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (2, 9))
    step = np.zeros((2, 1), np.int32)
    tables = np.array([[1, 0], [2, 0]], np.int32)
    pos = np.array([3, 9], np.int32)
    active = np.array([True, False])
    jp.planned_report_clear()
    with jp.override(policy=JPOLICY, enabled=enabled):
        _, jc = JT.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32), 16)
        JT.decode_step(jparams, jcfg, jc, jnp.asarray(step))
        jpools = JT.init_paged_pools(jcfg, 4, 8, 2)
        JT.decode_step_paged(jparams, jcfg, jpools, jnp.asarray(step),
                             jnp.asarray(tables), jnp.asarray(pos),
                             jnp.asarray(active))
    want = jp.planned_report()
    tp.reset_configuration()
    tp.planned_report_clear()
    with torch.no_grad(), tp.override(enabled=enabled):
        _, tc = TT.prefill(params, cfg, torch.from_numpy(tokens), 16)
        TT.decode_step(params, cfg, tc, torch.from_numpy(step))
        pools = TT.init_paged_pools(cfg, 4, 8, 2, device="cpu")
        TT.decode_step_paged(params, cfg, pools, torch.from_numpy(step),
                             torch.from_numpy(tables), torch.from_numpy(pos),
                             torch.from_numpy(active))
    got = tp.planned_report()
    assert set(got) == set(want) == SITES
    for site, st in got.items():
        ref = want[site]
        assert bool(st["planned"]) == bool(ref["planned"]) == enabled, site
        assert bool(st["fallback"]) == bool(ref["fallback"]) != enabled, site
        assert set(st["reasons"]) == set(ref["reasons"]), site
        assert set(st["shapes"]) == set(ref["shapes"]), site
        assert st["last_plan"] == ref["last_plan"], site
    # the prefill expands the latent; the absorbed decode plans no k_up
    assert set(got["mla.k_up"]["shapes"]) == {str((18, 64, 32))}
    assert set(got["mla.out"]["shapes"]) == {str((18, 64, 64)),
                                             str((2, 64, 64))}


#: the card phase's prompts (4-16 and 64-512 tokens) and decode lanes
CARD_PROMPTS = (4, 9, 13, 16, 64, 127, 256, 512)
CARD_LANES = (1, 4)


def _full_width_gemms():
    """(site, kind, shape) of every planned GEMM the card's deepseek phase
    runs at the published width: each prompt's prefill (its lm_head over
    the last row) and the 1- and 4-lane decode steps (no ``mla.k_up`` /
    ``mla.v_up``: the absorbed form reads those weights directly), bf16
    but the fp32 router."""
    cfg = get_config(ARCH)
    d, h, e = cfg.d_model, cfg.n_heads, cfg.moe_num_experts
    qh = h * (cfg.nope_head_dim + cfg.rope_head_dim)
    sf = cfg.moe_shared_experts * cfg.moe_d_ff
    out = []
    for m, prefill in ([(p, True) for p in CARD_PROMPTS]
                       + [(n, False) for n in CARD_LANES]):
        c = TM.capacity_of(cfg, m)
        out += [("mla.q_down", "mm", (m, cfg.q_lora_rank, d)),
                ("mla.q_up", "mm", (m, qh, cfg.q_lora_rank)),
                ("mla.kv_down", "mm", (m, cfg.kv_lora_rank, d)),
                ("mla.k_rope", "mm", (m, cfg.rope_head_dim, d)),
                ("mla.out", "mm", (m, d, h * cfg.v_head_dim)),
                ("mlp.gate", "mm", (m, cfg.d_ff, d)),
                ("mlp.down", "mm", (m, d, cfg.d_ff)),
                ("moe.router", "mm", (m, e, d)),
                ("moe.gate", "bmm", (e, c, cfg.moe_d_ff, d)),
                ("moe.down", "bmm", (e, c, d, cfg.moe_d_ff)),
                ("moe.shared_gate", "mm", (m, sf, d)),
                ("moe.shared_down", "mm", (m, d, sf)),
                ("lm_head", "mm", (1 if prefill else m, cfg.vocab, d))]
        if prefill:
            out += [("mla.k_up", "mm",
                     (m, h * cfg.nope_head_dim, cfg.kv_lora_rank)),
                    ("mla.v_up", "mm",
                     (m, h * cfg.v_head_dim, cfg.kv_lora_rank))]
    return out


def _dtypes(site):
    return ((torch.float32, jnp.float32) if site == "moe.router"
            else (torch.bfloat16, jnp.bfloat16))


def test_full_width_gemms_plan_as_the_reference():
    """Every planned GEMM of the card's deepseek phase plans in the port,
    with the reference's plan (its ``_decide`` under the modelled
    policy)."""
    for site, kind, shape in _full_width_gemms():
        tdt, jdt = _dtypes(site)
        with jp.override(policy=JPOLICY):
            want, why = jp._decide(kind, shape, jdt, jdt)
        tp.reset_configuration()
        got, reason = tp._decide(kind, shape, tdt, tdt)
        assert got is not None and reason is None, (site, shape, reason)
        assert want is not None and got.describe() == want.describe(), (
            site, shape, why)


def test_full_width_gemms_take_the_hand_kernels():
    """The skinny kernel up to 16 rows of A (every decode GEMM, the short
    prompts', the expert stack at C <= 16, each prefill's lm_head row;
    ``mla.out``'s K = 16384 the largest, whose stage of A fits), the
    tensor-core kernel above."""
    for site, kind, shape in _full_width_gemms():
        batch, (m, n, k) = (shape[0] if kind == "bmm" else 1), shape[-3:]
        dt = _dtypes(site)[0]
        if m <= runtime.SKINNY_ROWS:
            tile = runtime.skinny_tile(m, n, k, batch, dt)
        else:
            tile = runtime.tc_tile(m, n, k, dt, batch)
        assert tile is not None, (site, shape)
