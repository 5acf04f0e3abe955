"""The port's MoE family (olmoe-1b-7b) against the JAX reference.

olmoe's SMOKE config (float32, 2 layers, d 64, 8 experts of ff 128,
top-2) on numpy operands and on parameters the reference draws
(``PRNGKey``) and ``convert.params_from_jax`` carries over.  Routing and
dispatch must be **equal**: the top-k ids (ties to the lower expert), the
expert-sorted order, slots, kept flags and tokens, at capacity factor
1.25 (assignments dropped) and 8.0 (none).  Router weights and the
block's outputs are fp32 and held within ``atol = rtol = 1e-5``: both
sides take the same products and the same per-token order of the k
contributions (ascending expert), differing only in the GEMMs' summation
order (~1e-7 observed).  Whole-model logits keep the dense tests' ``atol
= rtol = 1e-4`` with an fp32 KV cache, as qwen3-32b's there (a bf16
cache rounds a value one step the other way in one package now and
then: ~2e-4 at decode; ~3e-6 with the fp32 cache).  Greedy tokens must
be equal: the port's slot and paged engines against the reference's
slot and paged engines at 1 and 4 lanes, and slot == paged at 1 lane (at
4 lanes capacity couples the lanes: a decode step's C is 2 slots an
expert, so one lane's token depends on which experts the others chose,
in both packages, and the slot and paged engines hold different lanes
at a step).
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
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import PagedServeEngine as JaxPaged  # noqa: E402
from repro.serve import ServeEngine as JaxSlot  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import planned as tp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import make_engine  # noqa: E402

ARCH = "olmoe-1b-7b"
#: fp32 routing weights and MoE block outputs; whole-model logits
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
JPOLICY = JaxPolicy(mode="modelled")
#: (moe_first_dense, moe_shared_experts) variants of the SMOKE config
VARIANTS = [(0, 0), (1, 1)]
VARIANT_IDS = ["moe-only", "first-dense-shared"]


def _cfgs(first_dense=0, shared=0, **kw):
    over = dict(moe_first_dense=first_dense, moe_shared_experts=shared, **kw)
    return (dataclasses.replace(get_smoke_config(ARCH), **over),
            dataclasses.replace(jax_smoke(ARCH), **over))


_PARAMS: dict = {}


def _params(first_dense=0, shared=0):
    """(port cfg, reference cfg, port params, reference params)."""
    key = (first_dense, shared)
    if key not in _PARAMS:
        cfg, jcfg = _cfgs(first_dense, shared)
        jparams = JT.init_params(jax.random.PRNGKey(42), jcfg)
        _PARAMS[key] = (cfg, jcfg, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"), jparams)
    return _PARAMS[key]


def _moe_params(shared):
    """One MoE block's parameters from the reference's ``init_moe``."""
    cfg, jcfg = _cfgs(shared=shared)
    jp_ = JM.init_moe(jax.random.PRNGKey(3), jcfg)
    tp_ = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp_.items()}
    return cfg, jcfg, tp_, jp_


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# routing and dispatch: equal
# ---------------------------------------------------------------------------

def test_route_matches_the_reference():
    cfg, jcfg = _cfgs()
    logits = _x((64, cfg.moe_num_experts), seed=1) * 3
    w, ids, probs = TM.route(cfg, torch.from_numpy(logits))
    jw, jids, jprobs = JM.route(jcfg, jnp.asarray(logits))
    assert ids.tolist() == np.asarray(jids).tolist()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **BLOCK_TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                               **BLOCK_TOL)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)


def test_route_breaks_ties_to_the_lower_expert_as_lax_top_k():
    cfg, jcfg = _cfgs()
    e = cfg.moe_num_experts
    # rows of equal logits, and pairs tied for first and for second place
    logits = np.zeros((4, e), np.float32)
    logits[1, [2, 5]] = 1.0
    logits[2, [6, 3]] = 2.0
    logits[2, [1, 7, 4]] = 1.0
    logits[3] = np.arange(e)[::-1] % 3
    _, ids, _ = TM.route(cfg, torch.from_numpy(logits))
    _, jids, _ = JM.route(jcfg, jnp.asarray(logits))
    assert ids.tolist() == np.asarray(jids).tolist()
    assert ids[0].tolist() == [0, 1] and ids[2].tolist() == [3, 6]


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_dispatch_indices_match_the_reference(cf):
    """At cf 1.25 some assignments overflow their expert and drop; at 8.0
    none does.  Every field equal, and no kept slot used twice."""
    cfg, jcfg = _cfgs(moe_capacity_factor=cf)
    t, e, k = 40, cfg.moe_num_experts, cfg.moe_top_k
    rng = np.random.default_rng(4)
    # skewed choices, distinct within a token
    ids = np.stack([rng.choice(e, k, replace=False,
                               p=np.linspace(3, 1, e) / np.linspace(
                                   3, 1, e).sum()) for _ in range(t)])
    capacity = TM.capacity_of(cfg, t)
    assert capacity == max(1, int(np.ceil(t * k * cf / e)))
    got = TM.dispatch_indices(cfg, torch.from_numpy(ids), capacity)
    want = JM._dispatch_indices(jcfg, jnp.asarray(ids), capacity)
    for g, w in zip(got, want):
        assert g.tolist() == np.asarray(w).tolist()
    keep, slot = got[2].numpy(), got[1].numpy()
    assert (not keep.all()) if cf == 1.25 else keep.all()
    kept = slot[keep]
    assert len(set(kept.tolist())) == len(kept)
    assert kept.max() < e * capacity


def test_dispatch_buffer_holds_the_kept_rows_of_the_reference_scatter():
    """The gathered [E, C, d] buffer equals the reference's scatter-add
    of the kept rows (zeros elsewhere), bit for bit."""
    cfg, _ = _cfgs()
    t, e, k = 24, cfg.moe_num_experts, cfg.moe_top_k
    x = _x((t, 16), seed=5)
    ids = np.stack([np.random.default_rng(i).choice(e, k, replace=False)
                    for i in range(t)])
    capacity = TM.capacity_of(cfg, t)
    _, slot, keep, token = TM.dispatch_indices(
        cfg, torch.from_numpy(ids), capacity)
    buf = TM.dispatch(torch.from_numpy(x), slot, token, e, capacity)
    want = jnp.zeros((e * capacity, 16), jnp.float32).at[
        jnp.asarray(slot.numpy())].add(jnp.where(
            jnp.asarray(keep.numpy())[:, None],
            jnp.asarray(x)[jnp.asarray(token.numpy())], 0))
    assert buf.shape == (e, capacity, 16)
    np.testing.assert_array_equal(buf.reshape(-1, 16).numpy(),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
def test_moe_ffn_tokens_and_apply_moe_match_the_reference(shared):
    cfg, jcfg, params, jparams = _moe_params(shared)
    x = _x((3, 7, cfg.d_model), seed=6)
    with torch.no_grad():
        y_tok = TM.moe_ffn_tokens(cfg, params,
                                  torch.from_numpy(x.reshape(21, -1)))
        y = TM.apply_moe(params, cfg, torch.from_numpy(x))
    jy_tok, _ = JM.moe_ffn_tokens(jcfg, jparams,
                                  jnp.asarray(x.reshape(21, -1)))
    jy, _ = JM.apply_moe(jparams, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(y_tok.numpy(), np.asarray(jy_tok),
                               **BLOCK_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **BLOCK_TOL)
    if not shared:
        np.testing.assert_allclose(y.numpy().reshape(21, -1),
                                   y_tok.numpy(), **BLOCK_TOL)


def test_moe_block_is_deterministic_and_drops_as_the_reference():
    """A batch whose tokens all pick the same experts overflows them: the
    dropped assignments contribute nothing, as in the reference; two runs
    give the same bits."""
    cfg, jcfg, params, jparams = _moe_params(0)
    row = _x((1, cfg.d_model), seed=7)
    x = np.repeat(row, 12, axis=0) + 1e-3 * _x((12, cfg.d_model), seed=8)
    with torch.no_grad():
        a = TM.moe_ffn_tokens(cfg, params, torch.from_numpy(x))
        b = TM.moe_ffn_tokens(cfg, params, torch.from_numpy(x))
    assert torch.equal(a, b)
    jy, _ = JM.moe_ffn_tokens(jcfg, jparams, jnp.asarray(x))
    np.testing.assert_allclose(a.numpy(), np.asarray(jy), **BLOCK_TOL)
    # capacity 4 of 12 tokens on the same two experts: 8 tokens dropped
    assert TM.capacity_of(cfg, 12) == 4
    assert int((a.abs().sum(-1) == 0).sum()) == 8


def test_moe_sites_plan_as_the_reference():
    """The router (fp32 mm), the expert stack (bmm) and the shared
    experts plan at the same shapes with the same plans in both
    packages, with no fallback."""
    cfg, jcfg, params, jparams = _moe_params(1)
    x = _x((2, 9, cfg.d_model), seed=9)
    tp.reset_configuration()
    tp.planned_report_clear()
    with torch.no_grad():
        TM.apply_moe(params, cfg, torch.from_numpy(x))
    got = tp.planned_report()
    jp.planned_report_clear()
    with jp.override(policy=JPOLICY):
        JM.apply_moe(jparams, jcfg, jnp.asarray(x))
    want = jp.planned_report()
    sites = {"moe.router", "moe.gate", "moe.up", "moe.down",
             "moe.shared_gate", "moe.shared_up", "moe.shared_down"}
    assert sites <= set(got)
    for site in sites:
        assert got[site]["fallback"] == 0 and got[site]["planned"] == 1
        assert got[site]["last_shape"] == tuple(want[site]["last_shape"])
        assert got[site]["last_plan"] == want[site]["last_plan"]
    assert got["moe.router"]["last_shape"] == (18, cfg.moe_num_experts,
                                               cfg.d_model)
    capacity = TM.capacity_of(cfg, 18)
    assert got["moe.gate"]["last_shape"] == (
        cfg.moe_num_experts, capacity, cfg.moe_d_ff, cfg.d_model)


# ---------------------------------------------------------------------------
# parameters and the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_params_from_jax_round_trip(variant):
    """Dense layers first, then the MoE layers, every leaf's bits kept."""
    cfg, jcfg, params, jparams = _params(*variant)
    n_dense, n_moe = TT.layer_split(cfg)
    assert (n_dense, n_moe) == JT._layer_split(jcfg)
    assert len(params["layers"]) == cfg.n_layers
    for i, lp in enumerate(params["layers"]):
        group, j = (("dense_layers", i) if i < n_dense
                    else ("moe_layers", i - n_dense))
        jl = jax.tree.map(lambda a, j=j: np.asarray(a)[j], jparams[group])
        assert ("mlp" in lp) == (i < n_dense)
        assert ("moe" in lp) != ("mlp" in lp)
        flat, jflat = _flatten(lp), _flatten(jl)
        assert flat.keys() == jflat.keys()
        for name, v in flat.items():
            np.testing.assert_array_equal(v.numpy(), jflat[name])
    if variant[1]:
        assert params["layers"][-1]["moe"]["shared_wg"].shape == (
            cfg.d_model, cfg.moe_d_ff)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("variant", VARIANTS, ids=VARIANT_IDS)
def test_prefill_and_decode_logits_match_the_reference(variant):
    """Forward hidden states, prefill logits and two decode steps over a
    2-lane fp32 cache (every lane routed at decode, as in the
    reference)."""
    cfg, jcfg, params, jparams = _params(*variant)
    rng = np.random.default_rng(10)
    tokens = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
             for _ in range(2)]
    with jp.override(policy=JPOLICY):
        jh, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens))
        jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(tokens), 16,
                            cache_dtype=jnp.float32)
        jdec = []
        for nt in steps:
            lg, jc = JT.decode_step(jparams, jcfg, jc, jnp.asarray(nt))
            jdec.append(np.asarray(lg))
    tp.reset_configuration()
    with torch.no_grad():
        th, _ = TT.forward(params, cfg, torch.from_numpy(tokens))
        tl, tc = TT.prefill(params, cfg, torch.from_numpy(tokens), 16,
                            cache_dtype=torch.float32)
        tdec = [TT.decode_step(params, cfg, tc, torch.from_numpy(nt))[0]
                .numpy().copy() for nt in steps]
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LOGIT_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for got, want in zip(tdec, jdec):
        np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_build_model_serves_moe_and_raises_for_mla():
    """The MoE family's facade defaults to the card; its MLA config,
    deepseek-v2-236b (a leading dense layer, shared experts, MLA
    attention), builds too, on the card by default (``test_torch_mla.py``
    holds it to the reference)."""
    cfg = get_config(ARCH)
    api = build_model(cfg)
    assert api.device.type == "cuda"  # the card is the default
    mla = build_model(get_config("deepseek-v2-236b"))
    assert mla.device.type == "cuda" and mla.cfg.use_mla
    assert mla.cfg.family == "moe" and mla.cfg.moe_shared_experts == 2
    p = TT.init_params(dataclasses.replace(
        get_smoke_config(ARCH), moe_first_dense=1, moe_shared_experts=1),
        torch.Generator().manual_seed(0), "cpu")
    assert "mlp" in p["layers"][0] and "moe" in p["layers"][1]
    moe = p["layers"][1]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].shape == (8, 64, 128) and moe["wd"].shape == (8, 128, 64)
    assert moe["shared_wd"].shape == (128, 64)


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
    cfg, jcfg, params, jparams = _params(1, 1)
    prompts = _prompts(cfg, PROMPT_LENS, seed=3)
    got = _drain(_engine(cfg, params, "slot", max_slots=lanes, max_seq=64),
                 prompts)
    jeng = JaxSlot(jcfg, max_slots=lanes, max_seq=64, policy=JPOLICY)
    jeng.load(jparams)
    assert got == _drain(jeng, prompts)


@pytest.mark.parametrize("lanes", [1, 4])
def test_paged_engine_matches_the_reference_paged_engine(lanes):
    cfg, jcfg, params, jparams = _params(1, 1)
    prompts = _prompts(cfg, PROMPT_LENS, seed=3)
    eng = _engine(cfg, params, "paged", max_lanes=lanes, max_seq=64,
                  block_size=8)
    got = _drain(eng, prompts)
    jeng = JaxPaged(jcfg, max_lanes=lanes, max_seq=64, block_size=8,
                    policy=JPOLICY)
    jeng.load(jparams)
    assert got == _drain(jeng, prompts)
    assert eng.stats["decode_compiles"] == 1


def test_slot_equals_paged_at_one_lane():
    """The reference's guarantee (tests/test_paged_serving.py,
    ``test_paged_matches_slot_across_families``) on the port's MoE."""
    cfg, _, params, _ = _params()
    prompts = _prompts(cfg, [5, 9, 7, 12], seed=1)
    slot = _drain(_engine(cfg, params, "slot", max_slots=1, max_seq=64),
                  prompts)
    paged = _drain(_engine(cfg, params, "paged", max_lanes=1, max_seq=64,
                           block_size=8), prompts)
    assert slot == paged


def test_paged_moe_prefills_at_exact_lengths_as_the_reference():
    """Bucket pads would take expert slots from real tokens: the paged
    engine prefills MoE prompts at their exact length whatever the
    scheduler's buckets, one prefill shape per prompt length, and counts
    ``prefill_compiles`` as the reference does."""
    cfg, jcfg, params, jparams = _params()
    prompts = _prompts(cfg, [5, 9, 5, 13, 9], seed=2)
    eng = _engine(cfg, params, "paged", max_lanes=2, max_seq=64,
                  block_size=8, prompt_len=6)
    tp.planned_report_clear()
    got = _drain(eng, prompts)
    jeng = JaxPaged(jcfg, max_lanes=2, max_seq=64, block_size=8,
                    prompt_len=6, policy=JPOLICY)
    jeng.load(jparams)
    assert got == _drain(jeng, prompts)
    assert eng.stats["prefill_compiles"] == jeng.stats["prefill_compiles"] \
        == 3
    assert eng._prefill_shapes == {(n, ("tokens",), False)
                                   for n in (5, 9, 13)}
    # the router ran at each exact length, never at a bucket's
    rows = {eval(s)[0] for s in tp.planned_report()["moe.router"]["shapes"]}
    assert {5, 9, 13} <= rows and not rows & {8, 16}


# ---------------------------------------------------------------------------
# the hand kernels' configurations at olmoe's full-width shapes
# ---------------------------------------------------------------------------

def test_moe_gemms_take_the_hand_kernels_configurations():
    """The float32 router: the skinny kernel up to 16 rows, K split over
    a full cluster (its B of 512 KB alone would leave two blocks walking
    64 stages of K), the tensor-core kernel above; the expert stack: the
    skinny kernel at decode (C = 1) with a block for every SM, the
    tensor-core kernel at a 512-token prompt's C = 80."""
    from repro_torch.kernels import runtime

    f32, bf16 = torch.float32, torch.bfloat16
    for rows in range(1, runtime.SKINNY_ROWS + 1):
        tile = runtime.skinny_tile(rows, 64, 2048, 1, f32)
        assert tile == runtime.SkinnyTile(split=8, kblk=256)
        assert tile.kblk // runtime.skinny_bk(f32) <= 8
    assert runtime.skinny_tile(17, 64, 2048, 1, f32) is None
    assert runtime.tc_tile(512, 64, 2048, f32) is not None
    cfg = get_config(ARCH)
    assert TM.capacity_of(cfg, 4) == 1 and TM.capacity_of(cfg, 512) == 80
    e, d, ff = cfg.moe_num_experts, cfg.d_model, cfg.moe_d_ff
    for n, k in ((ff, d), (d, ff)):
        tile = runtime.skinny_tile(1, n, k, e, bf16)
        assert tile.blocks(n, e) >= runtime.SMS
        assert runtime.tc_tile(80, n, k, bf16, e) is not None


def test_small_b_splits_only_where_k_runs_deep():
    """The split rule for a B of at most 1 MiB: shapes whose column tiles
    fill the SMs, or whose K is at most two ring stages, stay whole
    (qwen's decode values); deeper K is split until no rank walks more
    than ``SKINNY_DEEP_STAGES`` stages (whisper-base's d 512 projections
    at decode, its encoder chunk's values over 1024 frames)."""
    from repro_torch.kernels import runtime

    bf16 = torch.bfloat16
    assert runtime.skinny_tile(1, 64, 128, 64, bf16).split == 1
    assert runtime.skinny_tile(4, 512, 512, 1, bf16).split == 4
    assert runtime.skinny_tile(8, 64, 1024, 8, bf16).split == 8
    # a B above 1 MiB keeps the rule it had: a block for every SM at least
    big = runtime.skinny_tile(4, 1024, 1024, 1, bf16)
    assert big.split == 8 and big.blocks(1024) >= runtime.SMS
