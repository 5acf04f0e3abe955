"""The port's dense model against the JAX reference at SMOKE width.

JAX initializes the parameters; they cross over as numpy arrays through
``convert.params_from_jax``.  Forward hidden states, prefill logits and
cache, and the logits of three decode steps must match the reference
(float32 SMOKE config, JAX under the modelled policy as the port) within
``atol = rtol = 1e-4``: both sides compute in fp32 and differ only in
summation order (observed differences are ~1e-6).  qwen1.5-0.5b keeps
its bf16 KV cache, which may differ by one bf16 step where the fp32
values straddle a rounding boundary; qwen3-32b (grouped KV heads,
qk_norm) runs with an fp32 cache, since such a flip in a grouped cache
moves its decode logits by ~1e-3.  Every planned site must plan the same
shapes with the same plans in both packages.
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
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import planned as tp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "qwen1.5-0.5b"


@pytest.fixture(scope="module", params=[
    (ARCH, "bfloat16"), ("qwen3-32b", "float32")],
    ids=["qwen1.5-0.5b", "qwen3-32b-fp32-cache"])
def runs(request):
    """Reference and port runs of forward, prefill and 3 decode steps on
    the same tokens, plus both facades' per-site reports."""
    arch, cache = request.param
    cfg = jax_smoke(arch)
    jparams = JT.init_params(jax.random.PRNGKey(0), cfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              get_smoke_config(arch), "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
             for _ in range(3)]

    jp.planned_report_clear()
    with jp.override(policy=JaxPolicy(mode="modelled")):
        jh, _ = JT.forward(jparams, cfg, jnp.asarray(tokens))
        jl, jc = JT.prefill(jparams, cfg, jnp.asarray(tokens), 16,
                            cache_dtype=getattr(jnp, cache))
        jax_run = {"hidden": np.asarray(jh), "prefill": np.asarray(jl),
                   "cache": jax.tree.map(np.asarray, jc), "decode": []}
        for nt in steps:
            lg, jc = JT.decode_step(jparams, cfg, jc, jnp.asarray(nt))
            jax_run["decode"].append(np.asarray(lg))
    jax_run["report"] = jp.planned_report()

    tp.reset_configuration()
    tp.planned_report_clear()
    with torch.no_grad():
        cfg_t = get_smoke_config(arch)
        th = TT.forward(tparams, cfg_t, torch.from_numpy(tokens))
        tl, tc = TT.prefill(tparams, cfg_t, torch.from_numpy(tokens), 16,
                            cache_dtype=getattr(torch, cache))
        port_run = {"hidden": th.numpy(), "prefill": tl.numpy(),
                    # copies: decode_step updates the cache in place
                    "cache": {k: v.float().numpy().copy()
                              for k, v in tc.items()},
                    "decode": []}
        for nt in steps:
            lg, tc = TT.decode_step(tparams, cfg_t, tc, torch.from_numpy(nt))
            port_run["decode"].append(lg.numpy())
    port_run["report"] = tp.planned_report()
    port_run["cache_rtol"] = 2.0 ** -7 if cache == "bfloat16" else 1e-4
    return jax_run, port_run


def test_forward_matches_reference(runs):
    want, got = runs
    np.testing.assert_allclose(got["hidden"], want["hidden"], **TOL)


def test_prefill_logits_and_cache_match_reference(runs):
    want, got = runs
    np.testing.assert_allclose(got["prefill"], want["prefill"], **TOL)
    np.testing.assert_array_equal(got["cache"]["pos"],
                                  want["cache"]["pos"].astype(np.float32))
    for key in ("k", "v"):
        np.testing.assert_allclose(
            got["cache"][key], want["cache"][key].astype(np.float32),
            rtol=got["cache_rtol"], atol=1e-4)


@pytest.mark.parametrize("step", range(3))
def test_decode_step_logits_match_reference(runs, step):
    want, got = runs
    np.testing.assert_allclose(got["decode"][step], want["decode"][step],
                               **TOL)


def test_every_site_plans_the_reference_plans(runs):
    want, got = runs
    assert set(got["report"]) == set(want["report"])
    for site, st in got["report"].items():
        ref = want["report"][site]
        assert st["fallback"] == ref["fallback"] == 0, site
        assert set(st["shapes"]) == set(ref["shapes"]), site
        assert st["last_plan"] == ref["last_plan"], site


@pytest.fixture(scope="module", params=[17, 33], ids=["P17", "P33"])
def odd_prompt(request):
    """Reference and port prefill of one odd-length prompt of more than 16
    tokens (qwen1.5-0.5b at SMOKE, bf16 cache) and 3 greedy decode steps,
    each side feeding its own argmax, plus both facades' reports."""
    p = request.param
    cfg = jax_smoke(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(2), cfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams),
                              get_smoke_config(ARCH), "cpu")
    tokens = np.random.default_rng(p).integers(0, cfg.vocab, (1, p)).astype(
        np.int32)
    max_seq = p + 8
    jax_run, port_run = {"logits": [], "tokens": []}, {"logits": [],
                                                        "tokens": []}
    jp.planned_report_clear()
    with jp.override(policy=JaxPolicy(mode="modelled")):
        lg, jc = JT.prefill(jparams, cfg, jnp.asarray(tokens), max_seq,
                            cache_dtype=jnp.bfloat16)
        for _ in range(4):
            jax_run["logits"].append(np.asarray(lg))
            nt = np.argmax(np.asarray(lg), axis=-1).astype(np.int32)[:, None]
            jax_run["tokens"].append(int(nt[0, 0]))
            lg, jc = JT.decode_step(jparams, cfg, jc, jnp.asarray(nt))
    jax_run["report"] = jp.planned_report()
    tp.reset_configuration()
    tp.planned_report_clear()
    with torch.no_grad():
        cfg_t = get_smoke_config(ARCH)
        lg, tc = TT.prefill(tparams, cfg_t, torch.from_numpy(tokens), max_seq,
                            cache_dtype=torch.bfloat16)
        for _ in range(4):
            port_run["logits"].append(lg.numpy().copy())
            nt = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
            port_run["tokens"].append(int(nt[0, 0]))
            lg, tc = TT.decode_step(tparams, cfg_t, tc, nt)
    port_run["report"] = tp.planned_report()
    return jax_run, port_run


def test_odd_prompt_prefill_logits_and_greedy_tokens_match_reference(
        odd_prompt):
    """The scores of an odd-length prompt read K column-major (its rows of
    the head dimension), the values A in rows of an odd key count: the
    prefill and each greedy decode step stay within ``TOL`` of the
    reference, and the greedy tokens are the same."""
    want, got = odd_prompt
    for g, w in zip(got["logits"], want["logits"]):
        np.testing.assert_allclose(g, w, **TOL)
    assert got["tokens"] == want["tokens"]


def test_odd_prompt_sites_plan_the_reference_plans(odd_prompt):
    """Every site plans the reference's shapes with the reference's plans
    and neither falls back (the reference counts a jitted call once per
    trace, the port every call, so the counts are not compared)."""
    want, got = odd_prompt
    assert set(got["report"]) == set(want["report"])
    for site, st in got["report"].items():
        ref = want["report"][site]
        assert st["fallback"] == ref["fallback"] == 0, site
        assert st["reasons"] == ref["reasons"], site
        assert set(st["shapes"]) == set(ref["shapes"]), site
        assert st["last_plan"] == ref["last_plan"], site


@pytest.mark.parametrize("batch,skv", [(1, 17), (1, 12), (2, 33)])
def test_scores_read_k_column_major(monkeypatch, batch, skv):
    """The scores bmm gets B = K^T as the transpose of a contiguous
    [B*Hkv, Skv, hd] tensor (one key a row of hd values) at any batch and
    key count, so its rows are whole 16-byte units for the GEMM kernels;
    the scores equal an explicit einsum."""
    from repro_torch.kernels import runtime
    from repro_torch.models import layers

    seen = []
    real = layers.planned_bmm

    def spy(a, b, **kw):
        seen.append(b)
        return real(a, b, **kw)

    monkeypatch.setattr(layers, "planned_bmm", spy)
    gen = torch.Generator().manual_seed(batch * skv)
    qg = torch.randn((batch, 5, 4, 2, 64), generator=gen)
    k = torch.randn((batch, skv, 4, 64), generator=gen)
    s = layers._gqa_scores(qg, k, "attn.scores")
    (kb,) = seen
    assert kb.shape == (batch * 4, 64, skv)
    assert runtime.b_col_major(kb) == 1 and kb.transpose(1, 2).is_contiguous()
    assert runtime.b_copy_bytes(kb) == 16
    want = torch.einsum("bqhgd,bkhd->bhgqk", qg, k)
    torch.testing.assert_close(s, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("skv", [17, 24, 33])
def test_values_read_softmax_weights_in_padded_rows(monkeypatch, skv):
    """The values bmm gets the softmax weights as an A whose rows are
    padded to whole 16-byte units (a view of the first Skv columns, rows
    evenly pitched), so TMA addresses them at any key count; the output
    equals the attention computed directly."""
    from repro_torch.kernels import runtime
    from repro_torch.models import layers

    seen = []
    real = layers.planned_bmm

    def spy(a, b, **kw):
        seen.append(a)
        return real(a, b, **kw)

    monkeypatch.setattr(layers, "planned_bmm", spy)
    gen = torch.Generator().manual_seed(skv)
    q, k, v = (torch.randn((1, skv, 4, 64), generator=gen).to(torch.bfloat16)
               for _ in range(3))
    out = layers.sdpa(q, k, v, causal=True)
    a = seen[-1]
    pitch = runtime.a_pitch(a)
    assert pitch == -(-skv // 8) * 8 and runtime.tma_operand(a, pitch)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8.0
    s = s.masked_fill(torch.ones(skv, skv).triu(1).bool(), -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd",
                        torch.softmax(s, -1).to(torch.bfloat16).float(),
                        v.float())
    torch.testing.assert_close(out.float(), want, rtol=2.0 ** -7, atol=1e-3)


def test_bf16_leaves_keep_their_bits():
    cfg = dataclasses.replace(jax_smoke(ARCH), dtype="bfloat16")
    jparams = JT.init_params(jax.random.PRNGKey(1), cfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    want = np.asarray(jparams["dense_layers"]["attn"]["wq"][1])
    got = tparams["layers"][1]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_init_params_draws_full_width_shapes_from_a_seed():
    cfg = dataclasses.replace(get_config(ARCH), n_layers=1, vocab=512)
    a = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(a["layers"][0]["mlp"]["wd"], b["layers"][0]["mlp"]["wd"])
    assert a["layers"][0]["attn"]["wq"].shape == (1024, 1024)
    assert a["layers"][0]["mlp"]["wg"].shape == (1024, 2816)
    assert a["embed"].dtype == torch.bfloat16
    assert "lm_head" not in a  # qwen1.5-0.5b ties its head


def test_unported_families_raise():
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(get_smoke_config(ARCH),
                                        family="moe"), "cpu")
    with pytest.raises(ValueError, match="not ported"):
        get_smoke_config("mamba2-780m")
