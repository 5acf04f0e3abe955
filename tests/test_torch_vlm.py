"""The port's vlm family and the dense configs it newly registers against
the JAX reference at SMOKE width.

* The three configs ``llava-next-mistral-7b``, ``stablelm-12b`` and
  ``codeqwen1.5-7b``: the port's ``CONFIG`` and ``SMOKE`` equal the
  reference's, field for field.
* llava-next-mistral-7b (vlm: the dense backbone with [B, P, d] patch
  embeddings through ``patch_proj`` prepended): JAX initializes the
  parameters, ``convert.params_from_jax`` carries them over,
  ``patch_proj`` among them.  Forward hidden states, the exact and the
  bucketed prefill's logits and cache, and three decode steps' logits
  must match the reference within ``atol = rtol = 1e-4`` (float32 SMOKE
  config and an fp32 KV cache, as qwen3-32b's in ``test_torch_dense.py``:
  both sides compute in fp32 and differ only in summation order); every
  planned site, ``vlm.patch_proj`` among them, plans the reference's
  shapes with the reference's plans.  The slot and paged engines' greedy
  tokens on requests with patch embeddings must equal the reference
  engines' at 1 and 4 lanes.
* stablelm-12b and codeqwen1.5-7b (its KV cache in fp8 e4m3): prefill and
  two decode steps' logits within 1e-4 of the reference's on each
  config's own cache dtype; codeqwen's fp8 prefill cache within one fp8
  step (2^-3 relative) where fp32 values straddle a rounding boundary.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.autotune import PlanPolicy as JaxPolicy  # noqa: E402
from repro.kernels import planned as jp  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import PagedServeEngine as JaxPaged  # noqa: E402
from repro.serve import ServeEngine as JaxSlot  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import planned as tp  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import make_engine  # noqa: E402

ARCH = "llava-next-mistral-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
JPOLICY = JaxPolicy(mode="modelled")
NEW_CONFIGS = {"llava-next-mistral-7b": "llava_next_mistral_7b",
               "stablelm-12b": "stablelm_12b",
               "codeqwen1.5-7b": "codeqwen15_7b"}


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", list(NEW_CONFIGS))
def test_configs_equal_the_reference_field_for_field(arch, name):
    mod = NEW_CONFIGS[arch]
    want = getattr(importlib.import_module(f"repro.configs.{mod}"), name)
    got = getattr(importlib.import_module(f"repro_torch.configs.{mod}"),
                  name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (get_config(arch) if name == "CONFIG"
            else get_smoke_config(arch)) is got


def _params(arch=ARCH, seed=0):
    """(port cfg, reference cfg, port params, reference params)."""
    jcfg = jax_smoke(arch)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = get_smoke_config(arch)
    return cfg, jcfg, params_from_jax(jax.tree.map(np.asarray, jparams),
                                      cfg, "cpu"), jparams


def _patches(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.vlm_patches, cfg.d_model)).astype(np.float32)


def test_params_from_jax_carries_patch_proj():
    cfg, _, params, jparams = _params()
    assert params["patch_proj"].shape == (cfg.d_model, cfg.d_model)
    np.testing.assert_array_equal(params["patch_proj"].numpy(),
                                  np.asarray(jparams["patch_proj"]))
    drawn = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert drawn["patch_proj"].shape == (cfg.d_model, cfg.d_model)
    assert sorted(drawn) == sorted(params)


# ---------------------------------------------------------------------------
# the vlm model functions
# ---------------------------------------------------------------------------

#: the bucketed prefill: prompts of 9 tokens right-padded to 12, each
#: lane's logits at its last real token
BUCKET, LAST = 12, [8, 5]


@pytest.fixture(scope="module")
def vlm_runs():
    """Reference and port runs of forward, the exact and the bucketed
    prefill and 3 decode steps on the same tokens and patch embeddings,
    plus both facades' per-site reports."""
    cfg, jcfg, tparams, jparams = _params()
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    padded = np.zeros((2, BUCKET), np.int32)
    padded[:, :9] = tokens
    patches = _patches(cfg, 2, 2)
    steps = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
             for _ in range(3)]
    li = np.asarray(LAST, np.int32)
    rows = cfg.vlm_patches + 16

    jp.planned_report_clear()
    with jp.override(policy=JPOLICY):
        pe = jnp.asarray(patches)
        jh, _ = JT.forward(jparams, jcfg, jnp.asarray(tokens), pe)
        jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(tokens), rows,
                            cache_dtype=jnp.float32, extra_embeds=pe)
        jb, jbc = JT.prefill(jparams, jcfg, jnp.asarray(padded), rows,
                             cache_dtype=jnp.float32, extra_embeds=pe,
                             last_index=jnp.asarray(li))
        want = {"hidden": np.asarray(jh), "prefill": np.asarray(jl),
                "cache": jax.tree.map(np.asarray, jc),
                "bucketed": np.asarray(jb),
                "bucketed_pos": np.asarray(jbc["pos"]), "decode": []}
        for nt in steps:
            lg, jc = JT.decode_step(jparams, jcfg, jc, jnp.asarray(nt))
            want["decode"].append(np.asarray(lg))
    want["report"] = jp.planned_report()

    tp.reset_configuration()
    tp.planned_report_clear()
    with torch.no_grad():
        pe = torch.from_numpy(patches)
        th, _ = TT.forward(tparams, cfg, torch.from_numpy(tokens), pe)
        tl, tc = TT.prefill(tparams, cfg, torch.from_numpy(tokens), rows,
                            cache_dtype=torch.float32, extra_embeds=pe)
        tb, tbc = TT.prefill(tparams, cfg, torch.from_numpy(padded), rows,
                             cache_dtype=torch.float32, extra_embeds=pe,
                             last_index=torch.from_numpy(li))
        got = {"hidden": th.numpy(), "prefill": tl.numpy(),
               # copies: decode_step updates the cache in place
               "cache": {k: v.numpy().copy() for k, v in tc.items()},
               "bucketed": tb.numpy(), "bucketed_pos": tbc["pos"].numpy(),
               "decode": []}
        for nt in steps:
            lg, tc = TT.decode_step(tparams, cfg, tc, torch.from_numpy(nt))
            got["decode"].append(lg.numpy().copy())
    got["report"] = tp.planned_report()
    return want, got


def test_vlm_forward_matches_reference(vlm_runs):
    want, got = vlm_runs
    assert got["hidden"].shape == (2, 16 + 9, 64)  # patch rows first
    np.testing.assert_allclose(got["hidden"], want["hidden"], **TOL)


def test_vlm_prefill_logits_and_cache_match_reference(vlm_runs):
    want, got = vlm_runs
    np.testing.assert_allclose(got["prefill"], want["prefill"], **TOL)
    np.testing.assert_array_equal(got["cache"]["pos"], want["cache"]["pos"])
    assert (got["cache"]["pos"] == 16 + 9).all()
    for key in ("k", "v"):
        np.testing.assert_allclose(got["cache"][key], want["cache"][key],
                                   **TOL)


def test_vlm_bucketed_prefill_reads_past_the_patch_rows(vlm_runs):
    """``last_index`` counts text tokens: the logits come from hidden row
    P + last_index and ``pos`` is set past it, as the reference's."""
    want, got = vlm_runs
    np.testing.assert_allclose(got["bucketed"], want["bucketed"], **TOL)
    np.testing.assert_array_equal(got["bucketed_pos"],
                                  np.asarray(LAST) + 16 + 1)
    np.testing.assert_array_equal(got["bucketed_pos"], want["bucketed_pos"])
    # lane 0's last real token is the exact prompt's last one
    np.testing.assert_allclose(got["bucketed"][0], got["prefill"][0], **TOL)


@pytest.mark.parametrize("step", range(3))
def test_vlm_decode_step_logits_match_reference(vlm_runs, step):
    want, got = vlm_runs
    np.testing.assert_allclose(got["decode"][step], want["decode"][step],
                               **TOL)


def test_vlm_sites_plan_the_reference_plans(vlm_runs):
    want, got = vlm_runs
    assert "vlm.patch_proj" in got["report"]
    assert set(got["report"]) == set(want["report"])
    for site, st in got["report"].items():
        ref = want["report"][site]
        assert st["fallback"] == ref["fallback"] == 0, site
        assert set(st["shapes"]) == set(ref["shapes"]), site
        assert st["last_plan"] == ref["last_plan"], site
    assert set(got["report"]["vlm.patch_proj"]["shapes"]) == {
        str((2 * 16, 64, 64))}


def test_build_model_serves_and_trains_vlm():
    cfg = get_config(ARCH)
    api = build_model(cfg)
    assert api.device.type == "cuda"  # the card is the default
    assert api.loss is not None
    assert cfg.vlm_patches == 576 and cfg.family == "vlm"


# ---------------------------------------------------------------------------
# the engines with patch embeddings: greedy tokens equal the reference's
# ---------------------------------------------------------------------------

PROMPT_LENS = [5, 9, 13, 4, 17, 7]


def _requests(cfg, seed=3):
    """Requests of ``PROMPT_LENS`` tokens, each with patch embeddings of
    its own but the last, a text-only one."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, n).astype(np.int32),
             _patches(cfg, 1, seed + i)[0] if i + 1 < len(PROMPT_LENS)
             else None)
            for i, n in enumerate(PROMPT_LENS)]


def _drain(eng, requests, max_new=5):
    for prompt, pe in requests:
        eng.submit(prompt, max_new_tokens=max_new,
                   extra=None if pe is None else {"extra_embeds": pe})
    return {r.rid: list(r.output) for r in eng.run_until_drained(4000)}


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_vlm_engines_match_the_reference_engines(kind, lanes):
    """Each request but a text-only one carries its own patch
    embeddings; the paged engine buckets the text and reserves blocks for
    the patch rows besides."""
    cfg, jcfg, params, jparams = _params()
    requests = _requests(cfg)
    if kind == "slot":
        eng = make_engine(cfg, kind="slot", max_slots=lanes, max_seq=64,
                          device="cpu", prompt_len=8)
        jeng = JaxSlot(jcfg, max_slots=lanes, max_seq=64, prompt_len=8,
                       policy=JPOLICY)
    else:
        eng = make_engine(cfg, kind="paged", max_lanes=lanes, max_seq=64,
                          block_size=8, device="cpu", prompt_len=8)
        jeng = JaxPaged(jcfg, max_lanes=lanes, max_seq=64, block_size=8,
                        prompt_len=8, policy=JPOLICY)
    tp.reset_configuration()
    eng.load(params)
    # load() planned the patch projection on zero patch embeddings
    assert "vlm.patch_proj" in eng.plan_report
    got = _drain(eng, requests)
    jeng.load(jparams)
    assert got == _drain(jeng, requests)
    if kind == "paged":
        assert eng.stats["decode_compiles"] == 1
        # the prefills took the requests' patch embeddings, but the
        # text-only one's
        assert {keys for _, keys, _ in eng._prefill_shapes} == {
            ("extra_embeds", "tokens"), ("tokens",)}


def test_vlm_request_horizon_counts_the_patch_rows():
    cfg, _, params, _ = _params()
    eng = make_engine(cfg, kind="paged", max_lanes=1, max_seq=32,
                      block_size=8, device="cpu")
    pe = _patches(cfg, 1, 0)[0]
    eng.submit(np.zeros(8, np.int32), max_new_tokens=8,
               extra={"extra_embeds": pe})  # 16 + 8 + 8 = 32 rows
    with pytest.raises(ValueError, match="16 extra"):
        eng.submit(np.zeros(9, np.int32), max_new_tokens=8,
                   extra={"extra_embeds": pe})


# ---------------------------------------------------------------------------
# stablelm-12b and codeqwen1.5-7b (fp8 KV cache)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-12b", "codeqwen1.5-7b"])
def test_dense_config_logits_match_reference(arch):
    cfg, jcfg, tparams, jparams = _params(arch, seed=5)
    cache = cfg.kv_cache_dtype
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
             for _ in range(2)]
    with jp.override(policy=JPOLICY):
        jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(tokens), 16,
                            cache_dtype=getattr(jnp, cache))
        jcache = {k: np.asarray(v).astype(np.float32) for k, v in jc.items()}
        jdec = []
        for nt in steps:
            lg, jc = JT.decode_step(jparams, jcfg, jc, jnp.asarray(nt))
            jdec.append(np.asarray(lg))
    tp.reset_configuration()
    with torch.no_grad():
        tl, tc = TT.prefill(tparams, cfg, torch.from_numpy(tokens), 16,
                            cache_dtype=getattr(torch, cache))
        tcache = {k: v.float().numpy().copy() for k, v in tc.items()}
        tdec = [TT.decode_step(tparams, cfg, tc, torch.from_numpy(nt))[0]
                .numpy().copy() for nt in steps]
    assert tc["k"].dtype == getattr(torch, cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    step = 2.0 ** -3 if cache == "float8_e4m3fn" else 1e-4
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key], jcache[key], rtol=step,
                                   atol=1e-4)
    for got, want in zip(tdec, jdec):
        np.testing.assert_allclose(got, want, **TOL)
