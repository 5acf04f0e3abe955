"""The port's blockwise attention and its dispatch against the JAX
package's, and long qwen prompts served on both port engines.

``blockwise_attention`` takes the same numpy operands (drawn from a
seeded generator) in both packages: causal and not, ``block_skip`` on and
off, sequence lengths that are multiples of neither chunk, chunks of
16/16 and of the serving 512/1024.  In float32 the outputs agree within
``atol=2e-4, rtol=1e-3`` (the tolerance of ``tests/test_property.py``'s
attention checks): both take fp32 scores of the same operands and differ
in summation order only.  In bfloat16 they agree within ``rtol=2^-7``
plus an ``atol`` of ``2^-8 max|want|``, at most one bf16 step of the
largest output: each chunk's value product rounds to bf16 in both, in
another order, and the output rounds to bf16 again, so an element may
land a step apart.  The outputs here range from ~0.04 on average to ~3 at
most, so the atol scales with them; the measured differences use about
half of this bound, and score products rounded to bf16 (instead of fp32)
exceed it in most non-causal cases.

``attention_core`` picks the direct ``sdpa`` at 2048 rows and blockwise
at 2049, and the direct path whenever a streaming mask is given, as the
reference does.  A 2304-token prompt on the qwen smoke config is served
by the port's slot and paged engines with the reference engines' greedy
tokens, its prefill logits within the dense tolerance (``atol = rtol =
1e-4``, ``tests/test_torch_dense.py``), and ``causal_block_skip`` is held
to the reference's on a replaced smoke config.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.autotune import PlanPolicy as JaxPolicy  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import make_engine  # noqa: E402

F32_TOL = dict(atol=2e-4, rtol=1e-3)
BF16_RTOL = 2.0 ** -7
DENSE_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "qwen1.5-0.5b"
LONG = 2304           # above BLOCKWISE_SEQ_THRESHOLD, a multiple of no chunk
MAX_SEQ = 2320        # LONG + the new tokens, in whole blocks of 16
MAX_NEW = 4


def _operands(sq, skv, h=3, hkv=None, d=16, seed=0):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (rng.standard_normal((2, sq, h, d)).astype(np.float32),
            rng.standard_normal((2, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((2, skv, hkv, d)).astype(np.float32))


def _both(fn_j, fn_t, arrays, dtype, **kw):
    want = fn_j(*(jnp.asarray(x, getattr(jnp, dtype)) for x in arrays), **kw)
    got = fn_t(*(torch.from_numpy(x).to(getattr(torch, dtype))
                 for x in arrays), **kw)
    return got, want


def _close(got, want, dtype):
    assert str(got.dtype) == f"torch.{dtype}"
    want = np.asarray(want.astype(jnp.float32))
    tol = F32_TOL if dtype == "float32" else dict(
        atol=2.0 ** -8 * np.abs(want).max(), rtol=BF16_RTOL)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunks,sq,skv", [
    ((16, 16), 37, 53), ((16, 16), 53, 53), ((512, 1024), 1100, 1300),
    ((512, 1024), 1300, 1300)], ids=["16-37x53", "16-53", "512-1100x1300",
                                     "512-1300"])
@pytest.mark.parametrize("causal,block_skip", [
    (True, False), (True, True), (False, False), (False, True)],
    ids=["causal", "causal-skip", "full", "full-skip"])
def test_blockwise_matches_the_reference(dtype, chunks, sq, skv, causal,
                                         block_skip):
    got, want = _both(JL.blockwise_attention, L.blockwise_attention,
                      _operands(sq, skv), dtype, causal=causal,
                      q_chunk=chunks[0], k_chunk=chunks[1],
                      block_skip=block_skip)
    assert tuple(got.shape) == want.shape == (2, sq, 3, 16)
    _close(got, want, dtype)


def test_blockwise_equals_sdpa_below_the_threshold():
    """Where both apply, the online softmax over chunks is the direct
    softmax over all keys (fp32, causal and not)."""
    q, k, v = (torch.from_numpy(x) for x in _operands(300, 300))
    for causal in (True, False):
        torch.testing.assert_close(
            L.blockwise_attention(q, k, v, causal=causal, q_chunk=64,
                                  k_chunk=128),
            L.sdpa(q, k, v, causal=causal), **F32_TOL)


def _spied(monkeypatch, module):
    calls = []
    for name in ("sdpa", "blockwise_attention"):
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("case", [
    dict(s=2048), dict(s=2049), dict(s=2049, kv_len=True),
    dict(s=2049, chunk=512), dict(sq=8, skv=2049)],
    ids=["2048", "2049", "2049-kv_len", "2049-chunk", "8x2049"])
def test_attention_core_dispatches_as_the_reference(monkeypatch, case):
    """The same path in both packages — direct at 2048 rows, blockwise at
    2049, direct with a streaming mask at any length — and the same
    output, GQA (4 query heads over 2 kv heads) included."""
    sq = case.get("sq", case.get("s"))
    skv = case.get("skv", case.get("s"))
    arrays = _operands(sq, skv, h=4, hkv=2, d=8, seed=sq + skv)
    causal = sq == skv and "kv_len" not in case
    jkw, tkw = {}, {}
    if case.get("kv_len"):
        lens = np.asarray([1500, skv], np.int32)
        jkw["kv_len"], tkw["kv_len"] = jnp.asarray(lens), torch.from_numpy(
            lens)
    if case.get("chunk"):
        jkw["chunk"] = tkw["chunk"] = case["chunk"]
    jcalls, tcalls = _spied(monkeypatch, JL), _spied(monkeypatch, L)
    want = JL.attention_core(*(jnp.asarray(x) for x in arrays),
                             causal=causal, **jkw)
    got = L.attention_core(*(torch.from_numpy(x) for x in arrays),
                           causal=causal, **tkw)
    direct = max(sq, skv) <= L.BLOCKWISE_SEQ_THRESHOLD or len(jkw) > 0
    assert jcalls == tcalls == ["sdpa" if direct else "blockwise_attention"]
    _close(got, want, "float32")


def test_chunk_constants_are_the_reference_ones():
    assert (L.BLOCKWISE_SEQ_THRESHOLD, L.Q_CHUNK, L.K_CHUNK) == (
        JL.BLOCKWISE_SEQ_THRESHOLD, JL.Q_CHUNK, JL.K_CHUNK)
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(L.gqa_expand(torch.from_numpy(k), 6),
                                  np.asarray(JL.gqa_expand(k, 6)))


# ---------------------------------------------------------------------------
# a long qwen prompt, end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke(ARCH)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(42))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    prompt = np.random.default_rng(11).integers(0, cfg.vocab, LONG).astype(
        np.int32)
    return cfg, jcfg, params, jparams, prompt


def _served(eng, prompt):
    eng.submit(prompt, max_new_tokens=MAX_NEW)
    (req,) = eng.run_until_drained()
    return list(req.output)


def test_long_prompt_prefill_logits_match_the_reference(qwen):
    cfg, jcfg, params, jparams, prompt = qwen
    with torch.no_grad():
        got, cache = TT.prefill(params, cfg, torch.from_numpy(prompt[None]),
                                MAX_SEQ)
    want, jcache = JT.prefill(jparams, jcfg, jnp.asarray(prompt[None]),
                              MAX_SEQ)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DENSE_TOL)
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist() == [
        LONG]


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_long_prompt_greedy_tokens_equal_the_reference_engines(qwen, kind):
    """A 2304-token prompt (blockwise prefill) on the port's engine and on
    the reference's of the same kind: the same greedy tokens, the slot
    and paged engines' alike; the paged prefill runs at the exact
    length, past the last bucket."""
    cfg, jcfg, params, jparams, prompt = qwen
    kw = ({"max_lanes": 1, "block_size": 16} if kind == "paged"
          else {"max_slots": 1})
    eng = make_engine(cfg, kind=kind, max_seq=MAX_SEQ, device="cpu", **kw)
    eng.load(params)
    jeng = jax_make_engine(jcfg, kind=kind, max_seq=MAX_SEQ,
                           policy=JaxPolicy(mode="modelled"), **kw)
    jeng.load(jparams)
    got = _served(eng, prompt)
    assert got == _served(jeng, prompt)
    assert len(got) == MAX_NEW
    if kind == "paged":
        assert eng.stats["prefill_compiles"] == 1
        assert eng.stats["decode_compiles"] == 1
        slot = make_engine(cfg, kind="slot", max_slots=1, max_seq=MAX_SEQ,
                           device="cpu")
        slot.load(params)
        assert _served(slot, prompt) == got


def test_causal_block_skip_matches_the_reference(qwen):
    """``causal_block_skip=True`` on a replaced smoke config: the port's
    triangular schedule gives the reference's logits, and (the chunks it
    skips being fully masked) the full schedule's."""
    _, _, params, jparams, prompt = qwen
    cfg = dataclasses.replace(get_smoke_config(ARCH), causal_block_skip=True)
    jcfg = dataclasses.replace(jax_smoke(ARCH), causal_block_skip=True)
    tokens = prompt[None]
    with torch.no_grad():
        got, _ = TT.prefill(params, cfg, torch.from_numpy(tokens), MAX_SEQ)
        full, _ = TT.prefill(params, get_smoke_config(ARCH),
                             torch.from_numpy(tokens), MAX_SEQ)
    want, _ = JT.prefill(jparams, jcfg, jnp.asarray(tokens), MAX_SEQ)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DENSE_TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **DENSE_TOL)
