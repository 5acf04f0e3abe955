"""The port's encdec model (whisper-base, SMOKE width, float32) against the
JAX package's.

Both packages take the same parameters (the reference's init, converted
with ``params_from_jax``) and the same numpy frames and tokens.  The
offline encoder (``encode``, whole-utterance and block-causal) and
prefill over precomputed frames (``prefill``), the streaming encoder
(``encode_chunk``), the cross K/V projection (``enc_kv_chunk``), the
whole-utterance comparator (``prefill_streaming``) and ``decode_step``
must agree within 1e-4: both
compute in float32, but in other orders (XLA's fused dots against
PyTorch's), so a few ulps of difference pass through the layers.  The
caches are float32 (``kv_cache_dtype``), since a bf16 cache would round a
value sitting near a bf16 step the other way in one package.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import init_params, params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ARCH = "whisper-base"
CFG = dataclasses.replace(get_smoke_config(ARCH), kv_cache_dtype="float32")
JCFG = dataclasses.replace(jax_smoke(ARCH), kv_cache_dtype="float32")
CHUNK, N_CHUNKS, MAX_SEQ = 8, 3, 32
TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    jparams = jax_build(JCFG).init(jax.random.PRNGKey(42))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                                    "cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    return rng.standard_normal(
        (2, CHUNK * N_CHUNKS, CFG.d_model)).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def test_sinusoids_match_the_reference():
    # float32 sin/cos of angles up to 40 rad: the two libraries' range
    # reductions differ by a few ulps of the angle
    _close(E.sinusoids(40, 64), JE.sinusoids(40, 64), 1e-5)


def test_streaming_encoder_matches_the_reference(params, frames):
    jparams, tparams = params
    jec = JE.init_enc_cache(JCFG, 2)
    ec = E.init_enc_cache(CFG, 2, device="cpu")
    for i in range(N_CHUNKS):
        fc = frames[:, i * CHUNK:(i + 1) * CHUNK]
        jec, jout = JE.encode_chunk(jparams, JCFG, jec, jnp.asarray(fc))
        ec, out = E.encode_chunk(tparams, CFG, ec, torch.from_numpy(fc))
        _close(out, jout)
        jk, jv = JE.enc_kv_chunk(jparams, JCFG, jout, jnp.float32)
        k, v = E.enc_kv_chunk(tparams, CFG, out, torch.float32)
        assert tuple(k.shape) == jk.shape == (
            CFG.n_layers, 2, CHUNK, CFG.n_kv_heads, CFG.hd)
        _close(k, jk)
        _close(v, jv)
    for leaf in ("k", "v"):
        _close(ec[leaf], jec[leaf])
    np.testing.assert_array_equal(ec["len"].numpy(), np.asarray(jec["len"]))


def test_prefill_streaming_and_decode_match_the_reference(params, frames):
    jparams, tparams = params
    tokens = np.asarray([[0, 5, 9], [3, 1, 4]], np.int32)
    jlogits, jcache, jec = JE.prefill_streaming(
        jparams, JCFG, jnp.asarray(frames), jnp.asarray(tokens), MAX_SEQ,
        CHUNK, cache_dtype=jnp.float32)
    logits, cache, ec = E.prefill_streaming(
        tparams, CFG, torch.from_numpy(frames), torch.from_numpy(tokens),
        MAX_SEQ, CHUNK, cache_dtype=torch.float32)
    assert tuple(logits.shape) == jlogits.shape == (2, CFG.vocab)
    _close(logits, jlogits)
    for leaf in ("k", "v", "enc_k", "enc_v"):
        _close(cache[leaf], jcache[leaf])
    for leaf in ("enc_len", "pos"):
        np.testing.assert_array_equal(cache[leaf].numpy(),
                                      np.asarray(jcache[leaf]))
    _close(ec["k"], jec["k"])
    # three greedy decode steps from the same tokens
    nxt = np.argmax(np.asarray(jlogits), -1).astype(np.int32)[:, None]
    for _ in range(3):
        jlogits, jcache = JE.decode_step(jparams, JCFG, jcache,
                                         jnp.asarray(nxt))
        logits, cache = E.decode_step(tparams, CFG, cache,
                                      torch.from_numpy(nxt))
        _close(logits, jlogits)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        nxt = np.argmax(np.asarray(jlogits), -1).astype(np.int32)[:, None]
    _close(cache["k"], jcache["k"])


@pytest.mark.parametrize("chunk", [None, CHUNK], ids=["full", "chunked"])
def test_encode_matches_the_reference(params, frames, chunk):
    """Whole-utterance and block-causal ``encode`` against the reference's;
    the block-causal one also against the port's own incremental
    ``encode_chunk`` schedule, at fp32 tolerance, never bitwise (C1: the
    two run the attention over other key counts)."""
    jparams, tparams = params
    want = JE.encode(jparams, JCFG, jnp.asarray(frames), chunk=chunk)
    got = E.encode(tparams, CFG, torch.from_numpy(frames), chunk=chunk)
    assert tuple(got.shape) == want.shape == frames.shape
    _close(got, want)
    if chunk is None:
        return
    ec = E.init_enc_cache(CFG, 2, device="cpu")
    outs = []
    for i in range(N_CHUNKS):
        ec, out = E.encode_chunk(
            tparams, CFG, ec, torch.from_numpy(frames[:, i * CHUNK:
                                                      (i + 1) * CHUNK]))
        outs.append(out)
    _close(torch.cat(outs, dim=1), got.numpy())


def test_offline_prefill_and_decode_match_the_reference(params, frames):
    """``prefill`` over precomputed frames (encode, cross K/V, prompt) and
    three greedy decode steps from its cache, against the reference's."""
    jparams, tparams = params
    tokens = np.asarray([[0, 5, 9], [3, 1, 4]], np.int32)
    jlogits, jcache = JE.prefill(jparams, JCFG, jnp.asarray(frames),
                                 jnp.asarray(tokens), MAX_SEQ,
                                 cache_dtype=jnp.float32)
    logits, cache = E.prefill(tparams, CFG, torch.from_numpy(frames),
                              torch.from_numpy(tokens), MAX_SEQ,
                              cache_dtype=torch.float32)
    assert tuple(logits.shape) == jlogits.shape == (2, CFG.vocab)
    _close(logits, jlogits)
    for leaf in ("k", "v", "enc_k", "enc_v"):
        assert tuple(cache[leaf].shape) == jcache[leaf].shape, leaf
        _close(cache[leaf], jcache[leaf])
    for leaf in ("enc_len", "pos"):
        np.testing.assert_array_equal(cache[leaf].numpy(),
                                      np.asarray(jcache[leaf]))
    assert cache["enc_len"].tolist() == [CHUNK * N_CHUNKS] * 2
    nxt = np.argmax(np.asarray(jlogits), -1).astype(np.int32)[:, None]
    for _ in range(3):
        jlogits, jcache = JE.decode_step(jparams, JCFG, jcache,
                                         jnp.asarray(nxt))
        logits, cache = E.decode_step(tparams, CFG, cache,
                                      torch.from_numpy(nxt))
        _close(logits, jlogits)
        nxt = np.argmax(np.asarray(jlogits), -1).astype(np.int32)[:, None]
    # a bucketed prompt: logits at each lane's last real token
    li = np.asarray([1, 2], np.int32)
    jlogits, _ = JE.prefill(jparams, JCFG, jnp.asarray(frames),
                            jnp.asarray(tokens), MAX_SEQ,
                            cache_dtype=jnp.float32,
                            last_index=jnp.asarray(li))
    logits, cache = E.prefill(tparams, CFG, torch.from_numpy(frames),
                              torch.from_numpy(tokens), MAX_SEQ,
                              cache_dtype=torch.float32,
                              last_index=torch.from_numpy(li))
    _close(logits, jlogits)
    assert cache["pos"].tolist() == [2, 3]


def test_prefill_decoder_masks_the_unwritten_encoder_rows(params, frames):
    """Against a partially filled encoder cache (enc_len = 8 of 24 rows),
    the rows past enc_len are invisible: garbage there changes nothing."""
    _, tparams = params
    ek, ev = E.enc_kv_chunk(
        tparams, CFG, torch.from_numpy(frames[:1]), torch.float32)
    enc_len = torch.tensor([CHUNK], dtype=torch.int32)
    tokens = torch.tensor([[0, 2]], dtype=torch.int32)
    want, _ = E.prefill_decoder(tparams, CFG, ek, ev, enc_len, tokens,
                                MAX_SEQ, torch.float32)
    ek2, ev2 = ek.clone(), ev.clone()
    ek2[:, :, CHUNK:] = 1e3
    ev2[:, :, CHUNK:] = -1e3
    got, cache = E.prefill_decoder(tparams, CFG, ek2, ev2, enc_len, tokens,
                                   MAX_SEQ, torch.float32)
    assert torch.equal(got, want)
    assert cache["enc_len"].tolist() == [CHUNK] and \
        cache["pos"].tolist() == [2]


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=False, chunk=4),
                                dict(causal=False, kv_len=True),
                                dict(causal=True, chunk=3, kv_len=True)],
                         ids=str)
def test_sdpa_masks_match_the_reference(kw):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 12, 4, 8)).astype(np.float32)
               for _ in range(3))
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("kv_len", None):
        lens = np.asarray([5, 12], np.int32)
        jkw["kv_len"], tkw["kv_len"] = jnp.asarray(lens), torch.from_numpy(
            lens)
    want = JL.sdpa(*(jnp.asarray(x) for x in (q, k, v)), **jkw)
    got = L.sdpa(*(torch.from_numpy(x) for x in (q, k, v)), **tkw)
    _close(got, want, 1e-5)


def test_non_glu_mlp_runs_the_planned_pair_as_the_reference():
    from repro.kernels import planned as jax_planned
    from repro_torch.kernels import planned

    rng = np.random.default_rng(2)
    d, ff = CFG.d_model, CFG.d_ff
    p = {"wu": rng.standard_normal((d, ff)) / 8, "bu": rng.standard_normal(ff),
         "wd": rng.standard_normal((ff, d)) / 11, "bd": rng.standard_normal(d)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    reports = []
    for mod, fn, conv in ((jax_planned, JL.apply_mlp, jnp.asarray),
                          (planned, L.apply_mlp, torch.from_numpy)):
        before = mod.planned_report()
        out = fn({k: conv(v) for k, v in p.items()}, CFG, conv(x))
        reports.append((out, mod.report_delta(before,
                                              mod.planned_report())))
    (want, jrep), (got, rep) = reports
    _close(got, want, 1e-5)
    assert rep["mlp.pair"]["backends"] == {"xla": 1}
    assert rep["mlp.pair"]["last_plan"] == jrep["mlp.pair"]["last_plan"]
    assert set(rep) == set(jrep) == {"mlp.pair"}


def test_model_api_and_seeded_init(params, frames):
    api = build_model(CFG, device="cpu")
    assert api.cfg.family == "encdec"
    # the offline prefill over a batch's precomputed frames serves the
    # reference API's logits and cache
    jparams, tparams = params
    tokens = np.asarray([[0, 2]], np.int32)
    logits, cache = api.prefill(tparams, {
        "tokens": torch.from_numpy(tokens),
        "frames": torch.from_numpy(frames[:1])}, MAX_SEQ)
    jlogits, jcache = jax_build(JCFG).prefill(jparams, {
        "tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames[:1])},
        MAX_SEQ)
    _close(logits, jlogits)
    _close(cache["enc_k"], jcache["enc_k"])
    assert cache["pos"].tolist() == [2]
    ec = api.enc_init(1, 16)
    assert tuple(ec["k"].shape) == (CFG.n_enc_layers, 1, 16,
                                    CFG.n_kv_heads, CFG.hd)
    cache = api.init_cache(2, MAX_SEQ)
    assert set(cache) == {"k", "v", "enc_k", "enc_v", "enc_len", "pos"}
    assert cache["enc_k"].shape[2] == CFG.enc_frames
    # the seeded init draws the reference tree's leaves and shapes
    a = api.init(torch.Generator().manual_seed(0))
    b = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    jtree = jax.eval_shape(lambda: jax_build(JCFG).init(
        jax.random.PRNGKey(0)))
    conv = params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jtree), CFG, "cpu")
    flat = {k: v for k, v in _leaves(a)}
    assert {k: tuple(v.shape) for k, v in _leaves(conv)} == \
        {k: tuple(v.shape) for k, v in flat.items()}
    for (k, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y), k


def test_full_width_config_is_the_reference_one():
    from repro.configs import get_config as jax_config

    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(jax_smoke(ARCH))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{prefix}/{i}")
    else:
        yield prefix, tree
