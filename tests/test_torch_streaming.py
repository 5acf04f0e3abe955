"""The port's slot engine serves streamed audio as the reference engine
does (whisper-base, SMOKE width).

The same int16 audio streams (``synth_samples`` from numpy) go through
the JAX ``ServeEngine`` and the port's engine on the same parameters.
Both run with float32 caches: a bf16 cache can round one value the other
way in one package and move a logit by ~1e-3, which may flip a greedy
token.  Greedy tokens must be identical, and identical again between 1
and 2 slots; each lane's encoder K/V must equal the port's own
whole-utterance comparator (``prefill_streaming``) bitwise, since the two
run the same per-chunk functions.  The rejections of the shared request
surface match the reference's message for message.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core.autotune import PlanPolicy as JaxPolicy  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import planned  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.serve import make_engine, synth_samples  # noqa: E402

ARCH = "whisper-base"
CFG = dataclasses.replace(get_smoke_config(ARCH), kv_cache_dtype="float32")
JCFG = dataclasses.replace(jax_smoke(ARCH), kv_cache_dtype="float32")
MAX_SEQ = 48
#: (chunks, new tokens) per request: 1-4 chunks of 8 frames each
STREAMS = ((4, 6), (1, 3), (3, 7), (2, 1))


@pytest.fixture(scope="module")
def params():
    jparams = jax_build(JCFG).init(jax.random.PRNGKey(42))
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), CFG,
                                    "cpu")


def _engine(tparams, slots):
    eng = make_engine(CFG, kind="slot", max_slots=slots, max_seq=MAX_SEQ,
                      device="cpu")
    eng.load(tparams)
    return eng


def _submit(eng):
    for i, (n_chunks, budget) in enumerate(STREAMS):
        eng.submit_audio_stream(synth_samples(eng.frontend.cfg, n_chunks,
                                              seed=i),
                                max_new_tokens=budget)


@pytest.fixture(scope="module")
def served(params):
    jparams, tparams = params
    jeng = jax_make_engine(JCFG, kind="slot", max_slots=2, max_seq=MAX_SEQ,
                           policy=JaxPolicy(mode="modelled"))
    jeng.load(jparams)
    _submit(jeng)
    want = {r.rid: list(r.output) for r in jeng.run_until_drained()}

    engines, got = {}, {}
    for slots in (1, 2):
        eng = _engine(tparams, slots)
        _submit(eng)
        done = eng.run_until_drained()
        got[slots] = {r.rid: list(r.output) for r in done}
        engines[slots] = (eng, {r.rid: r for r in done})
    return want, got, engines


def test_streamed_greedy_tokens_equal_reference_engine(served):
    want, got, _ = served
    assert got[2] == want
    assert [len(want[i]) for i in range(len(STREAMS))] == \
        [budget for _, budget in STREAMS]


def test_streamed_outputs_identical_for_1_and_2_slots(served):
    _, got, _ = served
    assert got[1] == got[2]


def test_every_chunk_is_fed_and_every_lane_freed(served):
    _, _, engines = served
    for eng, done in engines.values():
        assert eng.queue == [] and all(s is None for s in eng.slots)
        assert eng._streams == {}
        for rid, (n_chunks, budget) in enumerate(STREAMS):
            # a lane feeds one chunk per step, so a short budget ends
            # the request before its last chunks arrive
            assert done[rid].fed == min(n_chunks, budget)


def test_lane_encoder_state_equals_the_offline_comparator(params):
    """One 4-chunk stream with a long budget: the lane's encoder K/V equal
    the whole-utterance ``prefill_streaming`` bitwise."""
    _, tparams = params
    eng = _engine(tparams, 1)
    samples = synth_samples(eng.frontend.cfg, 4, seed=3)
    rid = eng.submit_audio_stream(samples, max_new_tokens=8)
    done = {r.rid: r for r in eng.run_until_drained()}
    assert done[rid].fed == 4 and len(done[rid].output) == 8
    feats = eng.frontend.offline_features(samples)[None]
    _, cache, _ = E.prefill_streaming(
        tparams, CFG, feats, torch.zeros((1, 1), dtype=torch.int32), MAX_SEQ,
        eng.frontend.cfg.frames_per_chunk, cache_dtype=torch.float32)
    assert torch.equal(eng.cache["enc_k"][:, 0], cache["enc_k"][:, 0])
    assert torch.equal(eng.cache["enc_v"][:, 0], cache["enc_v"][:, 0])
    assert eng.cache["enc_len"][0].item() == 4 * 8


def test_decode_starts_before_the_utterance_ends(params):
    _, tparams = params
    eng = _engine(tparams, 2)
    rid = eng.submit_audio_stream(synth_samples(eng.frontend.cfg, 4, seed=1),
                                  max_new_tokens=8)
    eng.step()
    req = eng.slots[0]
    assert req is not None and req.rid == rid
    assert len(req.output) == 2      # prefill token + one decode token
    assert req.fed == 2 < 4          # admission chunk + one fed chunk
    assert eng.cache["enc_len"][0].item() == 2 * 8


def test_streaming_sites_all_plan(params):
    _, tparams = params
    eng = _engine(tparams, 2)
    _submit(eng)
    before = planned.planned_report()
    eng.run_until_drained()
    delta = planned.report_delta(before, planned.planned_report())
    for site, backend in (("frontend.fir", "pallas"),
                          ("frontend.fft2d", "xla"),
                          ("frontend.conv2d", "pallas"),
                          ("mlp.pair", "xla"), ("xattn.k", "pallas"),
                          ("lm_head", "pallas")):
        assert delta[site]["planned"] > 0 and delta[site]["fallback"] == 0
        assert set(delta[site]["backends"]) == {backend}, site
    n_fed = sum(min(c, b) for c, b in STREAMS)
    assert delta["frontend.fir"]["planned"] == n_fed


def _rejections(eng):
    fc = eng.frontend.cfg
    too_long = synth_samples(fc, eng.cfg.enc_frames
                             // fc.frames_per_chunk + 1, seed=0)
    return [
        lambda: eng.submit_audio_stream(np.zeros(7, np.int16)),
        lambda: eng.submit_audio_stream(np.zeros(0, np.int16)),
        lambda: eng.submit_audio_stream(too_long),
        lambda: eng.submit_audio_stream(synth_samples(fc, 1, seed=0),
                                        max_new_tokens=-1),
        lambda: eng.submit_audio_stream(synth_samples(fc, 1, seed=0),
                                        max_new_tokens=MAX_SEQ),
        lambda: eng.submit(np.arange(3), max_new_tokens=0),
    ]


def test_stream_rejections_match_the_reference(params):
    jparams, tparams = params
    jeng = jax_make_engine(JCFG, kind="slot", max_slots=1, max_seq=MAX_SEQ)
    eng = _engine(tparams, 1)
    for jbad, bad in zip(_rejections(jeng), _rejections(eng)):
        with pytest.raises(ValueError) as want:
            jbad()
        with pytest.raises(ValueError) as got:
            bad()
        assert str(got.value) == str(want.value)
    assert eng.queue == []


def test_audio_submit_rejected_for_non_encdec_as_the_reference():
    from repro.configs import get_smoke_config as jax_cfg

    jeng = jax_make_engine(jax_cfg("qwen1.5-0.5b"), kind="slot",
                           max_slots=1, max_seq=32)
    eng = make_engine(get_smoke_config("qwen1.5-0.5b"), kind="slot",
                      max_slots=1, max_seq=32, device="cpu")
    assert eng.frontend is None
    with pytest.raises(ValueError) as want:
        jeng.submit_audio_stream(np.zeros(804, np.int16))
    with pytest.raises(ValueError) as got:
        eng.submit_audio_stream(np.zeros(804, np.int16))
    assert str(got.value) == str(want.value)


def _text_with_frames(eng):
    """Text requests, each with its own precomputed frames
    [enc_frames, d] (numpy, seeded), beside one audio stream."""
    rng = np.random.default_rng(7)
    rids = []
    for i, budget in enumerate((5, 1, 7)):
        frames = rng.standard_normal(
            (CFG.enc_frames, CFG.d_model)).astype(np.float32)
        rids.append(eng.submit(rng.integers(0, CFG.vocab, 3 + i),
                               max_new_tokens=budget,
                               extra={"frames": frames}))
    eng.submit_audio_stream(synth_samples(eng.frontend.cfg, 2, seed=9),
                            max_new_tokens=4)
    return rids


def test_text_with_frames_is_refused_until_offline_prefill_is_ported(params):
    """The offline prefill is ported: a text ``submit`` with
    ``extra={"frames": ...}`` is served, with the reference slot engine's
    greedy tokens, beside a streamed request; each request keeps its
    frames on its ``Request``."""
    jparams, tparams = params
    jeng = jax_make_engine(JCFG, kind="slot", max_slots=2, max_seq=MAX_SEQ,
                           policy=JaxPolicy(mode="modelled"))
    jeng.load(jparams)
    _text_with_frames(jeng)
    want = {r.rid: list(r.output) for r in jeng.run_until_drained()}
    eng = _engine(tparams, 2)
    rids = _text_with_frames(eng)
    done = {r.rid: r for r in eng.run_until_drained()}
    assert {rid: list(r.output) for rid, r in done.items()} == want
    assert [len(done[rid].output) for rid in rids] == [5, 1, 7]
    assert all(done[rid].extra["frames"].shape ==
               (CFG.enc_frames, CFG.d_model) for rid in rids)


def test_launch_cli_streams_audio(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--stream-audio", "--device", "cpu",
          "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out
    assert ("planned frontend stages: ['frontend.conv2d', "
            "'frontend.fft2d', 'frontend.fir']") in out
    with pytest.raises(SystemExit, match="encdec"):
        main(["--arch", "qwen1.5-0.5b", "--stream-audio", "--device", "cpu",
              "--requests", "1"])


def test_launch_cli_serves_text_with_frames(capsys):
    """Without ``--stream-audio`` whisper-base serves text requests that
    carry precomputed frames, on both engines; the frames are the
    reference CLI's draws, rounded to bf16 bit for bit as it rounds
    them."""
    from repro_torch.launch.serve import bf16_frames, main

    for engine in ("slot", "paged"):
        main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
              "--max-new", "3", "--engine", engine])
        assert "served 3 requests / 9 tokens" in capsys.readouterr().out
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(2):
        got = bf16_frames(rng, CFG)
        want = np.asarray(jax.numpy.asarray(
            jrng.standard_normal((CFG.enc_frames, CFG.d_model)),
            jax.numpy.bfloat16))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
