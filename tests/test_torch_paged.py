"""The port's block-paged engine serves the reference's greedy tokens.

The same numpy prompts go through the JAX ``PagedServeEngine`` and the
port's (``device="cpu"``: the plain versions) on the same parameters
(smoke configs, ``PRNGKey(42)`` through ``convert.params_from_jax``).
Greedy tokens must be **equal**: across the two packages, between the
port's paged and slot engines (the gather yields ``max_seq`` rows, the
slot cache's count, so every GEMM runs at the slot shapes), and between
bucketed and exact prefills.  The assertions of
``tests/test_paged_serving.py`` and of the paged half of
``tests/test_streaming.py`` are carried over: the allocator and
scheduler, the fp8 cache, the dtype and horizon guards, one decode
capture through join, evict and preemption, no replanning in steady
state, text-before-audio preemption (text lanes with precomputed frames,
prefilled offline).  The port's own contracts are held
too: the sink block takes an inactive lane's write and never reaches the
allocator, and the pools are written in place and never replaced.

whisper-base runs with float32 caches, as ``test_torch_streaming.py``
does (a bf16 cache can round a value the other way in one package and
flip a greedy token).  Encoder state is held to the reference at fp32
tolerance, never bitwise (ROADMAP C1).
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
from repro.models import encdec as JE  # noqa: E402
from repro.serve import PagedServeEngine as JaxPaged  # noqa: E402
from repro.serve import Scheduler as JaxScheduler  # noqa: E402
from repro.serve import SchedulerConfig as JaxSchedulerConfig  # noqa: E402
from repro.serve import make_engine as jax_make_engine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch.core.mapper import plan_cache_info  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serve import (BlockAllocator, PagedServeEngine,  # noqa: E402
                               Scheduler, SchedulerConfig, make_engine,
                               synth_samples)

ARCH = "qwen1.5-0.5b"
STREAM_ARCH = "whisper-base"
JPOLICY = JaxPolicy(mode="modelled")


def _cfgs(arch, kv_dtype=None):
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_dtype)
    return cfg, jcfg


_PARAMS: dict = {}


def _params(arch=ARCH, kv_dtype=None):
    """(port cfg, reference cfg, port params, reference params)."""
    key = (arch, kv_dtype)
    if key not in _PARAMS:
        cfg, jcfg = _cfgs(arch, kv_dtype)
        jparams = jax_build(jcfg).init(jax.random.PRNGKey(42))
        _PARAMS[key] = (cfg, jcfg, params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg, "cpu"), jparams)
    return _PARAMS[key]


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


def _drain(eng, prompts, max_new=5):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    return {r.rid: list(r.output) for r in eng.run_until_drained(4000)}


def _paged(cfg, params, **kw):
    eng = make_engine(cfg, kind="paged", device="cpu", **kw)
    eng.load(params)
    return eng


def _slot(cfg, params, **kw):
    eng = make_engine(cfg, kind="slot", device="cpu", **kw)
    eng.load(params)
    return eng


def _jax_paged(jcfg, jparams, **kw):
    eng = JaxPaged(jcfg, policy=JPOLICY, **kw)
    eng.load(jparams)
    return eng


# ---------------------------------------------------------------------------
# allocator / scheduler units
# ---------------------------------------------------------------------------

def test_block_allocator_alloc_release_exhaustion():
    a = BlockAllocator(4)
    b1 = a.alloc(3)
    assert a.free == 1 and len(b1) == 3
    with pytest.raises(MemoryError, match="exhausted"):
        a.alloc(2)
    a.release(b1[:2])
    assert a.free == 3
    assert len(a.alloc(3)) == 3 and a.free == 0


def test_scheduler_buckets_and_exact_mode():
    s = Scheduler()
    assert s.bucket_for(5) == 8
    assert s.bucket_for(8) == 8
    assert s.bucket_for(9) == 16
    assert s.bucket_for(1000) == 1000  # past the last bucket: exact
    assert s.bucket_for(5, exact=True) == 5
    assert Scheduler(SchedulerConfig(bucketed=False)).bucket_for(5) == 5


def test_scheduler_admission_budget_and_fcfs():
    s = Scheduler(SchedulerConfig(max_prefills_per_step=2))
    # cold engine: every free lane fills at once
    assert s.plan_admits([1, 1, 1, 1], free_lanes=4, free_blocks=8,
                         n_active=0) == 4
    # in-flight decodes: at most max_prefills_per_step join
    assert s.plan_admits([1, 1, 1], free_lanes=3, free_blocks=8,
                         n_active=1) == 2
    # FCFS stops at the first request that does not fit (no starvation)
    assert s.plan_admits([5, 1], free_lanes=2, free_blocks=4,
                         n_active=0) == 0
    assert s.plan_admits([], free_lanes=2, free_blocks=4, n_active=0) == 0


def test_scheduler_decides_as_the_reference():
    """The copy makes the reference's decision on every input of a grid."""
    assert SchedulerConfig() == SchedulerConfig(
        **dataclasses.asdict(JaxSchedulerConfig()))
    rng = np.random.default_rng(0)
    for cfg in ({}, {"bucketed": False}, {"max_prefills_per_step": 3}):
        s, j = Scheduler(SchedulerConfig(**cfg)), \
            JaxScheduler(JaxSchedulerConfig(**cfg))
        for n in range(1, 600, 7):
            for exact in (False, True):
                assert s.bucket_for(n, exact=exact) == \
                    j.bucket_for(n, exact=exact)
        for _ in range(200):
            needs = rng.integers(1, 6, int(rng.integers(0, 6))).tolist()
            kw = dict(free_lanes=int(rng.integers(0, 5)),
                      free_blocks=int(rng.integers(0, 12)),
                      n_active=int(rng.integers(0, 3)))
            assert s.plan_admits(needs, **kw) == j.plan_admits(needs, **kw)


def test_paged_cache_rejects_unaligned_horizon():
    cfg, _, params, _ = _params()
    with pytest.raises(ValueError, match="multiple"):
        _paged(cfg, params, max_lanes=1, max_seq=30, block_size=8)


# ---------------------------------------------------------------------------
# paged == slot == reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", [1, 4])
def test_paged_matches_slot_and_the_reference(lanes):
    cfg, jcfg, params, jparams = _params()
    prompts = _prompts(cfg, [5, 9, 13, 4, 17, 7], seed=3)
    slot = _drain(_slot(cfg, params, max_slots=lanes, max_seq=64), prompts)
    got = _drain(_paged(cfg, params, max_lanes=lanes, max_seq=64,
                        block_size=8), prompts)
    want = _drain(_jax_paged(jcfg, jparams, max_lanes=lanes, max_seq=64,
                             block_size=8), prompts)
    assert got == slot
    assert got == want


def test_bucketed_prefill_is_output_transparent():
    """Bucket pad tokens must be invisible: same outputs as exact-length
    prefill (the masked-attention guarantee the scheduler relies on)."""
    cfg, _, params, _ = _params()
    prompts = _prompts(cfg, [5, 9, 13], seed=5)
    exact_eng = _paged(cfg, params, max_lanes=2, max_seq=64, block_size=8,
                       scheduler=Scheduler(SchedulerConfig(bucketed=False)))
    exact = _drain(exact_eng, prompts)
    bucketed_eng = _paged(cfg, params, max_lanes=2, max_seq=64,
                          block_size=8)
    bucketed = _drain(bucketed_eng, prompts)
    assert exact == bucketed
    # three prompt lengths, one shape each exact; buckets 8 and 16
    assert exact_eng.stats["prefill_compiles"] == 3
    assert bucketed_eng.stats["prefill_compiles"] == 2


def test_fp8_cache_roundtrips_through_paged_pools():
    cfg, jcfg, params, jparams = _params(kv_dtype="float8_e4m3fn")
    prompts = _prompts(cfg, [5, 9, 7], seed=2)
    slot = _drain(_slot(cfg, params, max_slots=2, max_seq=64), prompts)
    eng = _paged(cfg, params, max_lanes=2, max_seq=64, block_size=8)
    assert eng.kv.pools["k"].dtype == torch.float8_e4m3fn
    got = _drain(eng, prompts)
    want = _drain(_jax_paged(jcfg, jparams, max_lanes=2, max_seq=64,
                             block_size=8), prompts)
    assert got == slot
    assert got == want


def test_write_prefill_rejects_mismatched_dtype():
    cfg, _, params, _ = _params()
    eng = _paged(cfg, params, max_lanes=2, max_seq=32, block_size=8)
    tokens = torch.as_tensor(_prompts(cfg, [8])[0][None])
    _, pc = eng.api.prefill(eng.params, {"tokens": tokens}, 8,
                            last_index=torch.tensor([7], dtype=torch.int32))
    bad = {k: (v.to(torch.float16) if v.is_floating_point() else v)
           for k, v in pc.items()}
    eng.kv.install_lane(0, eng.kv.allocator.alloc(1), 8)
    with pytest.raises(TypeError, match="dtype"):
        eng.kv.write_prefill(0, bad)


# ---------------------------------------------------------------------------
# the model functions against the reference's
# ---------------------------------------------------------------------------

def test_bucketed_prefill_logits_match_the_reference():
    """``prefill(..., last_index)`` on a right-padded prompt: logits at the
    last real token and ``pos`` past it, as the reference's."""
    cfg, jcfg, params, jparams = _params()
    prompt = _prompts(cfg, [11], seed=9)[0]
    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :11] = prompt
    li = np.asarray([10], np.int32)
    api, japi = make_engine(cfg, kind="paged", device="cpu").api, \
        jax_build(jcfg)
    got, cache = api.prefill(params, {"tokens": torch.as_tensor(tokens)}, 16,
                             last_index=torch.as_tensor(li))
    want, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(tokens)}, 16,
                                last_index=jnp.asarray(li))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist() == [11]
    exact, _ = api.prefill(params, {"tokens": torch.as_tensor(
        prompt[None])}, 16)
    assert int(got.argmax()) == int(exact.argmax())


def test_decode_step_paged_matches_the_reference():
    """One paged decode step on the same pools, tables, pos and active
    mask (one lane inactive): logits within fp32 tolerance, every live
    block written as the reference writes it, and the inactive lane's
    row only in the sink."""
    cfg, jcfg, params, jparams = _params(kv_dtype="float32")
    nb, bs, lanes = 6, 4, 3
    rng = np.random.default_rng(1)
    shape = (cfg.n_layers, nb, bs, cfg.n_kv_heads, cfg.hd)
    pool_k = rng.standard_normal(shape).astype(np.float32)
    pool_v = rng.standard_normal(shape).astype(np.float32)
    tables = np.asarray([[2, 0], [4, 1], [3, 5]], np.int32)
    pos = np.asarray([5, 2, 6], np.int32)
    active = np.asarray([True, True, False])
    tokens = rng.integers(0, cfg.vocab, (lanes, 1)).astype(np.int32)

    api = make_engine(cfg, kind="paged", device="cpu").api
    pools = api.paged_init(nb + 1, bs, lanes)  # + the sink block
    pools["k"][:, :nb] = torch.as_tensor(pool_k)
    pools["v"][:, :nb] = torch.as_tensor(pool_v)
    got, out = api.paged_decode(params, pools, torch.as_tensor(tokens),
                                torch.as_tensor(tables),
                                torch.as_tensor(pos),
                                torch.as_tensor(active))
    want, jpools = jax_build(jcfg).paged_decode(
        jparams, {"k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)},
        jnp.asarray(tokens), jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(active))
    assert out is pools
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(pools[name][:, :nb].numpy(),
                                   np.asarray(jpools[name]), atol=1e-5)
    # lane 2 is inactive: its row went to the sink, pos 6 % 4 = 2
    assert pools["k"][:, nb, 2].abs().sum() > 0
    assert pools["k"][:, nb].abs().sum() == pools["k"][:, nb, 2].abs().sum()


def test_inactive_lane_write_lands_in_the_sink_only():
    """An inactive lane whose stale table row points at another lane's
    live block writes its row to the sink; every live row is unchanged
    (the reference drops the write; ``paged_write`` cannot index out of
    range)."""
    nb, bs = 4, 2
    pool = torch.arange((nb + 1) * bs * 3, dtype=torch.float32).view(
        nb + 1, bs, 3)
    before = pool.clone()
    tables = torch.tensor([[1, 2], [1, 2]], dtype=torch.int32)
    pos = torch.tensor([3, 3], dtype=torch.int32)
    new = torch.full((2, 3), -7.0)
    L.paged_write(pool, new, tables, pos, torch.tensor([False, False]))
    assert torch.equal(pool[:nb], before[:nb])
    assert torch.equal(pool[nb, 1], new[0])
    L.paged_write(pool, new[:1] * 2, tables[:1], pos[:1],
                  torch.tensor([True]))
    assert torch.equal(pool[2, 1], new[0] * 2)  # block 2, row 3 % 2
    changed = (pool[:nb] != before[:nb]).any(dim=-1).nonzero().tolist()
    assert changed == [[2, 1]]


def test_sink_block_never_reaches_the_allocator():
    cfg, _, params, _ = _params()
    eng = _paged(cfg, params, max_lanes=4, max_seq=64, block_size=8,
                 num_blocks=14)
    assert eng.kv.pools["k"].shape[1] == 15  # 14 blocks + the sink
    handed = set()
    real_alloc = eng.kv.allocator.alloc

    def alloc(n):
        out = real_alloc(n)
        handed.update(out)
        return out

    eng.kv.allocator.alloc = alloc
    _drain(eng, _prompts(cfg, [20, 20, 20, 20], seed=4), max_new=20)
    assert eng.stats["preemptions"] > 0
    assert handed and max(handed) < 14 and 14 not in handed


def test_pools_are_written_in_place_and_never_replaced():
    cfg, _, params, _ = _params()
    eng = _paged(cfg, params, max_lanes=2, max_seq=32, block_size=8)
    ptrs = {k: v.data_ptr() for k, v in eng.kv.pools.items()}
    objs = dict(eng.kv.pools)
    with pytest.raises(AttributeError, match="in place"):
        eng.kv.pools = dict(eng.kv.pools)
    with pytest.raises(TypeError):
        eng.kv.pools["k"] = torch.zeros(1)
    _drain(eng, _prompts(cfg, [6, 9, 5], seed=8), max_new=4)
    assert {k: v.data_ptr() for k, v in eng.kv.pools.items()} == ptrs
    assert all(eng.kv.pools[k] is objs[k] for k in objs)


def test_paged_pools_match_the_reference_after_a_drain():
    """The same traffic leaves the same blocks in both packages' pools
    (the sink sliced off; fp32 tolerance)."""
    cfg, jcfg, params, jparams = _params(kv_dtype="float32")
    prompts = _prompts(cfg, [5, 9, 13], seed=6)
    eng = _paged(cfg, params, max_lanes=2, max_seq=32, block_size=8)
    jeng = _jax_paged(jcfg, jparams, max_lanes=2, max_seq=32, block_size=8)
    assert _drain(eng, prompts, 4) == _drain(jeng, prompts, 4)
    for name in ("k", "v"):
        got = eng.kv.pools[name][:, :eng.num_blocks].numpy()
        np.testing.assert_allclose(got, np.asarray(jeng.kv.pools[name]),
                                   atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# one decode capture; no replanning
# ---------------------------------------------------------------------------

def test_join_evict_mid_flight_never_recaptures_decode():
    """Requests joining and finishing mid-flight edit host tables only:
    the decode step is built once in load() and the very same object
    serves every step."""
    cfg, _, params, _ = _params()
    eng = _paged(cfg, params, max_lanes=4, max_seq=64, block_size=8)
    assert eng.stats["decode_compiles"] == 1
    exec_id = id(eng._decode_exec)
    prompts = _prompts(cfg, [6, 11, 6, 6, 9, 6], seed=7)
    for p in prompts[:3]:
        eng.submit(p, max_new_tokens=6)
    for _ in range(4):          # some finish, lanes evict
        eng.step()
    for p in prompts[3:]:       # late joins into freed lanes
        eng.submit(p, max_new_tokens=4)
    done = eng.run_until_drained(1000)
    assert len(done) == 6
    assert eng.stats["decode_compiles"] == 1
    assert id(eng._decode_exec) == exec_id


def test_steady_state_zero_plan_cache_misses():
    """After the first drain warms every bucket, repeat traffic must hit
    the plan cache on every lookup and never measure."""
    cfg, _, params, _ = _params()
    eng = _paged(cfg, params, max_lanes=2, max_seq=64, block_size=8)
    assert eng.autotune_report["measure_calls"] == 0
    _drain(eng, _prompts(cfg, [5, 9], seed=1), max_new=3)
    misses = plan_cache_info().misses
    measures = autotune.counters()["measure_calls"]
    prefills = eng.stats["prefill_compiles"]
    _drain(eng, _prompts(cfg, [6, 12], seed=2), max_new=3)  # same buckets
    assert plan_cache_info().misses == misses
    assert autotune.counters()["measure_calls"] == measures
    assert eng.stats["prefill_compiles"] == prefills


def test_load_reports_the_capture_window():
    cfg, _, params, _ = _params()
    eng = _paged(cfg, params, max_lanes=2, max_seq=32, block_size=8,
                 prompt_len=5)
    assert {"attn.paged_scores", "attn.paged_values", "lm_head",
            "mlp.down", "attn.scores"} <= set(eng.plan_report)
    assert all(st["fallback"] == 0 for st in eng.plan_report.values())
    assert eng.autotune_report["measure_calls"] == 0
    # the warm prefill ran at its bucket without counting as an admission
    assert eng.stats["prefill_compiles"] == 0


# ---------------------------------------------------------------------------
# block pool pressure: growth, preemption, guard
# ---------------------------------------------------------------------------

def test_preemption_under_block_pressure_preserves_outputs():
    """An oversubscribed pool forces mid-flight evictions; each victim
    re-queues with its generated tokens folded into the prompt and its
    final output is unchanged — the slot engine's, and the reference's
    under the same pressure."""
    cfg, jcfg, params, jparams = _params()
    prompts = _prompts(cfg, [20, 20, 20, 20], seed=4)
    ref = _drain(_slot(cfg, params, max_slots=4, max_seq=64), prompts,
                 max_new=20)
    eng = _paged(cfg, params, max_lanes=4, max_seq=64, block_size=8,
                 num_blocks=14)   # 4 lanes x 40 rows need 20 blocks
    got = _drain(eng, prompts, max_new=20)
    jeng = _jax_paged(jcfg, jparams, max_lanes=4, max_seq=64, block_size=8,
                      num_blocks=14)
    want = _drain(jeng, prompts, max_new=20)
    assert eng.stats["preemptions"] > 0
    assert eng.stats["preemptions"] == jeng.stats["preemptions"]
    assert eng.stats["decode_compiles"] == 1
    assert ref == got == want


def test_guard_refuses_decode_write_past_horizon():
    cfg, _, params, _ = _params()
    eng = _paged(cfg, params, max_lanes=1, max_seq=32, block_size=8)
    eng.submit(_prompts(cfg, [6])[0], max_new_tokens=4)
    eng.step()
    eng.kv.pos[0] = 32          # corrupt: next write would clamp
    with pytest.raises(AssertionError, match="horizon"):
        eng.kv.guard_decode_write()
    eng.kv.pos[0] = 30          # past the lane's allocated blocks
    with pytest.raises(AssertionError, match="blocks"):
        eng.kv.guard_decode_write()


def test_paged_submit_validates_horizon():
    cfg, _, params, _ = _params()
    eng = _paged(cfg, params, max_lanes=1, max_seq=32, block_size=8)
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(_prompts(cfg, [20])[0], max_new_tokens=20)


def test_make_engine_paged_defaults_to_the_card():
    cfg = get_smoke_config(ARCH)
    eng = make_engine(cfg, kind="paged", max_lanes=2, max_seq=32,
                      block_size=8)
    assert isinstance(eng, PagedServeEngine)
    assert eng.device == torch.device("cuda")
    assert eng.stats["decode_compiles"] == 0  # captured in load(), not here


def test_launch_cli_serves_paged(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--engine", "paged", "--device", "cpu",
          "--requests", "3", "--max-new", "3", "--block-size", "8",
          "--num-blocks", "12"])
    out = capsys.readouterr().out
    assert "served 3 requests / 9 tokens" in out
    assert "paged stats: {'decode_compiles': 1," in out


# ---------------------------------------------------------------------------
# whisper-base: streamed audio through the paged engine
# ---------------------------------------------------------------------------

#: (chunks, new tokens) per request: 1-4 chunks of 8 frames each
STREAMS = ((4, 6), (1, 3), (3, 7), (2, 1))


def _stream_engine(jax_side=False, **kw):
    cfg, jcfg, params, jparams = _params(STREAM_ARCH, "float32")
    kw.setdefault("max_lanes", 2)
    kw.setdefault("block_size", 8)
    if jax_side:
        return _jax_paged(jcfg, jparams, max_seq=64, **kw)
    return _paged(cfg, params, max_seq=64, **kw)


def _submit_streams(eng):
    fc = eng.frontend.cfg
    return [eng.submit_audio_stream(synth_samples(fc, n, seed=i),
                                    max_new_tokens=budget)
            for i, (n, budget) in enumerate(STREAMS)]


def test_streamed_audio_paged_tokens_equal_the_reference():
    eng, jeng = _stream_engine(), _stream_engine(jax_side=True)
    outs, fed = [], []
    for e in (eng, jeng):
        _submit_streams(e)
        done = {r.rid: r for r in e.run_until_drained()}
        outs.append({i: list(r.output) for i, r in done.items()})
        fed.append({i: r.fed for i, r in done.items()})
    assert outs[0] == outs[1]
    # every chunk fed, but the one-token request's (done at admission)
    assert fed[0] == fed[1] == {0: 4, 1: 1, 2: 3, 3: 1}
    assert [len(outs[0][i]) for i in range(len(STREAMS))] == \
        [b for _, b in STREAMS]
    slot = make_engine(eng.cfg, kind="slot", max_slots=2, max_seq=64,
                       device="cpu")
    slot.load(eng.params)
    _submit_streams(slot)
    assert {r.rid: list(r.output) for r in slot.run_until_drained()} == \
        outs[0]
    assert eng.stats["decode_compiles"] == 1
    assert eng.kv.pools["enc_len"].tolist() == \
        np.asarray(jeng.kv.pools["enc_len"]).tolist()


def test_streaming_decode_starts_before_utterance_end():
    """After one step, the audio lane has emitted tokens but not yet
    consumed its chunks — decode genuinely overlaps the stream."""
    eng = _stream_engine()
    fc = eng.frontend.cfg
    rid = eng.submit_audio_stream(synth_samples(fc, 4, seed=1),
                                  max_new_tokens=8)
    eng.step()
    req = eng.lanes[0]
    assert req is not None and req.rid == rid
    assert len(req.output) >= 2      # prefill token + 1 decode token
    assert req.fed < 4               # stream still arriving
    eng.run_until_drained()
    assert req.fed == 4 and len(req.output) == 8
    assert eng.stats["decode_compiles"] == 1

    # lane 0's encoder state (it survives release): bitwise the port's
    # own whole-utterance comparator, and the reference's on the same
    # features within fp32 tolerance (C1; the int16 frontend itself is
    # not bit-exact across the packages, so both take the port's)
    cfg, jcfg, params, jparams = _params(STREAM_ARCH, "float32")
    feats = eng.frontend.offline_features(synth_samples(fc, 4, seed=1))
    c = fc.frames_per_chunk
    _, cache, _ = E.prefill_streaming(
        params, cfg, feats[None], torch.zeros((1, 1), dtype=torch.int32),
        64, c, torch.float32)
    _, jcache, _ = JE.prefill_streaming(
        jparams, jcfg, jnp.asarray(feats[None].numpy()),
        jnp.zeros((1, 1), jnp.int32), 64, c, cache_dtype=jnp.float32)
    for name in ("enc_k", "enc_v"):
        lane = eng.kv.pools[name][:, 0]
        assert torch.equal(lane, cache[name][:, 0])
        np.testing.assert_allclose(lane.numpy(),
                                   np.asarray(jcache[name][:, 0]),
                                   rtol=0, atol=1e-4)


def _frames(seed=7):
    """Precomputed frames [enc_frames, d] of one text request."""
    cfg = _params(STREAM_ARCH, "float32")[0]
    return np.random.default_rng(seed).standard_normal(
        (cfg.enc_frames, cfg.d_model)).astype(np.float32)


def test_text_with_frames_paged_tokens_equal_the_reference():
    """Text requests with precomputed frames (the offline prefill) beside
    audio streams on the paged engine: the reference paged engine's
    greedy tokens and prefill count (one per bucket and batch keys), and
    the port's slot engine's tokens."""
    def submit(e):
        rng = np.random.default_rng(3)
        for i, (n, budget) in enumerate(STREAMS):
            e.submit_text(rng.integers(0, 256, 3 + 2 * i), max_new_tokens=5,
                          extra={"frames": _frames(seed=i)})
            e.submit_audio_stream(synth_samples(e.frontend.cfg, n, seed=i),
                                  max_new_tokens=budget)

    outs = []
    for eng in (_stream_engine(), _stream_engine(jax_side=True)):
        submit(eng)
        outs.append({r.rid: list(r.output)
                     for r in eng.run_until_drained()})
        outs.append(eng.stats["prefill_compiles"])
    assert outs[0] == outs[2] and outs[1] == outs[3]
    slot = make_engine(eng.cfg, kind="slot", max_slots=2, max_seq=64,
                       device="cpu")
    slot.load(_params(STREAM_ARCH, "float32")[2])
    submit(slot)
    assert {r.rid: list(r.output) for r in slot.run_until_drained()} == \
        outs[0]


def test_mixed_text_audio_under_preemption_prefers_text_victims():
    """Text with precomputed frames + audio sharing an oversubscribed
    block pool: preemption fires, takes text lanes before the audio
    lane, a preempted text request re-prefills with its frames, and every
    request still finishes with its full budget — with the reference
    engine's tokens under the same pressure; the audio stream's tokens
    equal an unpressured engine's, and the reference's calm stream's."""
    eng = _stream_engine(max_lanes=3, block_size=4, num_blocks=10)
    victims = []
    preempt = eng._preempt

    def spy(lane):
        victims.append(eng.lanes[lane].kind)
        preempt(lane)

    eng._preempt = spy
    fc = eng.frontend.cfg
    samples = synth_samples(fc, 3, seed=2)

    def submit(e):
        rid_a = e.submit_audio_stream(samples, max_new_tokens=10)
        return rid_a, [e.submit_text(np.arange(4) + 1 + i, max_new_tokens=10,
                                     extra={"frames": _frames()})
                       for i in range(2)]

    rid_a, rids_t = submit(eng)
    done = {r.rid: r for r in eng.run_until_drained(max_steps=200)}
    assert eng.stats["preemptions"] > 0, "pool pressure must preempt"
    assert victims and set(victims) == {"text"}
    for rid in (rid_a, *rids_t):
        assert done[rid].done and len(done[rid].output) == 10
    assert done[rid_a].fed == 3
    assert eng.stats["decode_compiles"] == 1
    jeng = _stream_engine(True, max_lanes=3, block_size=4, num_blocks=10)
    submit(jeng)
    jdone = {r.rid: list(r.output) for r in jeng.run_until_drained(200)}
    assert {rid: list(r.output) for rid, r in done.items()} == jdone
    assert jeng.stats["preemptions"] == eng.stats["preemptions"]

    calms = []
    for jax_side in (False, True):
        calm = _stream_engine(jax_side, max_lanes=3)
        rid_c = calm.submit_audio_stream(samples, max_new_tokens=10)
        calm_done = {r.rid: r for r in calm.run_until_drained()}
        assert calm.stats["preemptions"] == 0
        calms.append(list(calm_done[rid_c].output))
    assert list(done[rid_a].output) == calms[0] == calms[1]


def test_streaming_steady_state_no_replanning():
    """A second identical stream on a warm engine: zero plan-cache
    misses, zero autotune traffic, the decode capture untouched."""
    eng = _stream_engine()
    samples = synth_samples(eng.frontend.cfg, 4, seed=4)
    eng.submit_audio_stream(samples, max_new_tokens=6)
    eng.run_until_drained()
    misses = plan_cache_info().misses
    tune0 = autotune.counters()
    stats0 = dict(eng.stats)
    eng.submit_audio_stream(samples, max_new_tokens=6)
    eng.run_until_drained()
    assert plan_cache_info().misses == misses
    tune1 = autotune.counters()
    assert tune1["measure_calls"] == tune0["measure_calls"]
    assert tune1["misses"] == tune0["misses"]
    assert eng.stats["decode_compiles"] == stats0["decode_compiles"] == 1
    assert eng.stats["prefill_compiles"] == stats0["prefill_compiles"]


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_validation_rejections_match_the_reference(kind):
    """Message for message, on both engines of both packages."""
    cfg, jcfg, _, _ = _params(STREAM_ARCH, "float32")
    kw = ({"max_lanes": 2, "block_size": 8} if kind == "paged"
          else {"max_slots": 2})
    eng = make_engine(cfg, kind=kind, max_seq=64, device="cpu", **kw)
    jeng = jax_make_engine(jcfg, kind=kind, max_seq=64, **kw)
    fc = eng.frontend.cfg
    too_long = synth_samples(fc, cfg.enc_frames // fc.frames_per_chunk + 1,
                             seed=0)
    calls = (
        lambda e: e.submit(np.arange(3), max_new_tokens=0),
        lambda e: e.submit(np.arange(60), max_new_tokens=10),
        lambda e: e.submit_audio_stream(np.zeros(7, np.int16)),
        lambda e: e.submit_audio_stream(too_long),
        lambda e: e.submit_audio_stream(synth_samples(fc, 1, seed=0),
                                        max_new_tokens=-1),
    )
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(jeng)
        with pytest.raises(ValueError) as got:
            call(eng)
        assert str(got.value) == str(want.value)
    assert eng.queue == []


def test_encdec_paged_step_reads_the_fill_clock_in_place():
    """A chunk feed writes ``enc_len`` into the very tensor the decode
    step was built over: the closure's pools are the cache's pools."""
    eng = _stream_engine()
    enc_len = eng.kv.pools["enc_len"]
    eng.submit_audio_stream(synth_samples(eng.frontend.cfg, 3, seed=5),
                            max_new_tokens=4)
    eng.step()
    assert eng.kv.pools["enc_len"] is enc_len
    assert enc_len[0] == 2 * eng.frontend.cfg.frames_per_chunk
