"""The port's signal-processing kernels and audio frontend against the JAX
package's.

On the CPU the FIR and conv2d wrappers run their plain versions
(``ref.py``).  Those are held against ``repro.kernels.ref`` and against the
JAX package's Pallas kernels (interpret mode, through its
``runtime.execute_plan``) on the same numpy operands, in every registry
parity dtype and int32, at the smoke sizes, the whisper-base frontend
shapes and ragged ones: integers bit-exact, float32 within 1e-5 of the
reference oracle (same summation order) and within the registry's atol of
the Pallas kernel (another order).  ``ref.fft2d`` is held to
``jnp.fft.fft2`` within 1e-3, and the fft2d composition over the mm
kernel to ``ref.fft2d`` within the registry's atol 1.0.

The frontend's plans equal the reference's at every site, for the SMOKE
width and whisper-base's full width (plan-only calls).  Its features match
the reference's: float32 within 1e-4 of max|feature|; int16 within
``feature_scale * sum|filt|``, because the two packages' FFTs (XLA and
pocketfft) can round a plane value near a half the other way, and one
plane step moves a feature by at most that much.  Chunked and offline
features are bitwise equal within the port.

The kernels themselves run only on the card: ``tests/test_torch_gpu.py``.
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.mapper import best_plan as jax_best_plan  # noqa: E402
from repro.kernels import planned as jax_planned  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.kernels.runtime import execute_plan as jax_execute  # noqa: E402
from repro.serve import frontend as jax_frontend  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.mapper import best_plan  # noqa: E402
from repro_torch.kernels import (build, conv2d, fft2d, fir, planned,  # noqa: E402
                                 ref, registry, runtime)
from repro_torch.kernels.planned import PLANNED_TARGET  # noqa: E402
from repro_torch.serve import frontend  # noqa: E402

#: whisper-base's frontend geometry (FrontendConfig(d_model=512)) as
#: builder arguments, and ragged shapes that leave partial tiles
FRONTEND = {"fir": (6180, 15), "conv2d": (8, 512, 5, 4)}
RAGGED = {"fir": (1000, 7), "conv2d": (37, 70, 3, 5)}


def _operands(name, args, dtype, seed=0):
    """numpy operands of the reference registry's layout: fir (x, h) with
    len(x) = n + taps - 1, conv2d (img, filt) with img (h+p-1, w+q-1)."""
    rng = np.random.default_rng(seed)
    if name == "fir":
        n, t = args
        shapes = ((n + t - 1,), (t,))
    else:
        h, w, p, q = args
        shapes = ((h + p - 1, w + q - 1), (p, q))
    if dtype == "float32":
        return [rng.standard_normal(s).astype(np.float32) for s in shapes]
    info = np.iinfo(dtype)
    return [rng.integers(info.min, info.max, s, endpoint=True).astype(dtype)
            for s in shapes]


def _cases(dtypes):
    for name in ("fir", "conv2d"):
        spec = jax_registry.get(name)
        for args in (spec.smoke_args, FRONTEND[name], RAGGED[name]):
            for dtype in dtypes(spec):
                yield pytest.param(
                    name, args, dtype,
                    id=f"{name}-{dtype}-{'x'.join(map(str, args))}")


def _check(got, want, dtype, atol):
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).removeprefix("torch.") == jnp.dtype(want.dtype).name
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,args,dtype", list(_cases(
    lambda spec: (*spec.parity_dtypes, "int32"))))
def test_ref_matches_jax_oracle(name, args, dtype):
    """Full-range integers exercise the int32 wraparound."""
    ops = _operands(name, args, dtype)
    want = getattr(jax_ref, name)(*(jnp.asarray(o) for o in ops))
    got = getattr(ref, name)(*(torch.from_numpy(o) for o in ops))
    _check(got, want, dtype, 1e-5)


@pytest.mark.parametrize("name,args,dtype", list(_cases(
    lambda spec: spec.parity_dtypes)))
def test_execute_plan_matches_jax_kernel(name, args, dtype):
    """The port's plan runner (the wrapper's CPU path) against the JAX
    package's Pallas kernel in interpret mode on the same plan."""
    ops = _operands(name, args, dtype, seed=1)
    want = jax_execute(
        jax_best_plan(jax_registry.get(name).builder(*args, dtype),
                      PLANNED_TARGET),
        *(jnp.asarray(o) for o in ops))
    plan = best_plan(registry.get(name).builder(*args, dtype), PLANNED_TARGET)
    assert plan.backend == "pallas"
    got = runtime.execute_plan(plan, *(torch.from_numpy(o) for o in ops))
    _check(got, want, dtype, jax_registry.get(name).atol)


def test_registry_entries_match_the_reference():
    for name in ("fir", "conv2d", "fft2d_stage"):
        port, jax_spec = registry.get(name), jax_registry.get(name)
        for field in ("arity", "grid_loops", "parity_dtypes", "atol",
                      "fusable_with", "n_outputs", "smoke_args",
                      "bench_cases"):
            assert getattr(port, field) == getattr(jax_spec, field), field


def test_ref_fft2d_matches_jnp_fft():
    rng = np.random.default_rng(2)
    re_, im_ = (rng.standard_normal((12, 67)).astype(np.float32)
                for _ in range(2))
    want = jnp.fft.fft2(jnp.asarray(re_) + 1j * jnp.asarray(im_))
    got_re, got_im = ref.fft2d(torch.from_numpy(re_), torch.from_numpy(im_))
    assert got_re.dtype == got_im.dtype == torch.float32
    np.testing.assert_allclose(got_re.numpy(), np.real(want), atol=1e-3)
    np.testing.assert_allclose(got_im.numpy(), np.imag(want), atol=1e-3)


@pytest.mark.parametrize("shape", [(64, 64), (12, 515), (12, 67), (7, 130)])
def test_fft2d_composition_matches_ref(shape):
    """Six mm launches on the card; on the CPU the same
    composition over ``ref.mm``, held to ``ref.fft2d`` at the registry's
    atol."""
    rng = np.random.default_rng(3)
    re_, im_ = (torch.from_numpy(rng.standard_normal(shape)
                                 .astype(np.float32)) for _ in range(2))
    before = fft2d.launches
    got = fft2d.fft2d(re_, im_, tiles=(16, 32, 32))
    want = ref.fft2d(re_, im_)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=registry.get("fft2d_stage").atol)
    assert fft2d.launches == before


def test_dft_matrix_matches_the_reference():
    from repro.kernels.fft2d import dft_matrix as jax_dft

    for n in (12, 67):
        for got, want in zip(fft2d.dft_matrix(n), jax_dft(n)):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _frontend_requests(d_model):
    for dtype in ("int16", "float32"):
        yield from frontend.FrontendConfig(d_model=d_model,
                                           dtype=dtype).plan_keys()


def _mlp_pair_requests(cfg, slots=4):
    # encoder chunk (8 frames), a 1-token decoder prompt, a decode step
    for m in (8, 1, slots):
        yield ("mm+mm", ((m, cfg.d_ff, cfg.d_model),
                         (m, cfg.d_model, cfg.d_ff)), cfg.dtype)


PLAN_REQUESTS = [
    *_frontend_requests(64), *_frontend_requests(512),
    *_mlp_pair_requests(get_smoke_config("whisper-base")),
    *_mlp_pair_requests(get_config("whisper-base")),
]


def _same_plan(port, want):
    assert port.feasible == want.feasible
    assert port.partition.block == want.partition.block
    assert port.backend == want.backend
    assert port.describe() == want.describe()


@pytest.mark.parametrize("kind,shape,dtype", PLAN_REQUESTS,
                         ids=[f"{k}{s}-{d}" for k, s, d in PLAN_REQUESTS])
def test_frontend_and_mlp_pair_plans_match_reference(kind, shape, dtype):
    port = planned.plan_for(kind, shape, dtype)
    want = jax_planned.plan_for(kind, shape, dtype)
    assert port is not None and want is not None
    if "+" not in kind:
        assert port.backend == "pallas"
        _same_plan(port, want)
        return
    # a fused chain: same family, interstage, saved bytes and the xla
    # stamp the serving path runs, and the same per-stage plans
    assert port.backend == want.backend == "xla"
    for field in ("family", "interstage", "systolic_ok",
                  "predicted_bytes_saved", "provenance"):
        assert getattr(port, field) == getattr(want, field), field
    assert port.describe() == want.describe()
    assert len(port.stage_plans) == len(want.stage_plans) == 2
    for p, w in zip(port.stage_plans, want.stage_plans):
        _same_plan(p, w)


def test_frontend_plan_blocks_on_whisper_base():
    """The TPU-shaped blocks the serving path records beside the CUDA
    tiles it launches."""
    fir_plan = planned.plan_for("fir", FRONTEND["fir"], "int16")
    conv_plan = planned.plan_for("conv2d", FRONTEND["conv2d"], "int16")
    assert fir_plan.partition.block == {"n": 103, "t": 8}
    assert conv_plan.partition.block == {"h": 8, "w": 64, "p": 5, "q": 4}
    assert runtime.fir_tile(fir_plan, 6180) == runtime.HopperTiles(
        plan=(103,), tile=(256,))
    assert runtime.conv2d_tile(conv_plan, 8, 512) == runtime.HopperTiles(
        plan=(8, 64), tile=(4, 64))


@pytest.mark.parametrize("n_out,tile", [(6180, 256), (1000, 256),
                                        (1048576, 1024)])
def test_fir_tile_keeps_every_sm_busy(n_out, tile):
    plan = planned.plan_for("fir", (n_out, 15), "float32")
    assert runtime.fir_tile(plan, n_out).tile == (tile,)


@pytest.mark.parametrize("oh,ow,tile", [(8, 512, (4, 64)),
                                        (10240, 10240, (16, 64))])
def test_conv2d_tile_keeps_every_sm_busy(oh, ow, tile):
    plan = planned.plan_for("conv2d", (oh, ow, 4, 4), "float32")
    assert runtime.conv2d_tile(plan, oh, ow).tile == tile


def test_compiled_tiles_match_the_cuda_source():
    """build.FIR_TILES / CONV2D_TILES list exactly what the source
    compiles (256 threads; 1 or 4 outputs a thread)."""
    src = build.SP_SOURCE.read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    cols = int(re.search(r"kConvCols = (\d+);", src).group(1))
    fir_body = src[src.index("int launch_fir("):]
    fir_body = fir_body[:fir_body.index("\n}\n")]
    per = [int(x) for x in re.findall(r"fir_tile<TIn, TOut, (\d+)>",
                                      fir_body)]
    assert tuple(threads * p for p in per) == build.FIR_TILES
    conv_body = src[src.index("int launch_conv2d("):]
    conv_body = conv_body[:conv_body.index("\n}\n")]
    rows = [int(x) for x in re.findall(r"conv2d_tile<TIn, TOut, (\d+)>",
                                       conv_body)]
    assert tuple((threads // cols * r, cols) for r in rows) == \
        build.CONV2D_TILES


# ---------------------------------------------------------------------------
# the frontend
# ---------------------------------------------------------------------------

def _frontends(d_model, dtype):
    jfc = jax_frontend.FrontendConfig(d_model=d_model, dtype=dtype)
    fc = frontend.FrontendConfig(d_model=d_model, dtype=dtype)
    assert dataclasses.asdict(fc) == dataclasses.asdict(jfc)
    assert fc.chunk_samples == jfc.chunk_samples
    return jax_frontend.AudioFrontend(jfc), frontend.AudioFrontend(fc, "cpu")


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_bank_and_audio_match_the_reference(dtype):
    jfe, fe = _frontends(64, dtype)
    np.testing.assert_array_equal(fe.taps.numpy(), np.asarray(jfe.taps))
    np.testing.assert_array_equal(fe.filt.numpy(), np.asarray(jfe.filt))
    for seed in (0, 7):
        np.testing.assert_array_equal(
            frontend.synth_samples(fe.cfg, 3, seed=seed),
            jax_frontend.synth_samples(jfe.cfg, 3, seed=seed))


@pytest.mark.parametrize("d_model", [64, 512])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_features_match_the_reference(d_model, dtype):
    jfe, fe = _frontends(d_model, dtype)
    samples = frontend.synth_samples(fe.cfg, 3, seed=5)
    want = np.asarray(jfe.offline_features(samples))
    got = fe.offline_features(samples)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (24, d_model)
    diff = np.abs(got.numpy() - want)
    if dtype == "float32":
        assert diff.max() <= 1e-4 * np.abs(want).max()
    else:
        bound = fe.cfg.feature_scale * np.abs(fe.filt.numpy()).sum()
        assert diff.max() <= bound
    # chunk by chunk, with the carry threaded through
    carry, jcarry = fe.init_state(), jfe.init_state()
    for chunk in fe.split(samples):
        carry, f = fe.chunk_features(carry, chunk)
        jcarry, jf = jfe.chunk_features(jcarry, chunk)
        np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))
        assert np.abs(f.numpy() - np.asarray(jf)).max() <= diff.max()


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_chunked_features_bitwise_equal_offline(dtype):
    _, fe = _frontends(64, dtype)
    samples = frontend.synth_samples(fe.cfg, 4, seed=5)
    carry, chunks = fe.init_state(), []
    for chunk in fe.split(samples):
        carry, f = fe.chunk_features(carry, chunk)
        chunks.append(f)
    assert torch.equal(torch.cat(chunks), fe.offline_features(samples))


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_frontend_sites_plan_as_the_reference(dtype):
    jfe, fe = _frontends(64, dtype)
    samples = frontend.synth_samples(fe.cfg, 2, seed=1)
    deltas = []
    for mod, fe_ in ((jax_planned, jfe), (planned, fe)):
        before = mod.planned_report()
        fe_.offline_features(samples)
        deltas.append(mod.report_delta(before, mod.planned_report()))
    jax_delta, delta = deltas
    for site, backend in (("frontend.fir", "pallas"),
                          ("frontend.fft2d", "xla"),
                          ("frontend.conv2d", "pallas")):
        st = delta[site]
        assert st["fallback"] == 0 and st["planned"] == 2
        assert st["backends"] == {backend: 2}
        assert st["last_shape"] == jax_delta[site]["last_shape"]
        assert st["last_plan"] == jax_delta[site]["last_plan"]


def test_chunk_contract_rejections_match_the_reference():
    jfe, fe = _frontends(64, "int16")
    bad = [np.zeros(fe.cfg.chunk_samples + 1, np.int16),
           np.zeros(0, np.int16), np.zeros((2, fe.cfg.chunk_samples),
                                           np.int16)]
    for samples in bad:
        with pytest.raises(ValueError) as want:
            jfe.split(samples)
        with pytest.raises(ValueError) as got:
            fe.split(samples)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="exactly"):
        fe.chunk_features(fe.init_state(), np.zeros(7, np.int16))
    with pytest.raises(TypeError, match="frontend dtype"):
        fe.chunk_features(fe.init_state(),
                          np.zeros(fe.cfg.chunk_samples, np.float32))
    with pytest.raises(ValueError, match="int16"):
        frontend.FrontendConfig(d_model=64, dtype="int8")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def test_cpu_wrappers_run_the_plain_version_and_count_no_launch():
    before = (fir.launches, conv2d.launches)
    x, h = torch.randn(100), torch.randn(7)
    img, filt = torch.randn(20, 30), torch.randn(3, 4)
    torch.testing.assert_close(fir.fir(x, h, tiles=(256,)), ref.fir(x, h))
    torch.testing.assert_close(conv2d.conv2d(img, filt, tiles=(4, 64)),
                               ref.conv2d(img, filt))
    assert (fir.launches, conv2d.launches) == before


def test_wrappers_raise_off_the_cpu_instead_of_falling_back():
    x = torch.empty(100, device="meta")
    h = torch.empty(7, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fir.fir(x, h, tiles=(256,))
    with pytest.raises(ValueError, match="CUDA"):
        conv2d.conv2d(x.reshape(10, 10), h[:4].reshape(2, 2), tiles=(4, 64))


def test_planned_frontend_raises_on_the_card_without_a_plan():
    """A card tensor with a dtype the planner refuses raises instead of
    running the plain version."""
    x = torch.empty(100, dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="frontend.fir"):
        planned.planned_fir(x, x[:7])
    img = torch.empty((10, 10), dtype=torch.float64, device="meta")
    with pytest.raises(RuntimeError, match="frontend.conv2d"):
        planned.planned_conv2d(img, img[:2, :2])
