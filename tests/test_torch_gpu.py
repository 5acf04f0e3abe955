"""The port's FIR, conv2d and fft2d kernels against their plain versions on
the card.

Every test here is ``gpu``-marked and skips without a CUDA card.  The file
imports only the port (no JAX), so it runs on a machine with a card and
PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Integers are bit-exact (int32 wraparound); float32 within the registry's
atol 1e-3 (FIR, conv2d: sums of at most 20 products in another order) and
1.0 (the fft2d composition: sums of 515 terms of magnitude ~100).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (build, conv2d, fft2d, fir, planned,  # noqa: E402
                                 ref, runtime)

#: whisper-base's frontend shapes and ragged ones, as builder arguments
SHAPES = {"fir": ((6180, 15), (1000, 7)),
          "conv2d": ((8, 512, 5, 4), (37, 70, 3, 5))}
DTYPES = (torch.float32, torch.int8, torch.int16, torch.int32)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels run only there")
    return torch.Generator(device="cuda").manual_seed(0)


def _operands(name, args, dtype, gen):
    if name == "fir":
        n, t = args
        shapes = ((n + t - 1,), (t,))
    else:
        h, w, p, q = args
        shapes = ((h + p - 1, w + q - 1), (p, q))
    if dtype.is_floating_point:
        return [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    info = torch.iinfo(dtype)
    return [torch.randint(info.min, info.max, s, generator=gen,
                          device="cuda", dtype=torch.int64).to(dtype)
            for s in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fir", "conv2d"])
def test_kernels_match_plain_versions_on_the_card(name, gen):
    mod = fir if name == "fir" else conv2d
    fn = getattr(mod, name)
    tiles = ([(t,) for t in build.FIR_TILES] if name == "fir"
             else list(build.CONV2D_TILES))
    before = mod.launches
    for args in SHAPES[name]:
        for dtype in DTYPES:
            a, b = _operands(name, args, dtype, gen)
            want = getattr(ref, name)(a, b)
            for tile in tiles:
                got = fn(a, b, tiles=tile)
                torch.cuda.synchronize()
                if dtype.is_floating_point:
                    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
                else:
                    assert torch.equal(got, want)
    assert mod.launches - before == \
        len(SHAPES[name]) * len(DTYPES) * len(tiles)


@pytest.mark.gpu
def test_planned_frontend_runs_the_kernels_on_the_card(gen):
    x = torch.randint(-8, 8, (6194,), generator=gen, device="cuda").to(
        torch.int16)
    h = torch.randint(-3, 4, (15,), generator=gen, device="cuda").to(
        torch.int16)
    before = fir.launches
    assert torch.equal(planned.planned_fir(x, h), ref.fir(x, h))
    assert fir.launches == before + 1
    assert runtime.last_tiles["fir"] == runtime.HopperTiles(
        plan=(103,), tile=(256,))


@pytest.mark.gpu
def test_fft2d_composition_on_the_card(gen):
    re_, im_ = (torch.randn((12, 515), generator=gen, device="cuda")
                for _ in range(2))
    plan = planned.plan_for("fft2d_stage", (12, 515), "float32")
    tiles = runtime.hopper_tiles(plan).tile
    for g, w in zip(fft2d.fft2d(re_, im_, tiles=tiles), ref.fft2d(re_, im_)):
        torch.testing.assert_close(g, w, rtol=0, atol=1.0)
