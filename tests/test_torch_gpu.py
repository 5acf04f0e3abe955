"""The port's GEMM (the skinny and tensor-core kernels), FIR (every
compiled tap count and the generic one, real and complex), conv2d (every
compiled window and the generic one), fft2d, star-stencil (one sweep, and
several a launch) and MTTKRP kernels against their plain versions on the
card, the block-paged serving engine's captured decode step against an
eager one (the MLA family's absorbed decode among them), deepseek-v2's
new GEMM shapes, and training: the facade's backward passes on the hand
kernels, a long-K bf16 GEMM rounded from its fp32 sum, SMOKE train
steps' gradients against the plain versions, the blockwise backward
against the host's under remat full and dots; and the crossover table's
measured race on the hand kernels.

Every test here is ``gpu``-marked and skips without a CUDA card.  The file
imports only the port (no JAX), so it runs on a machine with a card and
PyTorch alone; like ``chip_smoke.py`` it puts the repository's ``src/`` on
the import path itself, so either start line works from the root:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Integers are bit-exact (int32 wraparound, at full-range and extreme
operands); float32 within the registry's atol 1e-3 (FIR, conv2d, the
one-sweep stencils: sums of at most 1024 products in another order; the
multi-sweep stencil within ``recurrences.float_bound``, since 9 sweeps
grow the values ~2000-fold, and bitwise equal to one launch a sweep;
MTTKRP: sums of at most 4096 products of three N(0, 1)
draws, in fp32 or as 3xTF32 on the tensor cores; the GEMMs: sums of at
most 11004 products of N(0, 1) draws, 3xTF32 on the tensor-core kernel
at up to 1024; the rounding error of either is ~1e-4) and 1.0 (fft2d,
the fused kernel and the composition: sums of up to 1024 terms of
magnitude ~100; the FFT kernel, up to 8192^2 points whose outputs reach
~3e4, and bitwise equal to its plain version, which rounds each product
and sum as it does); bf16 results within one bf16 rounding step of the
output, ``2^-7 |ref|``, plus 1e-3.
"""

import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
SRC = str(Path(__file__).resolve().parents[1] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from repro_torch.kernels import (bmm, build, conv2d, fft2d,  # noqa: E402
                                 fir, jacobi2d, mttkrp, planned, ref,
                                 registry, runtime, widesa_mm)

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


def _launches(name, args):
    """The instantiation the runtime picks for FIR's tap count or conv2d's
    filter, and the generic one."""
    if name == "fir":
        picked = runtime.fir_config(*args)
        generic = runtime.fir_config(*args, compiled=build.FIR_GENERIC)
        return [picked] if picked == generic else [picked, generic]
    h, w, p, q = args
    picked = runtime.conv2d_config(p, q, h, w)
    generic = runtime.conv2d_config(p, q, h, w, window=build.CONV2D_GENERIC)
    return [picked] if picked == generic else [picked, generic]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["fir", "conv2d"])
def test_kernels_match_plain_versions_on_the_card(name, gen):
    mod = fir if name == "fir" else conv2d
    fn = getattr(mod, name)
    before = mod.launches
    launched = 0
    for args in SHAPES[name]:
        tiles = _launches(name, args)
        for dtype in DTYPES:
            a, b = _operands(name, args, dtype, gen)
            want = getattr(ref, name)(a, b)
            launched += len(tiles)
            for tile in tiles:
                got = fn(a, b, tiles=tile)
                torch.cuda.synchronize()
                if dtype.is_floating_point:
                    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
                else:
                    assert torch.equal(got, want)
    assert mod.launches - before == launched


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
        plan=(103,), tile=runtime.FirTile(taps=15, lanes=128, blocks=13))


def _fir_check(got, want, dtype):
    if dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    else:
        assert torch.equal(got, want)


#: FIR tap counts held on the card: 15 on its compiled instantiation and
#: the generic one; 1, 7, 16, 64 and 4096 (``MAX_TAPS``) on the generic
#: one
FIR_TAPS = (1, 7, 15, 16, 64, 4096)


@pytest.mark.gpu
@pytest.mark.parametrize("taps", FIR_TAPS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fir_instantiations_match_the_plain_version_on_the_card(taps, dtype,
                                                                gen):
    """Each compiled tap count and the generic instantiation, with both
    block widths, at n_out of 1, one below and one above a chunk, and 10
    chunks and 3 (no multiple of the 4 outputs a lane) on 1 and 3 blocks,
    so that a block walks its ring of chunk slots round more than once."""
    compiled = [build.FIR_GENERIC] + [t for t in build.FIR_TAPS if t == taps]
    before = fir.launches
    launched = 0
    for lanes in build.FIR_LANES:
        chunk = lanes * build.FIR_LANE_OUTPUTS
        for n_out in (1, chunk - 1, chunk + 1, 10 * chunk + 3):
            x, h = _operands("fir", (n_out, taps), dtype, gen)
            want = ref.fir(x, h)
            for ctaps in compiled:
                for blocks in (1, 3):
                    tile = runtime.FirTile(taps=ctaps, lanes=lanes,
                                           blocks=blocks)
                    _fir_check(fir.fir(x, h, tiles=tile), want, dtype)
                    launched += 1
    torch.cuda.synchronize()
    assert fir.launches - before == launched


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3, 5, 13])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fir_of_a_view_into_its_storage_on_the_card(offset, dtype, gen):
    """x starting ``offset`` elements past a 16-byte boundary: the window
    realigned in registers (whole words, and int8's and int16's bytes)."""
    for taps in (7, 15, 64):
        n_out = 3001
        base, h = _operands("fir", (n_out + offset, taps), dtype, gen)
        x = base[offset:]
        assert x.storage_offset() == offset and x.is_contiguous()
        tile = runtime.fir_config(n_out, taps, x.element_size())
        _fir_check(fir.fir(x, h, tiles=tile), ref.fir(x, h), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fir_complex_matches_the_plain_version_in_one_launch_on_the_card(
        dtype, gen):
    """``fir_complex`` against ``ref.fir_complex`` (the reference's four
    passes), one launch a call, on the compiled and generic
    instantiations, planes at different alignments."""
    for n_out, taps in ((6180, 15), (1000, 7), (1, 16), (70001, 64)):
        (xr, hr), (xi, hi) = (_operands("fir", (n_out + 2, taps), dtype, gen)
                              for _ in range(2))
        xr, xi = xr[:n_out + taps - 1], xi[2:]
        want = ref.fir_complex(xr, xi, hr, hi)
        tiles = [None, runtime.fir_config(n_out, taps, xr.element_size(),
                                          planes=2,
                                          compiled=build.FIR_GENERIC)]
        for tile in tiles:
            before = fir.launches
            got = fir.fir_complex(xr, xi, hr, hi, tiles=tile)
            assert fir.launches == before + 1
            for g, w in zip(got, want):
                _fir_check(g, w, dtype)


@pytest.mark.gpu
def test_fir_launch_refused_by_the_kernel_raises_on_the_card(gen):
    """A launch the C entry refuses (64 lanes a block) raises, as does one
    the wrapper refuses (a tap count not compiled) before it."""
    x, h = _operands("fir", (100, 15), torch.float32, gen)
    out = torch.empty(100, device="cuda")
    with pytest.raises(RuntimeError, match="widesa_fir_launch failed"):
        build.call("widesa_fir_launch", x.data_ptr(), h.data_ptr(),
                   out.data_ptr(), 100, 15, build.DTYPE_CODES[x.dtype],
                   build.DTYPE_CODES[out.dtype], tiles=(15, 64, 1))
    with pytest.raises(ValueError, match="not compiled"):
        fir.fir(x, h, tiles=runtime.FirTile(taps=7, lanes=128, blocks=1))


@pytest.mark.gpu
def test_fft2d_composition_on_the_card(gen):
    re_, im_ = (torch.randn((12, 515), generator=gen, device="cuda")
                for _ in range(2))
    plan = planned.plan_for("fft2d_stage", (12, 515), "float32")
    tiles = runtime.hopper_tiles(plan).tile
    for g, w in zip(fft2d.fft2d(re_, im_, tiles=tiles), ref.fft2d(re_, im_)):
        torch.testing.assert_close(g, w, rtol=0, atol=1.0)


#: the fused fft2d kernel's shapes: whisper-base's frontend tile, a wider
#: one, one row, ragged ones (C no multiple of 4 or of the 32-column
#: tile), the pipeline's smoke grid (the kernel's 64 rows)
FFT_SHAPES = ((12, 515), (16, 1024), (1, 7), (12, 67), (7, 130), (64, 64))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FFT_SHAPES, ids=str)
def test_fused_fft2d_matches_plain_version_on_the_card(shape, gen):
    """One launch of the fused kernel on the route the runtime picks,
    within the registry's atol of ``ref.fft2d``; K split over a cluster
    repeats its bits."""
    re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                for _ in range(2))
    tile = runtime.fft2d_route(*shape)
    assert isinstance(tile, runtime.Fft2dTile)
    before = dict(fft2d.variants)
    got = fft2d.fft2d(re_, im_, tiles=tile)
    for g, w in zip(got, ref.fft2d(re_, im_)):
        torch.testing.assert_close(g, w, rtol=0, atol=1.0)
    again = fft2d.fft2d(re_, im_, tiles=tile)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    torch.cuda.synchronize()
    assert fft2d.variants["fused"] - before["fused"] == 2
    assert fft2d.variants["composition"] == before["composition"]


@pytest.mark.gpu
def test_fft2d_route_by_rows_on_the_card(gen):
    """The registry's tiles: the fused kernel at the pipeline's 64 x 64
    grid, the composition at 96 rows, the FFT kernel at 128; each launch
    counted under its form, and a fused launch the kernel does not take
    raises."""
    from repro_torch.core import Target, best_plan, lower_plan

    chip = Target(name="single_chip", mesh_shape=(1, 1))
    spec = registry.get("fft2d_stage")
    for shape, form in (((64, 64), "fused"), ((96, 64), "composition"),
                        ((128, 64), "fft")):
        rec = spec.builder(*shape, "float32")
        ops = registry.operands(rec, gen, "cuda")
        before = dict(fft2d.variants)
        got = lower_plan(best_plan(rec, chip), "pallas")(*ops)
        for g, w in zip(got, spec.ref(*ops)):
            torch.testing.assert_close(g, w, rtol=0, atol=1.0)
        torch.cuda.synchronize()
        assert {k: fft2d.variants[k] - before[k] for k in before} == {
            "fused": form == "fused", "fft": form == "fft",
            "composition": form == "composition"}
        assert isinstance(runtime.last_tiles["fft2d_stage"].tile,
                          runtime.Fft2dTile) == (form == "fused")
        assert isinstance(runtime.last_tiles["fft2d_stage"].tile,
                          runtime.FftTile) == (form == "fft")
    re_, im_ = (torch.randn((12, 515), generator=gen, device="cuda")
                for _ in range(2))
    for split in (0, 9):  # no cluster, and past the portable 8
        with pytest.raises(ValueError, match="not a fused fft2d launch"):
            fft2d.fft2d(re_, im_, tiles=runtime.Fft2dTile(split=split))


#: the FFT kernel's shapes: a square, a tall grid over a cluster of 8,
#: long rows, and the pipeline's bench grid
FFT_KERNEL_SHAPES = ((128, 128), (4096, 256), (512, 8192), (8192, 8192))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FFT_KERNEL_SHAPES, ids=str)
def test_fft_kernel_matches_plain_version_on_the_card(shape, gen):
    """The FFT kernel's two passes on the runtime's tile, counted under
    ``fft``: bitwise equal to ``fft2d.fft_plain`` on the card (each product
    and sum rounded alone in both), and within the registry's atol of
    ``torch.fft.fft2`` (``ref.fft2d``) as a check."""
    re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                for _ in range(2))
    tile = runtime.fft2d_route(*shape)
    assert isinstance(tile, runtime.FftTile)
    before = dict(fft2d.variants)
    got = fft2d.fft2d(re_, im_, tiles=tile)
    torch.cuda.synchronize()
    assert {k: fft2d.variants[k] - before[k] for k in before} == {
        "fused": 0, "fft": 1, "composition": 0}
    for g, w in zip(got, fft2d.fft_plain(re_, im_, tile)):
        assert torch.equal(g, w)
    for g, w in zip(got, ref.fft2d(re_, im_)):
        torch.testing.assert_close(g, w, rtol=0, atol=1.0)


@pytest.mark.gpu
def test_fft_kernel_bad_launch_raises(gen):
    """A configuration the kernel refuses: the wrapper's check raises
    before the launch, and the entry point itself returns an error (a
    strip wider than the grid) that ``build.call`` raises."""
    shape = (128, 64)
    re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                for _ in range(2))
    tile = dataclasses.replace(runtime.fft2d_route(*shape), strip=128)
    with pytest.raises(ValueError, match="not an fft launch"):
        fft2d.fft2d(re_, im_, tiles=tile)
    tw = fft2d.twiddles(64, re_.device), fft2d.twiddles(128, re_.device)
    z = torch.empty_like(re_)
    with pytest.raises(RuntimeError, match="widesa_fft_launch failed"):
        build.call("widesa_fft_launch", re_.data_ptr(), im_.data_ptr(),
                   tw[0].data_ptr(), tw[1].data_ptr(), z.data_ptr(),
                   z.data_ptr(), 128, 64,
                   runtime.radix_logs(tile.row_radices),
                   len(tile.row_radices),
                   runtime.radix_logs(tile.col_radices),
                   len(tile.col_radices), tile.rows, tile.strip,
                   tile.cluster)


#: ragged stencil grids (outputs not multiples of the tiles) per star, and
#: ragged MTTKRP extents (I, J, K, L)
STENCIL_GRIDS = ((63, 61), (40, 300))
MTTKRP_SHAPES = ((37, 45, 7, 5), (130, 70, 3, 11))


def _draw(shape, dtype, gen):
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device="cuda")
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, shape, generator=gen,
                         device="cuda", dtype=torch.int64).to(dtype)


def _same(got, want):
    if want.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    else:
        assert torch.equal(got, want)


def _stencil_tile(name, shape, sweeps=3):
    """The launch the runtime picks for a stencil over a grid of
    ``shape``."""
    if name == "jacobi2d_ms":
        return runtime.sweep_tile(sweeps)
    pad = 4 if name == "jacobi2d_9pt" else 2
    return runtime.star_tile(shape[0] - pad, shape[1] - pad)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["jacobi2d", "jacobi2d_9pt", "jacobi2d_ms"])
def test_star_stencils_match_plain_versions_on_the_card(name, gen):
    """Full-range integers wrap; jacobi2d_ms runs 3 sweeps on the promoted
    int32 state in ceil(3 / T_b) launches, and an int32 grid takes int8
    weights as a halo chain's consumer does."""
    fn, plain = getattr(jacobi2d, name), getattr(ref, name)
    n_points = 9 if name == "jacobi2d_9pt" else 5
    before = jacobi2d.launches
    launched = 0
    for shape in STENCIL_GRIDS:
        tile = _stencil_tile(name, shape)
        for dtype in DTYPES:
            grid = _draw(shape, dtype, gen)
            weights = _draw((3, n_points) if name == "jacobi2d_ms"
                            else (n_points,), dtype, gen)
            _same(fn(grid, weights, tiles=tile), plain(grid, weights))
            launched += tile.launches(3) if name == "jacobi2d_ms" else 1
        grid = _draw(shape, torch.int32, gen)
        weights = _draw((n_points,), torch.int8, gen)
        if name != "jacobi2d_ms":
            _same(fn(grid, weights, tiles=tile), plain(grid, weights))
            launched += 1
    torch.cuda.synchronize()
    assert jacobi2d.launches - before == launched


#: one-sweep star grids: the smallest each star takes (3 x 3, 5 x 5), a
#: single output row and column, narrower than a lane's 4 columns, ragged
#: across warps and blocks (512 output columns)
STAR_GRIDS = {5: ((3, 3), (3, 700), (700, 3), (9, 130), (63, 61),
                  (200, 1030)),
              9: ((5, 5), (5, 600), (600, 5), (12, 133), (61, 59),
                  (200, 1030))}


@pytest.mark.gpu
@pytest.mark.parametrize("points", [5, 9])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_every_star_and_ragged_grid_matches_the_plain_version_on_the_card(
        points, dtype, gen):
    """``star_kernel`` on each compiled star: the band of rows the runtime
    picks, and bands of 1 and 7 rows (several bands a launch); each launch
    counted under its star."""
    fn = jacobi2d.jacobi2d if points == 5 else jacobi2d.jacobi2d_9pt
    plain = ref.jacobi2d if points == 5 else ref.jacobi2d_9pt
    pad = 2 if points == 5 else 4
    before = dict(jacobi2d.variants)
    launched = 0
    for shape in STAR_GRIDS[points]:
        grid, weights = _draw(shape, dtype, gen), _draw((points,), dtype, gen)
        want = plain(grid, weights)
        picked = runtime.star_tile(shape[0] - pad, shape[1] - pad)
        for tile in {picked, runtime.StarTile(1), runtime.StarTile(7)}:
            _same(fn(grid, weights, tiles=tile), want)
            launched += 1
    torch.cuda.synchronize()
    assert {k: jacobi2d.variants[k] - before[k] for k in before} == {
        "star5": launched * (points == 5), "star9": launched * (points == 9),
        "sweeps": 0}


def _extremes(shape, dtype, gen):
    """Operands at a dtype's extremes: all max, all min, and the two
    mixed at random."""
    info = torch.iinfo(dtype)
    yield torch.full(shape, info.max, dtype=dtype, device="cuda")
    yield torch.full(shape, info.min, dtype=dtype, device="cuda")
    yield torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.5,
                      info.min, info.max).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES[1:], ids=str)
def test_star_integer_extremes_wrap_as_the_plain_version_on_the_card(
        dtype, gen):
    """Grids and weights at the dtype's max and min, one sweep of each
    star and 9 sweeps (two launches): int32 wraps as the plain version
    wraps."""
    for grid in _extremes((37, 70), dtype, gen):
        for weights in _extremes((9, 5), dtype, gen):
            for name, w in (("jacobi2d", weights[0]),
                            ("jacobi2d_9pt", weights.reshape(-1)[:9]),
                            ("jacobi2d_ms", weights)):
                w = w.contiguous()
                tile = _stencil_tile(name, grid.shape, sweeps=9)
                assert torch.equal(
                    getattr(jacobi2d, name)(grid, w, tiles=tile),
                    getattr(ref, name)(grid, w))


#: sweep counts around the runtime's T_b (8): one launch up to T_b, two
#: from T_b + 1
SWEEPS = sorted({1, 2, 3, runtime.sweep_tile(8).sweeps,
                 runtime.sweep_tile(8).sweeps + 1, 8, 9})
#: multi-sweep outputs: a 3 x 3 grid (one interior point), ragged ones
#: inside one 64 x 128 state tile and across several
SWEEP_OUTS = ((1, 1), (59, 57), (130, 300))


@pytest.mark.gpu
@pytest.mark.parametrize("t", SWEEPS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fused_sweeps_match_the_plain_version_on_the_card(t, dtype, gen):
    """``jacobi2d_ms`` on ``sweeps_kernel`` with the runtime's T_b: the
    plain version's result (integers bit-exact, full-range; float32 within
    ``recurrences.float_bound``), in ceil(T / T_b) launches, and bitwise
    equal to one launch a sweep (T_b = 1)."""
    from repro_torch.launch import recurrences

    spec = registry.get("jacobi2d_ms")
    for oh, ow in SWEEP_OUTS:
        rec = spec.builder(oh, ow, t, str(dtype).removeprefix("torch."))
        grid, weights = (_draw(s, dtype, gen) for s in spec.operand_shapes(rec))
        tile = runtime.sweep_tile(t)
        before = jacobi2d.variants["sweeps"]
        got = jacobi2d.jacobi2d_ms(grid, weights, tiles=tile)
        torch.cuda.synchronize()
        assert jacobi2d.variants["sweeps"] - before == tile.launches(t) \
            == -(-t // tile.sweeps)
        err, ok = recurrences.compare(spec, rec, (grid, weights), got,
                                      ref.jacobi2d_ms(grid, weights))
        assert ok, err
        one = jacobi2d.jacobi2d_ms(grid, weights,
                                   tiles=runtime.SweepTile(sweeps=1))
        assert torch.equal(got, one)


#: conv2d filters: every compiled window, and the generic instantiation's
#: 1 x 1 and 3 x 5 (on its 8 accumulators a column), 12 x 7 and 32 x 32 (on
#: its 32); outputs of one point, of a row narrower than a lane's 4 columns
#: and ragged across warps and blocks
CONV_FILTERS = ((4, 4), (8, 8), (5, 4), (1, 1), (3, 5), (12, 7), (32, 32))
CONV_OUTS = ((1, 1), (3, 700), (37, 70), (130, 333), (5, 2))


def _conv_launches(p, q, oh, ow):
    picked = runtime.conv2d_config(p, q, oh, ow)
    generic = runtime.conv2d_config(p, q, oh, ow, window=build.CONV2D_GENERIC)
    return {picked, generic, runtime.Conv2dTile(picked.window, 5)}


def _window_name(window):
    return "generic" if window == build.CONV2D_GENERIC \
        else f"{window[0]}x{window[1]}"


@pytest.mark.gpu
@pytest.mark.parametrize("pq", CONV_FILTERS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_conv2d_windows_match_the_plain_version_on_the_card(pq, dtype, gen):
    """``conv2d_kernel`` on the window the runtime picks (the compiled one
    for 4 x 4, 8 x 8 and 5 x 4, int8 on ``__dp4a``; else the generic
    instantiation), on the generic one, and with bands of 5 rows;
    full-range integers wrap; each launch counted under its window."""
    p, q = pq
    before = dict(conv2d.variants)
    want = dict.fromkeys(before, 0)
    for oh, ow in CONV_OUTS:
        img = _draw((oh + p - 1, ow + q - 1), dtype, gen)
        filt = _draw((p, q), dtype, gen)
        plain = ref.conv2d(img, filt)
        for tile in _conv_launches(p, q, oh, ow):
            _same(conv2d.conv2d(img, filt, tiles=tile), plain)
            want[_window_name(tile.window)] += 1
    torch.cuda.synchronize()
    assert {k: conv2d.variants[k] - before[k] for k in before} == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES[1:], ids=str)
def test_conv2d_integer_extremes_wrap_as_the_plain_version_on_the_card(
        dtype, gen):
    """Images and filters at the dtype's max and min on every compiled
    window and the generic one: int32 wraps as the plain version wraps."""
    for p, q in CONV_FILTERS:
        oh, ow = 37, 130
        for img in _extremes((oh + p - 1, ow + q - 1), dtype, gen):
            for filt in _extremes((p, q), dtype, gen):
                plain = ref.conv2d(img, filt)
                for tile in _conv_launches(p, q, oh, ow):
                    assert torch.equal(conv2d.conv2d(img, filt, tiles=tile),
                                       plain)


@pytest.mark.gpu
def test_conv2d_windows_refuse_other_filters_on_the_card(gen):
    """A compiled window runs only its own filter size; past 32 nothing
    runs."""
    img = _draw((40, 40), torch.float32, gen)
    with pytest.raises(ValueError, match="not compiled"):
        conv2d.conv2d(img, _draw((4, 5), torch.float32, gen),
                      tiles=runtime.Conv2dTile((4, 4), 4))
    with pytest.raises(ValueError, match="outside the kernel's range"):
        conv2d.conv2d(_draw((40, 40), torch.float32, gen),
                      _draw((33, 2), torch.float32, gen),
                      tiles=runtime.Conv2dTile(build.CONV2D_GENERIC, 4))


@pytest.mark.gpu
def test_mttkrp_matches_plain_version_on_the_card(gen):
    before = mttkrp.launches
    for shape in MTTKRP_SHAPES:
        ni, nj, nk, nl = shape
        for dtype in DTYPES:
            x, b, c = (_draw(s, dtype, gen)
                       for s in ((ni, nk, nl), (nk, nj), (nl, nj)))
            _same(mttkrp.mttkrp(x, b, c, tiles=build.MTTKRP_TILE),
                  ref.mttkrp(x, b, c))
    torch.cuda.synchronize()
    assert mttkrp.launches - before == len(MTTKRP_SHAPES) * len(DTYPES)


#: MTTKRP shapes (I, J, K, L) that reach both kernels: L % 4 != 0 or J %
#: 4 != 0 (int8 on the CUDA cores, float32 X copied 4 bytes at a time),
#: rows of 16-byte runs, whole and ragged output tiles, K whole and split
#: over clusters of 2, 4 and 8 blocks (8 unevenly)
MTTKRP_ROUTED = ((37, 45, 7, 5), (64, 90, 20, 32), (300, 172, 9, 64),
                 (32, 48, 64, 64), (257, 164, 40, 36), (130, 92, 130, 12))


def _mttkrp_operands(shape, dtype, gen):
    ni, nj, nk, nl = shape
    return [_draw(s, dtype, gen) for s in ((ni, nk, nl), (nk, nj), (nl, nj))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_mttkrp_runs_the_kernel_it_is_routed_to_on_the_card(dtype, gen):
    """Each shape on the kernel ``runtime.mttkrp_route`` picks: float32
    and int32, int8 whose rows of X and B allow 4-byte copies and int16
    whose J and L are even on the tensor cores, the rest on the CUDA
    cores; ``mttkrp.variants`` counts every launch under its kernel, and
    a product split over a cluster repeats its bits."""
    want = {"tensor_core": 0, "cuda_core": 0}
    before = dict(mttkrp.variants)
    for shape in MTTKRP_ROUTED:
        x, b, c = _mttkrp_operands(shape, dtype, gen)
        route = runtime.mttkrp_route(shape, dtype, x.data_ptr(),
                                     b.data_ptr())
        unit = {torch.int8: 4, torch.int16: 2}.get(dtype, 1)
        on_tc = shape[1] % unit == 0 and shape[3] % unit == 0
        assert isinstance(route, runtime.MttkrpTile) == on_tc
        got = mttkrp.mttkrp(x, b, c, tiles=route or build.MTTKRP_TILE)
        _same(got, ref.mttkrp(x, b, c))
        want["tensor_core" if on_tc else "cuda_core"] += 1
        if on_tc and route.split > 1:
            assert torch.equal(got, mttkrp.mttkrp(x, b, c, tiles=route))
            want["tensor_core"] += 1
    torch.cuda.synchronize()
    assert {k: mttkrp.variants[k] - before[k] for k in want} == want


@pytest.mark.gpu
def test_misaligned_mttkrp_operands_take_narrower_routes_on_the_card(gen):
    """X one element past a 16-byte boundary: float32 rows are copied 4
    bytes at a time, int8 rows (1-byte aligned) go to the CUDA cores, and
    a launch wider than the rows allow raises."""
    shape = (70, 92, 6, 32)
    ni, nj, nk, nl = shape
    for dtype in (torch.float32, torch.int8):
        x = _draw((ni * nk * nl + 1,), dtype, gen)[1:].view(ni, nk, nl)
        b, c = _draw((nk, nj), dtype, gen), _draw((nl, nj), dtype, gen)
        route = runtime.mttkrp_route(shape, dtype, x.data_ptr(),
                                     b.data_ptr())
        if dtype == torch.float32:
            assert route.copy == 4
        else:
            assert route is None
        before = dict(mttkrp.variants)
        _same(mttkrp.mttkrp(x, b, c, tiles=route or build.MTTKRP_TILE),
              ref.mttkrp(x, b, c))
        torch.cuda.synchronize()
        kernel = "cuda_core" if route is None else "tensor_core"
        assert mttkrp.variants[kernel] == before[kernel] + 1
        with pytest.raises(ValueError, match="not a tensor-core"):
            mttkrp.mttkrp(x, b, c, tiles=runtime.MttkrpTile(1, 16))


#: int16 / int32 MTTKRP on the tensor cores: the bench size, ragged ones
#: (int16 needs even J and L: its nearest ragged shape) and the largest L
#: whose C tile fits (int16 1024, int32 512), where the extreme operands
#: make each shift's s32 sum of limb products as large as it can be
WIDE_SHAPES = {torch.int16: ((4096, 400, 256, 256), (37, 46, 7, 6),
                             (130, 160, 16, 1024)),
               torch.int32: ((4096, 400, 256, 256), (37, 45, 7, 5),
                             (130, 160, 16, 512))}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.int16, torch.int32), ids=str)
def test_wide_integer_mttkrp_is_bit_exact_on_the_tensor_cores(dtype, gen):
    """int16 and int32 as int8 limbs on ``mttkrp_tc_kernel``, bitwise equal
    to the plain version at full-range operands and at extreme ones (all
    min, all max, the two mixed), whose exact sums overflow int32."""
    info = torch.iinfo(dtype)
    before = mttkrp.variants["tensor_core"]
    launched = 0
    for shape in WIDE_SHAPES[dtype]:
        ni, nj, nk, nl = shape
        shapes = ((ni, nk, nl), (nk, nj), (nl, nj))
        fills = [[_draw(s, dtype, gen) for s in shapes]]
        if shape != WIDE_SHAPES[dtype][0]:
            for v in (info.min, info.max):
                fills.append([torch.full(s, v, dtype=dtype, device="cuda")
                              for s in shapes])
            fills.append([torch.where(torch.rand(s, generator=gen,
                                                 device="cuda") < 0.5,
                                      info.min, info.max).to(dtype)
                          for s in shapes])
        for x, b, c in fills:
            route = runtime.mttkrp_route(shape, dtype, x.data_ptr(),
                                         b.data_ptr())
            assert isinstance(route, runtime.MttkrpTile)
            assert torch.equal(mttkrp.mttkrp(x, b, c, tiles=route),
                               ref.mttkrp(x, b, c))
            launched += 1
    torch.cuda.synchronize()
    assert mttkrp.variants["tensor_core"] - before == launched


@pytest.mark.gpu
def test_execute_plan_runs_the_new_kernels_on_the_card(gen):
    """The pipeline's path: a single-chip plan through ``lower_plan``
    launches the hand kernel at the tile ``runtime`` maps the plan onto."""
    from repro_torch.core import Target, best_plan, lower_plan

    chip = Target(name="single_chip", mesh_shape=(1, 1))
    for name in ("jacobi2d", "jacobi2d_9pt", "jacobi2d_ms", "mttkrp"):
        spec = registry.get(name)
        rec = spec.builder(*spec.smoke_args, "int16")
        ops = registry.operands(rec, gen, "cuda")
        mod = mttkrp if name == "mttkrp" else jacobi2d
        before = mod.launches
        _same(lower_plan(best_plan(rec, chip), "pallas")(*ops),
              spec.ref(*ops))
        assert mod.launches > before
        if name == "mttkrp":  # int16 rows of 8 elements: the tensor cores
            assert isinstance(runtime.last_tiles[name].tile,
                              runtime.MttkrpTile)
        else:
            assert runtime.last_tiles[name].tile == \
                runtime.stencil_tile(best_plan(rec, chip)).tile


#: the skinny GEMM at M = 1, 4, 12 and 16 over (N, K): K split over 8
#: blocks of a cluster at N = 96 (B above 1 MiB in every dtype; 11004 is
#: no multiple of 8), and a K below one stage's depth; each with a
#: row-major and a column-major B.  N and K keep B's rows 4-byte aligned
#: in every dtype
SKINNY_ROWS = (1, 4, 12, 16)
SKINNY_NK = ((96, 11004), (200, 76))
GEMM_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int16,
               torch.int32)


def _same_gemm(got, want):
    if want.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -7, atol=1e-3)
    else:
        _same(got, want)


def _gemm_draw(shape, dtype, gen):
    """``_draw`` in any GEMM dtype (bf16 rounded from float32 draws)."""
    return _draw(shape, dtype, gen).to(dtype)


def _mm_operands(m, n, k, dtype, col_major, gen, batch=None):
    lead = () if batch is None else (batch,)
    a = _gemm_draw((*lead, m, k), dtype, gen)
    b = (_gemm_draw((*lead, n, k), dtype, gen).transpose(-1, -2)
         if col_major else _gemm_draw((*lead, k, n), dtype, gen))
    return a, b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GEMM_DTYPES, ids=str)
def test_skinny_kernel_matches_plain_versions_on_the_card(dtype, gen):
    """mm at M = 1, 4, 12, 16, both B layouts and ragged K, on the
    configuration the runtime picks (the skinny kernel every time, K
    split unevenly over 8 blocks at N = 96)."""
    before = widesa_mm.variants["skinny"]
    cases = 0
    for m in SKINNY_ROWS:
        for n, k in SKINNY_NK:
            for col_major in (False, True):
                a, b = _mm_operands(m, n, k, dtype, col_major, gen)
                tile = runtime.gemm_tile(a, b, (16, 32, 32))
                assert isinstance(tile, runtime.SkinnyTile)
                assert n != 96 or (tile.split == 8 and k % 8 != 0)
                _same_gemm(widesa_mm.matmul(a, b, tiles=tile), ref.mm(a, b))
                cases += 1
    torch.cuda.synchronize()
    assert widesa_mm.variants["skinny"] - before == cases


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GEMM_DTYPES, ids=str)
def test_skinny_bmm_matches_plain_versions_on_the_card(dtype, gen):
    """bmm on the skinny kernel, with bf16 also flushed to fp32 (the
    attention scores)."""
    before = bmm.variants["skinny"]
    flushes = (None, torch.float32) if dtype == torch.bfloat16 else (None,)
    for m, n, k in ((1, 128, 64), (12, 64, 300)):
        for out_dtype in flushes:
            a, b = _mm_operands(m, n, k, dtype, False, gen, batch=7)
            tile = runtime.gemm_tile(a, b, (16, 32, 32))
            assert isinstance(tile, runtime.SkinnyTile)
            _same_gemm(bmm.bmm(a, b, tiles=tile, out_dtype=out_dtype),
                       ref.bmm(a, b, out_dtype))
    torch.cuda.synchronize()
    assert bmm.variants["skinny"] - before == 2 * len(flushes)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
def test_skinny_split_k_is_bitwise_deterministic_on_the_card(dtype, gen):
    """The cluster adds its partial tiles in a fixed order: two runs of a
    split-K float product give the same bits."""
    a, b = _mm_operands(4, 1024, 2816, dtype, False, gen)
    tile = runtime.gemm_tile(a, b, (4, 32, 32))
    assert tile.split > 1
    first = widesa_mm.matmul(a, b, tiles=tile)
    again = widesa_mm.matmul(a, b, tiles=tile)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    _same_gemm(first, ref.mm(a, b))


@pytest.mark.gpu
def test_misaligned_operands_run_the_tiled_kernel_on_the_card(gen):
    """At most 16 rows: a B one element off its 16-byte boundary (2-byte
    aligned rows) is not a skinny operand: the runtime gives the tiled
    tile, and the launch counts as tiled.  An A the skinny kernel streams
    through its ring beside B, whatever its rows allow: 8-byte copies
    (whisper's 1500 keys), 4-byte ones (a base 4 bytes off), plain loads
    (rows of 63 bf16, a base one element off), against the plain
    version."""
    a = _gemm_draw((4, 64), torch.bfloat16, gen)
    b = _gemm_draw((64 * 130 + 1,), torch.bfloat16, gen)[1:].view(64, 130)
    assert b.dtype == torch.bfloat16 and b.data_ptr() % 4 == 2
    tile = runtime.gemm_tile(a, b, (4, 32, 32))
    assert tile == (4, 32, 32)
    before = dict(widesa_mm.variants)
    _same_gemm(widesa_mm.matmul(a, b, tiles=tile), ref.mm(a, b))
    torch.cuda.synchronize()
    assert widesa_mm.variants["tiled"] == before["tiled"] + 1
    assert widesa_mm.variants["skinny"] == before["skinny"]
    with pytest.raises(ValueError, match="4-byte"):
        widesa_mm.matmul(a, b, tiles=runtime.skinny_tile(
            4, 130, 64, 1, torch.bfloat16))
    flat = _gemm_draw((16 * 1500 + 8,), torch.bfloat16, gen)
    for a, width in ((_gemm_draw((16, 1500), torch.bfloat16, gen), 8),
                     (flat[2:2 + 12 * 64].view(12, 64), 4),
                     (_gemm_draw((16, 63), torch.bfloat16, gen), 0),
                     (flat[1:1 + 5 * 64].view(5, 64), 0)):
        assert runtime.a_copy_bytes(a) == width
        for col_major in (False, True) if a.shape[1] % 2 == 0 else (False,):
            b = _mm_operands(1, 96, a.shape[1], torch.bfloat16, col_major,
                             gen)[1]
            tile = runtime.gemm_tile(a, b, (16, 32, 32))
            assert isinstance(tile, runtime.SkinnyTile)
            before = widesa_mm.variants["skinny"]
            _same_gemm(widesa_mm.matmul(a, b, tiles=tile), ref.mm(a, b))
            assert widesa_mm.variants["skinny"] == before + 1
    torch.cuda.synchronize()


#: skinny GEMMs whose K the staging of A whole in shared memory once kept
#: off the skinny kernel: qwen3-32b's down projection of a 16-token prompt
#: (K = 25600) and K past 100k (a decode product over long context), in
#: bf16, int8 (bitwise) and, at 25600, float32; B drawn as weights, N(0,
#: 1 / K), so that a sum stays O(1) and the bounds are the registry's
#: (fp32 sums of 10^5 unit terms wander past float32's atol 1e-3 in any
#: order)
SKINNY_LONG_K = ((16, 5120, 25600), (16, 64, 131075), (4, 96, 200000))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.int8,
                                   torch.float32), ids=str)
def test_skinny_kernel_at_long_k_matches_plain_versions_on_the_card(
        dtype, gen):
    """The skinny kernel at ``SKINNY_LONG_K`` (A streamed through the ring
    by cp.async where its rows allow, else by plain loads: K = 131075 in
    bf16), K split over at most 8 blocks of a cluster: against the plain
    version, every launch counted as skinny, two runs the same bits."""
    before = widesa_mm.variants["skinny"]
    cases = 0
    for m, n, k in SKINNY_LONG_K:
        if dtype == torch.float32 and k > 25600:
            continue
        a, b = _mm_operands(m, n, k, dtype, False, gen)
        if dtype.is_floating_point:
            b = (b.float() * k ** -0.5).to(dtype)
        tile = runtime.gemm_tile(a, b, (16, 32, 32))
        assert isinstance(tile, runtime.SkinnyTile), (m, n, k)
        assert 1 <= tile.split <= runtime.SKINNY_MAX_CLUSTER
        got = widesa_mm.matmul(a, b, tiles=tile)
        _same_gemm(got, ref.mm(a, b))
        assert torch.equal(got, widesa_mm.matmul(a, b, tiles=tile))
        cases += 2
    torch.cuda.synchronize()
    assert widesa_mm.variants["skinny"] - before == cases


#: the tensor-core GEMM at M = 17, 64, 127 and 512 (more than 16 rows):
#: qwen's q/k/v/o prefill (N = K = 1024), and a ragged N and K whose rows
#: stay whole 16-byte units in bf16 and float32; bmm batched over 3, N of
#: the head dimension and a ragged one
TC_ROWS = (17, 64, 127, 512)
TC_NK = ((1024, 1024), (200, 136))
TC_BMM_NK = ((64, 64), (72, 200))
#: (input, output) dtypes: bf16 to bf16, bf16 to fp32 (the attention
#: scores), float32 (3xTF32)
TC_FLOATS = ((torch.bfloat16, None), (torch.bfloat16, torch.float32),
             (torch.float32, None))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,out_dtype", TC_FLOATS,
                         ids=["bf16", "bf16-fp32", "fp32"])
def test_tc_kernel_matches_plain_versions_on_the_card(dtype, out_dtype, gen):
    """mm and bmm at M = 17..512, both B layouts, whole and ragged tiles,
    on the configuration the runtime picks (the tensor-core kernel every
    time); ``variants`` counts each launch under ``wgmma``; a second run
    gives the same bits."""
    before = {"mm": dict(widesa_mm.variants), "bmm": dict(bmm.variants)}
    want = {"mm": 0, "bmm": 0}
    for m in TC_ROWS:
        for col_major in (False, True):
            for kind, nks, batch in (("mm", TC_NK, None),
                                     ("bmm", TC_BMM_NK, 3)):
                fn, plain = ((widesa_mm.matmul, ref.mm) if kind == "mm"
                             else (bmm.bmm, ref.bmm))
                for n, k in nks:
                    a, b = _mm_operands(m, n, k, dtype, col_major, gen, batch)
                    tile = runtime.gemm_tile(a, b, (64, 32, 32))
                    assert isinstance(tile, runtime.TcTile)
                    got = fn(a, b, tiles=tile, out_dtype=out_dtype)
                    _same_gemm(got, plain(a, b, out_dtype))
                    assert torch.equal(
                        got, fn(a, b, tiles=tile, out_dtype=out_dtype))
                    want[kind] += 2
    torch.cuda.synchronize()
    for kind, mod in (("mm", widesa_mm), ("bmm", bmm)):
        moved = {v: mod.variants[v] - before[kind][v] for v in mod.variants}
        assert moved == {"skinny": 0, "wgmma": want[kind], "wgmma_cp": 0,
                         "tiled": 0}


#: every compiled tensor-core tile of the float dtypes (the integer ones:
#: test_every_integer_tc_tile_matches_the_plain_version_on_the_card)
TC_COMPILED = [(dtype, tile) for dtype, tiles in runtime.TC_TILES.items()
               if dtype.is_floating_point for tile in tiles]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tile", TC_COMPILED,
                         ids=[f"{d}-{t}" for d, t in TC_COMPILED])
def test_every_tc_tile_matches_the_plain_version_on_the_card(dtype, tile,
                                                             gen):
    """Each compiled tile of its dtype, with 2 and 4 ring stages and K
    whole or split over clusters of 2, 3 and 8 (every rank at least one
    k-tile), on a ragged mm and bmm, both B layouts; a split repeats its
    bits."""
    for stages in (2, runtime.TC_MAX_STAGES):
        for split in (1, 2, 3, 8):
            tc = runtime.TcTile(bm=tile[0], bn=tile[1], stages=stages,
                                split=split)
            for col_major in (False, True):
                a, b = _mm_operands(100, 200, 1000, dtype, col_major, gen)
                got = widesa_mm.matmul(a, b, tiles=tc)
                _same_gemm(got, ref.mm(a, b))
                assert torch.equal(got, widesa_mm.matmul(a, b, tiles=tc))
                a, b = _mm_operands(61, 72, 1000, dtype, col_major, gen,
                                    batch=3)
                _same_gemm(bmm.bmm(a, b, tiles=tc), ref.bmm(a, b))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_operands_tma_cannot_address_run_the_tiled_kernel_on_the_card(gen):
    """Above 16 rows: a B one element off its 16-byte boundary and rows of
    an odd number of bf16 elements (A of 63) allow no 4-byte copy and take
    the tiled tile, and a tensor-core launch on the misaligned B raises;
    int8 rows of 72 bytes, which TMA cannot address, take the tensor
    cores through the limb pre-pass (``wgmma``), bit for bit; each
    against the plain version."""
    cases = []
    a = _gemm_draw((64, 64), torch.bfloat16, gen)
    cases.append((a, _gemm_draw((64 * 130 + 1,), torch.bfloat16,
                                gen)[1:].view(64, 130), "tiled"))
    cases.append((_gemm_draw((64, 63), torch.bfloat16, gen),
                  _gemm_draw((63, 128), torch.bfloat16, gen), "tiled"))
    cases.append((_gemm_draw((64, 72), torch.int8, gen),
                  _gemm_draw((72, 128), torch.int8, gen), "wgmma"))
    for a, b, kernel in cases:
        tile = runtime.gemm_tile(a, b, (64, 32, 32))
        assert (tile == (64, 32, 32)) == (kernel == "tiled")
        before = dict(widesa_mm.variants)
        _same_gemm(widesa_mm.matmul(a, b, tiles=tile), ref.mm(a, b))
        torch.cuda.synchronize()
        assert {v: widesa_mm.variants[v] - before[v] for v in before} == {
            "skinny": 0, "wgmma": 0, "wgmma_cp": 0, "tiled": 0, kernel: 1}
    a, b, _ = cases[0]
    with pytest.raises(ValueError, match="TMA"):
        widesa_mm.matmul(a, b, tiles=runtime.tc_tile(64, 130, 64,
                                                     torch.bfloat16))


#: gemm_tc_kernel's cp.async producer: (kind, M, N, K, batch, B
#: column-major, A in padded rows, dtype, out dtype, the copy widths of A
#: and B): whisper-base's encoder scores' dB over 1500 frames (A, keys^T,
#: in padded rows by TMA; B the bf16 cotangent, rows of 3000 bytes, by
#: 8-byte copies), a float32 A of 1001 columns and a float32 B of 201 (4
#: bytes), a bf16 B of 130 columns (4) flushed to fp32 too, a column-major
#: B over K = 1500 (8) and both operands copied at once
TC_CP_CASES = (
    ("bmm", 64, 1500, 1500, 32, False, True, torch.bfloat16, None, (0, 8)),
    ("mm", 100, 200, 1001, None, False, False, torch.float32, None, (4, 0)),
    ("mm", 100, 201, 1000, None, False, False, torch.float32, None, (0, 4)),
    ("mm", 300, 130, 1000, None, False, False, torch.bfloat16, None, (0, 4)),
    ("mm", 300, 130, 1000, None, False, False, torch.bfloat16,
     torch.float32, (0, 4)),
    ("mm", 200, 256, 1500, None, True, False, torch.bfloat16, None, (8, 8)),
    ("bmm", 61, 72, 1002, 3, True, False, torch.float32, None, (8, 8)),
)


@pytest.mark.gpu
@pytest.mark.parametrize("case", TC_CP_CASES,
                         ids=[f"{c[0]}{c[1:5]}-{c[7]}" for c in TC_CP_CASES])
def test_tc_cp_producer_matches_plain_versions_on_the_card(case, gen):
    """The runtime's pick for an operand TMA cannot address whose rows
    allow 8- or 4-byte copies is ``gemm_tc_kernel`` with the cp.async
    producer (``TcTile.copies``, counted under ``wgmma_cp``), at
    ``TC_CP_CASES``: against the plain version (bf16 2^-7|ref| + 1e-3 on
    the fp32 stage sums, float32 atol 1e-3), a second run the same
    bits."""
    kind, m, n, k, batch, col_major, pad, dtype, out_dtype, copies = case
    a, b = _mm_operands(m, n, k, dtype, col_major, gen, batch)
    if pad:
        unit = 16 // dtype.itemsize
        rows = torch.empty((*a.shape[:-1], -(-k // unit) * unit),
                           dtype=dtype, device="cuda")
        rows[..., k:] = float("nan")
        a = rows[..., :k]
        a.copy_(_gemm_draw(a.shape, dtype, gen))
    assert runtime.tc_copies(a, b) == copies
    tile = runtime.gemm_tile(a, b, (64, 32, 32))
    assert isinstance(tile, runtime.TcTile) and tile.producer == "cp"
    assert tile.copies == copies
    fn, plain = ((widesa_mm.matmul, ref.mm) if kind == "mm"
                 else (bmm.bmm, ref.bmm))
    mod = widesa_mm if kind == "mm" else bmm
    before = dict(mod.variants)
    got = fn(a, b, tiles=tile, out_dtype=out_dtype)
    _same_gemm(got, plain(a, b, out_dtype))
    assert torch.equal(got, fn(a, b, tiles=tile, out_dtype=out_dtype))
    torch.cuda.synchronize()
    assert {v: mod.variants[v] - before[v] for v in before} == {
        "skinny": 0, "wgmma": 0, "wgmma_cp": 2, "tiled": 0}
    with pytest.raises(ValueError, match="TMA"):
        fn(a, b, tiles=dataclasses.replace(tile, copies=(0, 0)))


@pytest.mark.gpu
@pytest.mark.parametrize("col_major", [False, True], ids=["row", "col"])
def test_padded_b_rows_take_tma_on_the_card(col_major, gen):
    """A B in rows padded to whole 16-byte units over an odd extent (the
    head's bf16 cotangent over an odd vocabulary, as the backward pads it
    for dW; its rows alone allow no 4-byte copy), row- or column-major,
    with A in padded rows over the odd K: TMA reads both at their pitch
    and zero-fills past the rows' end (the padding holds NaN), on
    ``gemm_tc_kernel``'s TMA producer, against the plain version."""
    k, n = 201, 1001

    def padded(outer, inner, pitch):
        rows = torch.full((outer, pitch), float("nan"), dtype=torch.bfloat16,
                          device="cuda")
        rows[:, :inner] = _gemm_draw((outer, inner), torch.bfloat16, gen)
        return rows[:, :inner]

    b = padded(n, k, 1008).t() if col_major else padded(k, n, 1008)
    a = padded(100, k, 208)
    assert runtime.b_copy_bytes(b) < 4 and runtime.a_copy_bytes(a) < 4
    tile = runtime.gemm_tile(a, b, (64, 32, 32))
    assert isinstance(tile, runtime.TcTile) and tile.producer == "tma"
    before = widesa_mm.variants["wgmma"]
    _same_gemm(widesa_mm.matmul(a, b, tiles=tile), ref.mm(a, b))
    torch.cuda.synchronize()
    assert widesa_mm.variants["wgmma"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tile", TC_COMPILED,
                         ids=[f"{d}-{t}" for d, t in TC_COMPILED])
def test_every_tc_tile_with_the_cp_producer_matches_on_the_card(dtype, tile,
                                                                gen):
    """Each compiled float tile with the cp.async producer, 2 and 4 ring
    stages, K whole or split over clusters of 2, 3 and 8, both B layouts,
    on operands whose rows allow only 8-byte copies (K = 998 and N = 198
    in float32, 996 and 204 in bf16: A and B both copied), an mm and a
    bmm; a split repeats its bits."""
    k, n = (998, 198) if dtype == torch.float32 else (996, 204)
    for stages in (2, runtime.TC_MAX_STAGES):
        for split in (1, 2, 3, 8):
            tc = runtime.TcTile(bm=tile[0], bn=tile[1], stages=stages,
                                split=split, copies=(8, 8))
            for col_major in (False, True):
                a, b = _mm_operands(100, n, k, dtype, col_major, gen)
                got = widesa_mm.matmul(a, b, tiles=tc)
                _same_gemm(got, ref.mm(a, b))
                assert torch.equal(got, widesa_mm.matmul(a, b, tiles=tc))
                a, b = _mm_operands(61, n, k, dtype, col_major, gen,
                                    batch=3)
                _same_gemm(bmm.bmm(a, b, tiles=tc), ref.bmm(a, b))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GEMM_DTYPES, ids=str)
def test_padded_a_rows_match_plain_versions_on_the_card(dtype, gen):
    """A in rows padded to whole 16-byte units (the attention values'
    softmax weights at an odd key count, K = 127): the skinny kernel at 12
    rows; at 127 rows the tensor-core kernels in every dtype (TMA reads
    the padded rows and zero-fills past K; the integers' limb pre-pass
    zeroes the padding); mm and bmm, each launch counted as routed."""
    k, unit = 127, 16 // dtype.itemsize
    for m in (12, 127):
        rows = _gemm_draw((3, m, -(-k // unit) * unit), dtype, gen)
        # padding no kernel may read
        rows[..., k:] = float("nan") if dtype.is_floating_point else \
            torch.iinfo(dtype).max
        a = rows[..., :k]
        b = _gemm_draw((3, k, 64), dtype, gen)
        for fn, plain, x, y in ((bmm.bmm, ref.bmm, a, b),
                                (widesa_mm.matmul, ref.mm, a[1], b[1])):
            assert runtime.a_pitch(x) == -(-k // unit) * unit
            tile = runtime.gemm_tile(x, y, (64, 32, 32))
            kernel = "skinny" if m <= 16 else "wgmma"
            assert isinstance(tile, {"skinny": runtime.SkinnyTile,
                                     "wgmma": runtime.TcTile,
                                     "tiled": tuple}[kernel])
            mod = bmm if fn is bmm.bmm else widesa_mm
            before = mod.variants[kernel]
            _same_gemm(fn(x, y, tiles=tile), plain(x, y))
            assert mod.variants[kernel] == before + 1
    torch.cuda.synchronize()


#: the integer tensor-core GEMM (gemm_tc_int_kernel): its dtypes, and for
#: each the K of a k-tile (128 bytes) and a row unit (16 bytes)
INT_DTYPES = (torch.int8, torch.int16, torch.int32)


def _int_draw(shape, dtype, gen, fill="full"):
    """Integers at full range, at one extreme, or at both mixed."""
    info = torch.iinfo(dtype)
    if fill == "full":
        return _draw(shape, dtype, gen)
    if fill == "mixed":
        bits = torch.randint(0, 2, shape, generator=gen, device="cuda")
        return torch.where(bits == 1, info.max, info.min).to(dtype)
    return torch.full(shape, getattr(info, fill), dtype=dtype, device="cuda")


def _int_operands(m, n, k, dtype, col_major, gen, batch=None, fill="full"):
    lead = () if batch is None else (batch,)
    a = _int_draw((*lead, m, k), dtype, gen, fill)
    b = (_int_draw((*lead, n, k), dtype, gen, fill).transpose(-1, -2)
         if col_major else _int_draw((*lead, k, n), dtype, gen, fill))
    return a, b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", INT_DTYPES, ids=str)
def test_integer_tc_gemm_matches_plain_versions_on_the_card(dtype, gen):
    """mm and bmm on the integer tensor-core route at ragged shapes (M and
    N no multiple of the tile, K one k-tile plus a remainder of whole
    16-byte units, and five k-tiles plus one) and at the registry's smoke
    shapes, both B layouts: bitwise equal to the plain version, each
    launch counted under ``wgmma``, a second run the same bits."""
    e, unit = 128 // dtype.itemsize, 16 // dtype.itemsize
    before = {"mm": dict(widesa_mm.variants), "bmm": dict(bmm.variants)}
    launched = {"mm": 0, "bmm": 0}
    for col_major in (False, True):
        for kind, (m, n, k), batch in (
                ("mm", (200, 208, e + 3 * unit), None),
                ("mm", (200, 208, 5 * e + 3 * unit), None),
                ("mm", (256, 256, 256), None),
                ("mm", (17, 144, 2 * e + unit), None),
                ("bmm", (100, 96, e + unit), 3),
                ("bmm", (100, 96, 5 * e + unit), 3),
                ("bmm", (128, 128, 64), 4)):
            fn, plain = ((widesa_mm.matmul, ref.mm) if kind == "mm"
                         else (bmm.bmm, ref.bmm))
            a, b = _int_operands(m, n, k, dtype, col_major, gen, batch)
            tile = runtime.gemm_tile(a, b, (64, 32, 32))
            assert isinstance(tile, runtime.TcTile), (kind, m, n, k)
            got = fn(a, b, tiles=tile)
            _same(got, plain(a, b))
            assert torch.equal(got, fn(a, b, tiles=tile))
            launched[kind] += 2
    torch.cuda.synchronize()
    for kind, mod in (("mm", widesa_mm), ("bmm", bmm)):
        moved = {v: mod.variants[v] - before[kind][v] for v in mod.variants}
        assert moved == {"skinny": 0, "wgmma": launched[kind],
                         "wgmma_cp": 0, "tiled": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["min", "max", "mixed"])
@pytest.mark.parametrize("dtype", INT_DTYPES, ids=str)
def test_integer_tc_gemm_at_the_largest_admitted_k_on_the_card(dtype, fill,
                                                                gen):
    """Extreme operands (all at the dtype's minimum or maximum, or both
    mixed) at the largest K a rank may reduce (``TC_INT_MAX_RANK_K`` in
    whole k-tiles), unsplit: the s32 sets come as close to int32's edge
    as operands can bring them, and the result stays bit-exact; one
    k-tile more splits K over 2 ranks and stays bit-exact too."""
    e = 128 // dtype.itemsize
    most = runtime.TC_INT_MAX_RANK_K[dtype] // e * e
    bn = runtime.TC_TILES[dtype][0][1]
    for k, tile in ((most, runtime.TcTile(128, bn, 4, 1)),
                    (most + e, runtime.TcTile(128, bn, 4, 2))):
        a, b = _int_operands(130, 144, k, dtype, False, gen, fill=fill)
        runtime.check_tc(tile, a, b)
        _same(widesa_mm.matmul(a, b, tiles=tile), ref.mm(a, b))
    with pytest.raises(ValueError, match="tensor-core"):
        widesa_mm.matmul(a, b, tiles=runtime.TcTile(128, bn, 4, 1))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", INT_DTYPES, ids=str)
def test_integer_tc_split_k_is_bitwise_deterministic_on_the_card(dtype, gen):
    """K of 15 k-tiles split over clusters of 2, 3 and 8 (every rank at
    least one k-tile), both B layouts: the ranks' uint32 partial tiles add
    to the plain version's bits, the same on two runs; the runtime's own
    split at a tall K the same."""
    e = 128 // dtype.itemsize
    bn = runtime.TC_TILES[dtype][0][1]
    for split in (2, 3, 8):
        for col_major in (False, True):
            a, b = _int_operands(150, 160, 14 * e + 16 // dtype.itemsize,
                                 dtype, col_major, gen)
            tile = runtime.TcTile(128, bn, 4, split)
            first = widesa_mm.matmul(a, b, tiles=tile)
            again = widesa_mm.matmul(a, b, tiles=tile)
            torch.cuda.synchronize()
            assert torch.equal(first, again)
            _same(first, ref.mm(a, b))
    a, b = _int_operands(256, 512, 8192, dtype, False, gen)
    tile = runtime.gemm_tile(a, b, (64, 32, 32))
    assert tile.split == runtime.TC_MAX_SPLIT
    assert torch.equal(widesa_mm.matmul(a, b, tiles=tile),
                       widesa_mm.matmul(a, b, tiles=tile))


@pytest.mark.gpu
def test_int8_bmm_of_half_a_k_tile_on_the_card(gen):
    """bmm with K = 64, half an int8 128-byte k-tile: TMA zero-fills the
    rest of A's rows and of B^T's (the pre-pass's planes of a row-major B;
    a column-major B read as it is), on both int8 tiles; the wider dtypes
    (whole k-tiles) on the runtime's pick: bitwise."""
    for dtype in INT_DTYPES:
        for col_major in (False, True):
            a, b = _int_operands(70, 48, 64, dtype, col_major, gen, batch=5)
            tiles = [runtime.gemm_tile(a, b, (64, 32, 32))]
            if dtype == torch.int8:
                tiles.append(runtime.TcTile(128, 256, 2, 1))
            for tile in tiles:
                assert isinstance(tile, runtime.TcTile)
                _same(bmm.bmm(a, b, tiles=tile), ref.bmm(a, b))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tile", [
    (dtype, tile) for dtype in INT_DTYPES for tile in runtime.TC_TILES[dtype]],
    ids=str)
def test_every_integer_tc_tile_matches_the_plain_version_on_the_card(
        dtype, tile, gen):
    """Each compiled integer tile with 2 and 4 ring stages on a ragged mm
    and bmm, both B layouts."""
    k = 1000 // (16 // dtype.itemsize) * (16 // dtype.itemsize)
    for stages in (2, runtime.TC_MAX_STAGES):
        tc = runtime.TcTile(bm=tile[0], bn=tile[1], stages=stages)
        for col_major in (False, True):
            a, b = _int_operands(100, 272, k, dtype, col_major, gen)
            _same(widesa_mm.matmul(a, b, tiles=tc), ref.mm(a, b))
            a, b = _int_operands(61, 80, k, dtype, col_major, gen, batch=3)
            _same(bmm.bmm(a, b, tiles=tc), ref.bmm(a, b))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the block-paged engine: one decode capture per load()
# ---------------------------------------------------------------------------

def _paged_engine(arch="qwen1.5-0.5b", kv_dtype=None, **kw):
    """A smoke-width paged engine on the card (its decode step captured in
    ``load()``), weights from a seeded generator."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.serve import make_engine

    cfg = get_smoke_config(arch)
    if kv_dtype:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    kw = {"max_lanes": 4, "max_seq": 64, "block_size": 8, **kw}
    eng = make_engine(cfg, kind="paged", **kw)
    eng.load(eng.api.init(torch.Generator(device="cuda").manual_seed(0)))
    return eng


def _prompts(vocab, lens, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lens]


@pytest.mark.gpu
def test_replayed_paged_decode_equals_an_eager_step_on_the_card(gen):
    """One replay of the captured step and one eager ``decode_step_paged``
    on the same pools, tables, pos and active mask (a lane inactive):
    bitwise the same logits and the same pools afterwards."""
    from repro_torch.models import transformer

    eng = _paged_engine()
    assert eng.stats["decode_compiles"] == 1
    for p in _prompts(eng.cfg.vocab, (5, 9, 13), seed=0):
        eng.submit(p, max_new_tokens=8)
    eng.step()
    eng.step()
    active = [i for i, r in enumerate(eng.lanes) if r is not None]
    assert len(active) == 3
    before = {k: v.clone() for k, v in eng.kv.pools.items()}
    nxt = eng._decode(active)
    replay = eng._decode_out[0].clone()
    replayed = {k: v.clone() for k, v in eng.kv.pools.items()}
    for k, v in eng.kv.pools.items():
        v.copy_(before[k])
    tokens = torch.tensor([[eng.lanes[i].output[-1] if i in active else 0]
                           for i in range(eng.max_lanes)],
                          dtype=torch.int32, device="cuda")
    with torch.no_grad(), planned.override(policy=eng.policy):
        logits, _ = transformer.decode_step_paged(
            eng.params, eng.cfg, eng.kv.pools, tokens,
            torch.as_tensor(eng.kv.tables, device="cuda"),
            torch.as_tensor(eng.kv.pos, device="cuda"),
            torch.as_tensor(eng.kv.active, device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(logits, replay)
    for k in replayed:
        assert torch.equal(eng.kv.pools[k], replayed[k]), k
    assert [nxt[i] for i in active] == \
        logits.argmax(-1)[active].tolist()


@pytest.mark.gpu
def test_join_evict_preempt_never_recapture_on_the_card(gen):
    """An oversubscribed pool (preemptions), late joins and evictions: one
    capture, the same graph object throughout, every budget met."""
    eng = _paged_engine(num_blocks=14)
    graph = eng._graph
    prompts = _prompts(eng.cfg.vocab, (20, 20, 20, 20, 7, 11), seed=4)
    for p in prompts[:4]:
        eng.submit(p, max_new_tokens=20)
    for _ in range(3):
        eng.step()
    for p in prompts[4:]:
        eng.submit(p, max_new_tokens=20)
    done = eng.run_until_drained()
    assert sorted(len(r.output) for r in done) == [20] * 6
    assert eng.stats["preemptions"] > 0
    assert eng.stats["decode_compiles"] == 1
    assert eng._graph is graph


@pytest.mark.gpu
def test_paged_pools_are_never_replaced_on_the_card(gen):
    eng = _paged_engine()
    ptrs = {k: v.data_ptr() for k, v in eng.kv.pools.items()}
    with pytest.raises(AttributeError, match="in place"):
        eng.kv.pools = {k: v.clone() for k, v in eng.kv.pools.items()}
    with pytest.raises(TypeError):
        eng.kv.pools["k"] = eng.kv.pools["k"].clone()
    for p in _prompts(eng.cfg.vocab, (6, 30, 9), seed=2):
        eng.submit(p, max_new_tokens=6)
    eng.run_until_drained()
    assert {k: v.data_ptr() for k, v in eng.kv.pools.items()} == ptrs


@pytest.mark.gpu
def test_streamed_audio_through_the_captured_step_on_the_card(gen):
    """whisper-base (smoke, float32 with a float32 cache: a bf16 cache
    would give the float32 attention operands of two dtypes, which no
    kernel takes) streams on the paged engine: every chunk fed while the
    captured step decodes, the slot engine's tokens."""
    from repro_torch.serve import SchedulerConfig, make_engine, synth_samples

    eng = _paged_engine("whisper-base", kv_dtype="float32", max_lanes=2,
                        scheduler=SchedulerConfig(bucketed=False))
    fc = eng.frontend.cfg
    streams = [synth_samples(fc, n, seed=i) for i, n in enumerate((4, 2, 3))]
    slot = make_engine(eng.cfg, kind="slot", max_slots=2, max_seq=64)
    slot.load(eng.params)
    outs = []
    for e in (eng, slot):
        for s in streams:
            e.submit_audio_stream(s, max_new_tokens=6)
        done = e.run_until_drained()
        assert all(r.fed == len(r.chunks) for r in done)
        outs.append({r.rid: list(r.output) for r in done})
    assert eng.stats["decode_compiles"] == 1
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# long prompts (blockwise attention) and offline audio
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_blockwise_equals_sdpa_at_2048_on_the_card(gen):
    """``blockwise_attention`` forced at S = 2048 (fp32, 4 heads of 64,
    the serving chunks) against ``sdpa`` on the hand kernels, causal and
    not, within the CPU test's fp32 tolerance (atol 2e-4, rtol 1e-3)."""
    from repro_torch.models import layers

    q, k, v = (torch.randn((1, 2048, 4, 64), generator=gen, device="cuda")
               for _ in range(3))
    before = bmm.variants["wgmma"]
    for causal in (True, False):
        torch.testing.assert_close(
            layers.blockwise_attention(q, k, v, causal=causal),
            layers.sdpa(q, k, v, causal=causal), atol=2e-4, rtol=1e-3)
    assert bmm.variants["wgmma"] == before + 4  # sdpa's scores and values


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
def test_long_smoke_prefill_on_the_card_equals_the_cpu(gen):
    """A 4096-token prompt on the qwen smoke config (float32): the prefill
    on the card (blockwise attention, every projection on the tensor-core
    kernel) against the same prefill on the CPU, within the dense
    tolerance (atol = rtol = 1e-4)."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config("qwen1.5-0.5b")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, 4096)), dtype=torch.int32)
    with torch.no_grad():
        want, _ = build_model(cfg, "cpu").prefill(params, {"tokens": tokens},
                                                  4096)
        before = widesa_mm.variants["wgmma"]
        got, cache = build_model(cfg, "cuda").prefill(
            _to(params, "cuda"), {"tokens": tokens.cuda()}, 4096)
    assert widesa_mm.variants["wgmma"] - before == 7 * cfg.n_layers
    assert cache["pos"].tolist() == [4096]
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_whisper_encoder_attention_gemms_at_1500_keys_on_the_card(gen):
    """The whisper-base encoder's attention over 1500 frames (8 heads of
    64, bf16): the scores bmm(8, 1500, 1500, 64) reading K column-major
    and flushing to fp32, the values bmm reading the softmax weights in
    rows padded to 1504, each on the tensor-core kernel against its
    plain version."""
    from repro_torch.models import layers

    q, k = (_gemm_draw((8, 1500, 64), torch.bfloat16, gen) for _ in range(2))
    kt = k.transpose(1, 2)
    before = bmm.variants["wgmma"]
    s = planned.planned_bmm(q, kt, site="attn.scores",
                            out_dtype=torch.float32)
    _same_gemm(s, ref.bmm(q, kt, torch.float32))
    w = planned.padded_rows(torch.softmax(s / 8.0, dim=-1), torch.bfloat16)
    assert runtime.a_pitch(w) == 1504
    v = _gemm_draw((8, 1500, 64), torch.bfloat16, gen)
    _same_gemm(planned.planned_bmm(w, v, site="attn.values"),
               ref.bmm(w, v))
    assert bmm.variants["wgmma"] == before + 2


@pytest.mark.gpu
def test_text_with_frames_through_the_captured_step_on_the_card(gen):
    """whisper-base (smoke, float32 with a float32 cache) serves text
    requests with precomputed frames on the paged engine, prefilled
    offline and decoded by the captured step: the slot engine's
    tokens."""
    import numpy as np

    from repro_torch.serve import SchedulerConfig, make_engine

    eng = _paged_engine("whisper-base", kv_dtype="float32", max_lanes=2,
                        scheduler=SchedulerConfig(bucketed=False))
    cfg = eng.cfg
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, cfg.vocab, 3 + i), rng.standard_normal(
        (cfg.enc_frames, cfg.d_model)).astype(np.float32)) for i in range(3)]
    slot = make_engine(cfg, kind="slot", max_slots=2, max_seq=64)
    slot.load(eng.params)
    outs = []
    for e in (eng, slot):
        for prompt, frames in reqs:
            e.submit(prompt, max_new_tokens=5, extra={"frames": frames})
        outs.append({r.rid: list(r.output) for r in e.run_until_drained()})
    assert eng.stats["decode_compiles"] == 1
    assert outs[0] == outs[1] and all(len(o) == 5 for o in outs[0].values())


# ---------------------------------------------------------------------------
# the MoE family (olmoe-1b-7b): the float32 router and the expert stack
# ---------------------------------------------------------------------------

#: olmoe-1b-7b's router, mm(T, 64, 2048) in float32: the skinny kernel up
#: to 16 rows (a 4-lane decode step, short prompts), 3xTF32 on the
#: tensor-core kernel above (a 512-token prompt)
ROUTER_ROWS = (1, 4, 13, 16, 17, 512)
#: its expert stack at full width, (batch, M, N, K) in bf16: gate/up and
#: down at decode (C = 1 slot an expert) on the skinny kernel, and at a
#: 512-token prompt (C = ceil(512 * 8 * 1.25 / 64) = 80) on the
#: tensor-core kernel
EXPERT_SHAPES = ((64, 1, 1024, 2048), (64, 1, 2048, 1024),
                 (64, 80, 1024, 2048), (64, 80, 2048, 1024))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", ROUTER_ROWS)
def test_moe_router_float32_gemm_matches_the_plain_version_on_the_card(
        rows, gen):
    """The router through the planned facade (site ``moe.router``): the
    kernel its rows call for, within float32's atol."""
    x = _gemm_draw((rows, 2048), torch.float32, gen)
    w = _gemm_draw((2048, 64), torch.float32, gen) * 0.02
    before = dict(widesa_mm.variants)
    got = planned.planned_dense(x, w, site="moe.router")
    _same(got, ref.mm(x, w))
    torch.cuda.synchronize()
    kernel = "skinny" if rows <= runtime.SKINNY_ROWS else "wgmma"
    assert {v: widesa_mm.variants[v] - before[v] for v in before} == {
        "skinny": 0, "wgmma": 0, "wgmma_cp": 0, "tiled": 0, kernel: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", EXPERT_SHAPES, ids=str)
def test_moe_expert_bmm_matches_the_plain_version_on_the_card(shape, gen):
    """The expert stack's bmm (row-major weights [64, K, N]) through the
    planned facade, on the kernel its rows call for, within one bf16
    step; a second call gives the same bits."""
    z, m, n, k = shape
    a = _gemm_draw((z, m, k), torch.bfloat16, gen)
    b = _gemm_draw((z, k, n), torch.bfloat16, gen)
    before = dict(bmm.variants)
    got = planned.planned_bmm(a, b, site="moe.gate")
    _same_gemm(got, ref.bmm(a, b))
    assert torch.equal(got, planned.planned_bmm(a, b, site="moe.gate"))
    torch.cuda.synchronize()
    kernel = "skinny" if m <= runtime.SKINNY_ROWS else "wgmma"
    assert {v: bmm.variants[v] - before[v] for v in before} == {
        "skinny": 0, "wgmma": 0, "wgmma_cp": 0, "tiled": 0, kernel: 2}


@pytest.mark.gpu
def test_moe_captured_decode_equals_an_eager_step_on_the_card(gen):
    """olmoe (smoke, float32 with a float32 cache) on the paged engine:
    routing, dispatch and combine capture with the step (nothing waits on
    the host), a replay equals an eager ``decode_step_paged`` bitwise, two
    replays of the same inputs give the same bits, and one lane serves
    the slot engine's tokens."""
    from repro_torch.models import transformer
    from repro_torch.serve import make_engine

    eng = _paged_engine("olmoe-1b-7b", kv_dtype="float32", max_lanes=1)
    assert eng.stats["decode_compiles"] == 1
    prompts = _prompts(eng.cfg.vocab, (5, 9, 13), seed=6)
    eng.submit(prompts[0], max_new_tokens=8)
    eng.step()
    before = {k: v.clone() for k, v in eng.kv.pools.items()}
    eng._decode([0])
    replay = eng._decode_out[0].clone()
    for k, v in eng.kv.pools.items():
        v.copy_(before[k])
    eng._decode([0])
    assert torch.equal(eng._decode_out[0], replay)
    for k, v in eng.kv.pools.items():
        v.copy_(before[k])
    tokens = torch.tensor([[eng.lanes[0].output[-1]]], dtype=torch.int32,
                          device="cuda")
    with torch.no_grad(), planned.override(policy=eng.policy):
        logits, _ = transformer.decode_step_paged(
            eng.params, eng.cfg, eng.kv.pools, tokens,
            torch.as_tensor(eng.kv.tables, device="cuda"),
            torch.as_tensor(eng.kv.pos, device="cuda"),
            torch.as_tensor(eng.kv.active, device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(logits, replay)
    for k, v in eng.kv.pools.items():
        v.copy_(before[k])
    for p in prompts[1:]:
        eng.submit(p, max_new_tokens=8)
    slot = make_engine(eng.cfg, kind="slot", max_slots=1, max_seq=64)
    slot.load(eng.params)
    for p in prompts:
        slot.submit(p, max_new_tokens=8)
    got = {r.rid: list(r.output) for r in eng.run_until_drained()}
    assert got == {r.rid: list(r.output) for r in slot.run_until_drained()}
    assert eng.stats["decode_compiles"] == 1


#: deepseek-v2-236b's new GEMM shapes at full width (d 5120, 128 heads,
#: kv_lora 512, q_lora 1536, vocab 102400, 160 experts of ff 1536), bf16:
#: (site, kind, shape) at a 4-lane decode step, a 16-token prompt (mla.out
#: at K = 16384, the largest a skinny launch stages) and a 512-token one
#: (mla.k_up; the expert stack at C = ceil(512 * 6 * 1.25 / 160) = 24)
DEEPSEEK_SHAPES = (("mla.k_rope", "mm", (4, 64, 5120)),
                   ("mla.q_up", "mm", (4, 24576, 1536)),
                   ("mla.out", "mm", (4, 5120, 16384)),
                   ("mla.out", "mm", (16, 5120, 16384)),
                   ("lm_head", "mm", (4, 102400, 5120)),
                   ("mla.k_up", "mm", (512, 16384, 512)),
                   ("moe.gate", "bmm", (160, 1, 1536, 5120)),
                   ("moe.down", "bmm", (160, 1, 5120, 1536)),
                   ("moe.gate", "bmm", (160, 24, 1536, 5120)))


@pytest.mark.gpu
@pytest.mark.parametrize("site,kind,shape", DEEPSEEK_SHAPES,
                         ids=lambda v: str(v))
def test_deepseek_gemms_match_the_plain_version_on_the_card(site, kind,
                                                            shape, gen):
    """Through the planned facade in bf16 on the kernel the runtime picks
    (the skinny kernel up to 16 rows, the tensor-core kernel above; never
    the tiled one), within one bf16 step of the plain version."""
    *lead, m, n, k = shape
    a = _gemm_draw((*lead, m, k), torch.bfloat16, gen)
    b = _gemm_draw((*lead, k, n), torch.bfloat16, gen)
    mod = widesa_mm if kind == "mm" else bmm
    before = dict(mod.variants)
    fn = planned.planned_dense if kind == "mm" else planned.planned_bmm
    got = fn(a, b, site=site)
    _same_gemm(got, (ref.mm if kind == "mm" else ref.bmm)(a, b))
    torch.cuda.synchronize()
    kernel = "skinny" if m <= runtime.SKINNY_ROWS else "wgmma"
    assert {v: mod.variants[v] - before[v] for v in before} == {
        "skinny": 0, "wgmma": 0, "wgmma_cp": 0, "tiled": 0, kernel: 1}


@pytest.mark.gpu
def test_mla_captured_decode_equals_an_eager_step_on_the_card(gen):
    """deepseek-v2 (smoke, float32 with a float32 latent cache) on the
    paged engine: the absorbed decode captures with the step, a replay
    equals an eager ``decode_step_paged`` bitwise, and one lane serves
    the slot engine's tokens."""
    from repro_torch.models import transformer
    from repro_torch.serve import make_engine

    eng = _paged_engine("deepseek-v2-236b", kv_dtype="float32",
                        max_lanes=1)
    assert set(eng.kv.pools) == {"ckv", "kr"}
    prompts = _prompts(eng.cfg.vocab, (5, 9, 13), seed=6)
    eng.submit(prompts[0], max_new_tokens=8)
    eng.step()
    before = {k: v.clone() for k, v in eng.kv.pools.items()}
    eng._decode([0])
    replay = eng._decode_out[0].clone()
    for k, v in eng.kv.pools.items():
        v.copy_(before[k])
    tokens = torch.tensor([[eng.lanes[0].output[-1]]], dtype=torch.int32,
                          device="cuda")
    with torch.no_grad(), planned.override(policy=eng.policy):
        logits, _ = transformer.decode_step_paged(
            eng.params, eng.cfg, eng.kv.pools, tokens,
            torch.as_tensor(eng.kv.tables, device="cuda"),
            torch.as_tensor(eng.kv.pos, device="cuda"),
            torch.as_tensor(eng.kv.active, device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(logits, replay)
    for k, v in eng.kv.pools.items():
        v.copy_(before[k])
    for p in prompts[1:]:
        eng.submit(p, max_new_tokens=8)
    slot = make_engine(eng.cfg, kind="slot", max_slots=1, max_seq=64)
    slot.load(eng.params)
    for p in prompts:
        slot.submit(p, max_new_tokens=8)
    got = {r.rid: list(r.output) for r in eng.run_until_drained()}
    assert got == {r.rid: list(r.output) for r in slot.run_until_drained()}
    assert eng.stats["decode_compiles"] == 1


# ---------------------------------------------------------------------------
# the SSM and hybrid families (mamba2-780m, zamba2-1.2b)
# ---------------------------------------------------------------------------

#: one full-width Mamba2 block, bf16 on the card against the same block in
#: fp32 on the host (``chip_smoke.py`` ``SSM_OUT_RMS`` and after, where the
#: reasons are): the output's rms error within 2^-6 of its rms, its largest
#: within 2^-4 of the largest output, the final state within 2^-5 of its
#: largest entry; the chunked scan's final state against the recurrent
#: steps on the card within 1e-3 of its largest entry
SSM_BOUNDS = {"out_rms": 2 ** -6, "out_max": 2 ** -4, "state_host": 2 ** -5,
              "state_steps": 1e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_full_width_mamba2_block_matches_the_host_on_the_card(arch, gen):
    """The first trunk block of each model at full width over 300 tokens
    (two SSD chunks of 256, the second padded): output and final state
    against the host's fp32 run, and against 300 recurrent steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    cfg = get_config(arch)
    p = ssm.init_mamba(cfg, gen, "cuda")
    x = torch.randn((1, 300, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        y, state = ssm.apply_mamba(p, cfg, x, return_state=True)
        cache = ssm.init_mamba_cache(cfg, 1, device="cuda")
        for t in range(x.shape[1]):
            _, cache = ssm.apply_mamba_step(p, cfg, x[:, t:t + 1], cache)
        hy, hstate = ssm.apply_mamba({k: v.float().cpu() for k, v in
                                      p.items()}, cfg, x.float().cpu(),
                                     return_state=True)
    diff = y.float().cpu() - hy
    got = {
        "out_rms": (diff.pow(2).mean().sqrt()
                    / hy.pow(2).mean().sqrt()).item(),
        "out_max": (diff.abs().max() / hy.abs().max()).item(),
        "state_host": ((state.cpu() - hstate).abs().max()
                       / hstate.abs().max()).item(),
        "state_steps": ((state - cache["ssm"]).abs().max()
                        / state.abs().max()).item(),
    }
    assert all(got[k] <= bound for k, bound in SSM_BOUNDS.items()), got


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_captured_ssm_step_equals_an_eager_step_on_the_card(arch, gen):
    """The smoke model on the paged engine (its step captured in
    ``load()``): a replay over 3 active lanes of 4 equals an eager
    ``decode_step_paged`` on the same pools bitwise, logits and every
    pool (the conv and SSM states written in place, inactive lanes
    advanced too), and two replays of the same inputs give the same
    bits; the drain's tokens equal the slot engine's at 4 lanes."""
    from repro_torch.models import hybrid
    from repro_torch.serve import make_engine

    eng = _paged_engine(arch)
    assert eng.stats["decode_compiles"] == 1
    prompts = _prompts(eng.cfg.vocab, (5, 9, 13, 6, 11), seed=7)
    for p in prompts[:3]:
        eng.submit(p, max_new_tokens=8)
    eng.step()
    eng.step()
    active = [i for i, r in enumerate(eng.lanes) if r is not None]
    assert len(active) == 3
    ptrs = {k: v.data_ptr() for k, v in eng.kv.pools.items()}
    before = {k: v.clone() for k, v in eng.kv.pools.items()}
    nxt = eng._decode(active)
    replay = eng._decode_out[0].clone()
    replayed = {k: v.clone() for k, v in eng.kv.pools.items()}
    assert any(not torch.equal(replayed[k], before[k]) for k in ("conv",
                                                                  "ssm"))
    for k, v in eng.kv.pools.items():
        v.copy_(before[k])
    eng._decode(active)
    assert torch.equal(eng._decode_out[0], replay)
    for k, v in eng.kv.pools.items():
        v.copy_(before[k])
    tokens = torch.tensor([[eng.lanes[i].output[-1] if i in active else 0]
                           for i in range(eng.max_lanes)],
                          dtype=torch.int32, device="cuda")
    with torch.no_grad(), planned.override(policy=eng.policy):
        logits, _ = hybrid.decode_step_paged(
            eng.params, eng.cfg, eng.kv.pools, tokens,
            torch.as_tensor(eng.kv.tables, device="cuda"),
            torch.as_tensor(eng.kv.pos, device="cuda"),
            torch.as_tensor(eng.kv.active, device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(logits, replay)
    for k in replayed:
        assert torch.equal(eng.kv.pools[k], replayed[k]), k
    assert [nxt[i] for i in active] == logits.argmax(-1)[active].tolist()
    assert {k: v.data_ptr() for k, v in eng.kv.pools.items()} == ptrs
    # a fresh engine of each kind over all five prompts: equal tokens
    paged = _paged_engine(arch)
    slot = make_engine(eng.cfg, kind="slot", max_slots=4, max_seq=64)
    slot.load(paged.params)
    outs = []
    for other in (paged, slot):
        for p in prompts:
            other.submit(p, max_new_tokens=8)
        outs.append({r.rid: list(r.output)
                     for r in other.run_until_drained()})
    assert outs[0] == outs[1]
    assert paged.stats["decode_compiles"] == 1


#: zamba2-1.2b's shared block at full width (d 2048, ff 8192, 32 heads of
#: 64), new B1 shapes: its MLP at a 4-lane decode step and at prompts of
#: 64, 300 and 512 tokens, its q/k/v/out projections at decode
ZAMBA2_SHAPES = ((4, 8192, 2048), (4, 2048, 8192), (4, 2048, 2048),
                 (64, 8192, 2048), (300, 8192, 2048), (512, 8192, 2048))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ZAMBA2_SHAPES, ids=str)
def test_zamba2_shared_block_gemms_match_the_plain_version_on_the_card(
        shape, gen):
    """Through the planned facade in bf16 on the kernel the runtime picks
    (the skinny kernel at 4 rows, the tensor-core kernel above), within
    one bf16 step of the plain version."""
    m, n, k = shape
    x = _gemm_draw((m, k), torch.bfloat16, gen)
    w = _gemm_draw((k, n), torch.bfloat16, gen)
    before = dict(widesa_mm.variants)
    got = planned.planned_dense(x, w, site="mlp.gate")
    _same_gemm(got, ref.mm(x, w))
    torch.cuda.synchronize()
    kernel = "skinny" if m <= runtime.SKINNY_ROWS else "wgmma"
    assert {v: widesa_mm.variants[v] - before[v] for v in before} == {
        "skinny": 0, "wgmma": 0, "wgmma_cp": 0, "tiled": 0, kernel: 1}


# ---------------------------------------------------------------------------
# training: the facade's backward passes on the card
# ---------------------------------------------------------------------------

#: (kind, operand shapes, keyword arguments, dtype) of the facade
#: Functions held on the card: an mm, the fp32-flushed scores' bmm (each
#: in float32 and bf16), the gelu MLP pair (float32: its bf16 chain
#: rounds four times, which no one-rounding bound holds)
_MM = ((96, 256), (256, 320))
_BMM = ((8, 96, 64), (8, 64, 96))
BACKWARD_CASES = (
    ("mm", _MM, {}, torch.float32),
    ("mm", _MM, {}, torch.bfloat16),
    ("bmm", _BMM, {"out_dtype": torch.float32}, torch.float32),
    ("bmm", _BMM, {"out_dtype": torch.float32}, torch.bfloat16),
    ("pair", ((96, 256), (256, 512), (512,), (512, 256)), {"act": "gelu"},
     torch.float32),
)


def _backward(kind, args, kw, cot):
    fn = {"mm": planned.planned_dense, "bmm": planned.planned_bmm,
          "pair": planned.planned_mlp_pair}[kind]
    live = [a.detach().requires_grad_() for a in args]
    out = fn(*live, **kw)
    return out, torch.autograd.grad((out.float() * cot).sum(), live)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shapes,kw,dtype", BACKWARD_CASES,
                         ids=[f"{c[0]}-{str(c[3])[6:]}"
                              for c in BACKWARD_CASES])
def test_planned_backward_runs_on_the_hand_kernels(kind, shapes, kw, dtype,
                                                   gen):
    """The backward of a planned mm, bmm and MLP pair launches the GEMM
    kernels (every ``/bwd_*`` site planned) and its gradients match the
    plain versions' under ``configure(enabled=False)``: float32 within
    1e-3, bf16 one rounding of the gradient plus 1e-3."""
    scale = [1.0] + [s[-2] ** -0.5 if len(s) > 1 else 0.1
                     for s in shapes[1:]]
    args = [(torch.randn(s, generator=gen, device="cuda") * c).to(dtype)
            for s, c in zip(shapes, scale)]
    planned.reset_configuration()
    planned.planned_report_clear()
    out, _ = _backward(kind, args, kw, 1.0)
    cot = torch.randn(out.shape, generator=gen, device="cuda")
    before = widesa_mm.launches + bmm.launches
    out, grads = _backward(kind, args, kw, cot)
    torch.cuda.synchronize()
    assert widesa_mm.launches + bmm.launches - before >= 3
    report = planned.planned_report()
    assert any("/bwd_" in site for site in report)
    assert all(st["planned"] and not st["fallback"]
               for st in report.values())
    if kind == "bmm" and dtype == torch.bfloat16:
        # the fp32 scores' cotangent enters both products in bf16, as the
        # reference's custom_vjp casts it; plain autograd would keep fp32
        a, b = args
        g = cot.to(dtype)
        want = (ref.bmm(g, b.transpose(1, 2)),
                ref.bmm(a.transpose(1, 2), g))
    else:
        with planned.override(enabled=False):
            _, want = _backward(kind, args, kw, cot)
    for g, w in zip(grads, want):
        diff = (g.double() - w.double()).abs()
        if dtype == torch.float32:
            assert diff.max().item() <= 1e-3
        else:
            assert (diff <= 2.0 ** -7 * w.double().abs() + 1e-3).all()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4096, 32768])
def test_long_k_bf16_gemm_is_one_rounding_of_the_fp32_sum(k, gen):
    """Past ``runtime.TC_PROMOTE_K`` a bf16 -> bf16 product on the
    tensor-core kernel is its fp32 instantiation's result rounded once:
    within one bf16 rounding of the plain version at K = 32768, where
    the tensor cores' own accumulator strayed past it."""
    a = torch.randn((256, k), generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn((k, 256), generator=gen, device="cuda").to(torch.bfloat16)
    plan = planned.plan_for("mm", (256, 256, k), "bfloat16")
    tiles = registry.get("mm").tiles(plan, a, b)
    assert isinstance(tiles.tile, runtime.TcTile)
    assert runtime.tc_promotes(tiles.tile, a.dtype, a.dtype, k) == (
        k > runtime.TC_PROMOTE_K)
    out = widesa_mm.matmul(a, b, tiles=tiles.tile)
    want = ref.mm(a, b)
    assert out.dtype == torch.bfloat16
    diff = (out.double() - want.double()).abs()
    assert (diff <= 2.0 ** -7 * want.double().abs() + 1e-3).all()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-base"])
def test_smoke_train_step_gradients_match_the_plain_versions(arch, gen):
    """A SMOKE-width float32 loss and its gradients on the card: on the
    kernels (3xTF32) and under ``configure(enabled=False)`` within 1e-3
    relative (L2) per leaf (whisper's key biases, whose exact gradient is
    0, at most 1e-6 of the whole gradient's norm on either path); then
    one AdamW step moves every leaf."""
    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig
    from repro_torch.train.loop import batch_tensors
    from repro_torch.train.step import make_train_step, value_and_grad

    cfg = get_smoke_config(arch)
    api = build_model(cfg, "cuda")
    params = api.init(gen)
    batch = batch_tensors(SyntheticPipeline(
        cfg, ShapeSpec("t", "train", 32, 4)).batch(0), "cuda")
    planned.reset_configuration()
    loss, grads = value_and_grad(api.loss, params, batch)
    with planned.override(enabled=False):
        loss_p, grads_p = value_and_grad(api.loss, params, batch)
    assert abs(float(loss) - float(loss_p)) <= 1e-3 * abs(float(loss_p))
    total = torch.stack([w.norm() for w in tree.leaves(grads_p)]).norm()
    errs = {}
    for path, g, w in zip(tree.paths(grads), tree.leaves(grads),
                          tree.leaves(grads_p)):
        if not cfg.use_rope and path.endswith("attn/bk"):
            # exactly 0 without rotary: the softmax cancels a key bias
            assert max(g.norm(), w.norm()) <= 1e-6 * total, path
        else:
            errs[path] = float((g - w).norm() / w.norm().clamp(min=1e-30))
    assert max(errs.values()) <= 1e-3, sorted(
        errs.items(), key=lambda kv: -kv[1])[:8]
    step = make_train_step(api, cfg, tcfg=TrainConfig(warmup=0))
    new, _, metrics = step(params, adamw_init(params), batch, 1)
    assert torch.isfinite(metrics["loss"])
    assert all(not torch.equal(a, b) for a, b in zip(tree.leaves(new),
                                                     tree.leaves(params)))


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_blockwise_backward_matches_the_host_on_the_card(remat, gen):
    """A 2-layer SMOKE qwen over one 2112-token sequence (blockwise
    attention, above 2048 rows) in float32: the loss and every gradient
    leaf on the card's kernels within 1e-3 relative (L2) of the same step
    on the host, under ``remat`` "full" and "dots"."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import build_model
    from repro_torch.train.loop import batch_tensors
    from repro_torch.train.step import value_and_grad

    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), remat=remat)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    batch = SyntheticPipeline(cfg, ShapeSpec("t", "train", 2112, 1)).batch(0)
    planned.reset_configuration()
    runs = {}
    for device in ("cpu", "cuda"):
        on = tree.tree_map(lambda t: t.to(device), params)
        runs[device] = value_and_grad(build_model(cfg, device).loss, on,
                                      batch_tensors(batch, device))
    (loss, grads), (loss_c, grads_c) = runs["cpu"], runs["cuda"]
    assert abs(float(loss_c) - float(loss)) <= 1e-3 * abs(float(loss))
    for path, g, w in zip(tree.paths(grads_c), tree.leaves(grads_c),
                          tree.leaves(grads)):
        g = g.cpu().double()
        assert torch.isfinite(g).all(), path
        err = float((g - w.double()).norm() / w.double().norm())
        assert err <= 1e-3, (path, err)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mm", "fir", "jacobi2d_ms", "mttkrp"])
def test_measured_race_times_both_backends_on_the_card(name, gen,
                                                       tmp_path):
    """``measured`` mode on the card: the spec's smoke proxy raced with
    CUDA events, ``pallas`` on the hand kernel (its launches counted) and
    ``xla`` on the plain version; the winner the least of its timings,
    persisted, and served back under ``cached`` without a new race."""
    from repro_torch.core import Target, autotune, best_plan

    spec = registry.get(name)
    rec = spec.builder(*spec.smoke_args, spec.parity_dtypes[0])
    path = tmp_path / "t.json"
    autotune.save_table(path, autotune.new_table())
    target = Target(name="t", mesh_shape=(1, 8))
    wrapper = {"mm": widesa_mm, "fir": fir, "jacobi2d_ms": jacobi2d,
               "mttkrp": mttkrp}[name]
    launches = wrapper.launches
    plan = best_plan(rec, target, policy=autotune.PlanPolicy(
        mode="measured", table_path=str(path), reps=3, warmup=1))
    assert wrapper.launches > launches
    entry = autotune.load_table(path)["entries"][
        autotune.autotune_key(rec, (1, 8))]
    assert set(entry["us"]) == {"pallas", "xla"}
    assert entry["backend"] == min(entry["us"], key=entry["us"].get)
    assert (plan.backend, plan.provenance) == (entry["backend"], "measured")
    calls = autotune.counters()["measure_calls"]
    again = best_plan(rec, target, policy=autotune.PlanPolicy(
        mode="cached", table_path=str(path)))
    assert (again.backend, again.provenance) == (plan.backend, "measured")
    assert autotune.counters()["measure_calls"] == calls


# -- B read at a pitch, and hierarchical plans ------------------------------

#: every GEMM kernel: (rows of A that route to it, the tiled kernel's tile
#: for a row-major and a column-major B, or None where the runtime picks)
PITCH_KERNELS = {"skinny": (4, None), "wgmma": (64, None),
                 "tiled": (64, ((16, 32, 32), (16, 32, 8)))}
GEMM_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int16,
               torch.int32)


def _pitched(kind, m, split, dtype, gen):
    """Operands of group 1 of a tp = 2 split of [m, 256] @ [256, 256] (bmm:
    3 of them), as a hierarchical plan hands them to the kernels: a column
    split's B the right half of a row-major B (rows 256 apart, batch
    entries 256 x 256 apart); a row split's A the right half of A's rows
    and its B the lower half of a column-major B (the tied lm_head's
    ``embed.T``: columns 256 apart)."""
    lead = (3,) if kind == "bmm" else ()
    a = _draw((*lead, m, 256), dtype, gen).to(dtype)
    b = _draw((*lead, 256, 256), dtype, gen).to(dtype)
    if split == "column":
        return a, b[..., 128:]
    return a[..., 128:], b.transpose(-1, -2)[..., 128:, :]


def _dense_copy(b):
    """A contiguous copy of B in its own orientation (``runtime.b_layout``):
    row-major, or the transpose of a contiguous tensor."""
    if runtime.b_layout(b)[0]:
        return b.transpose(-1, -2).contiguous().transpose(-1, -2)
    return b.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mm", "bmm"])
@pytest.mark.parametrize("split", ["column", "row"])
@pytest.mark.parametrize("kernel", list(PITCH_KERNELS))
@pytest.mark.parametrize("dtype", GEMM_DTYPES, ids=str)
def test_pitched_b_equals_contiguous_copies_on_the_card(kind, split, kernel,
                                                        dtype, gen):
    """Each GEMM kernel reads a B slice (and a row split's A slice) in
    place, bit for bit as the same launch over contiguous copies."""
    m, tiled = PITCH_KERNELS[kernel]
    a, b = _pitched(kind, m, split, dtype, gen)
    col, pitch, _ = runtime.b_layout(b)
    assert (col, pitch) == ((0, 256) if split == "column" else (1, 256))
    assert not b.is_contiguous() and not b.transpose(-1, -2).is_contiguous()
    if tiled:
        tiles = tiled[col]
    else:
        tiles = runtime.gemm_tile(a, b, (16, 32, 32))
        assert isinstance(tiles, runtime.SkinnyTile if kernel == "skinny"
                          else runtime.TcTile), tiles
    fn = bmm.bmm if kind == "bmm" else widesa_mm.matmul
    wrapper = bmm if kind == "bmm" else widesa_mm
    before = dict(wrapper.variants)
    got = fn(a, b, tiles=tiles)
    assert wrapper.variants[kernel] == before[kernel] + 1
    want = fn(a.contiguous(), _dense_copy(b), tiles=tiles)
    assert torch.equal(got, want)
    plain = (ref.bmm if kind == "bmm" else ref.mm)(a, b)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), plain.float(), rtol=2**-7,
                                   atol=1e-3)
    else:
        _same(got, plain)


@pytest.mark.gpu
def test_b_the_kernels_cannot_read_raises_on_the_card(gen):
    """A B with neither unit stride raises before any launch: no copy is
    made in the wrapper."""
    a = _draw((4, 64), torch.bfloat16, gen)
    b = _draw((64, 128), torch.bfloat16, gen)[:, ::2]
    assert runtime.b_layout(b) is None
    with pytest.raises(ValueError, match="B must be"):
        widesa_mm.matmul(a, b, tiles=(4, 32, 32))


#: (kind, builder args, dtype, outer shape, split): every split at a small
#: size, and qwen1.5-0.5b's full-width serving GEMMs under the serving
#: target
HIER_CASES = (
    ("mm", (128, 128, 128), "int16", (2, 2), "column"),
    ("mm", (128, 127, 128), "int32", (2, 2), "row"),
    ("mm", (24, 128, 64), "float32", (1, 2), "column"),
    ("bmm", (8, 12, 16, 12), "float32", (1, 2), "batch"),
    ("bmm", (2, 64, 64, 63), "int8", (2, 2), "column"),
    ("bmm", (2, 64, 63, 64), "float32", (2, 2), "row"),
    ("mm", (4, 151936, 1024), "bfloat16", (1, 2), "column"),
    ("mm", (4, 2816, 1024), "bfloat16", (1, 2), "column"),
    ("mm", (512, 1024, 2816), "bfloat16", (1, 2), "column"),
    ("mm", (4, 51865, 512), "bfloat16", (1, 2), "row"),
    ("bmm", (64, 1, 528, 64), "bfloat16", (1, 2), "batch"),
    ("jacobi2d", (510, 300), "float32", (2, 1), "halo"),
    ("jacobi2d_9pt", (508, 300), "int16", (1, 2), "halo"),
)


@pytest.mark.gpu
@pytest.mark.parametrize("case", HIER_CASES,
                         ids=[f"{c[0]}{c[1]}-{c[2]}-{c[4]}"
                              for c in HIER_CASES])
def test_hierarchical_plan_runs_its_groups_on_the_kernels_on_the_card(
        case, gen):
    """``lower_hierarchical(plan, "pallas")`` on the card: one hand-kernel
    launch a group, the result the plain version's (integers exact, float32
    1e-3, bf16 one rounding + 1e-3)."""
    from repro_torch.core import HierarchicalTarget, Target, best_plan
    from repro_torch.core import lower_plan

    kind, args, dname, outer, split = case
    dtype = getattr(torch, dname)
    ht = HierarchicalTarget(outer_shape=outer,
                            inner=Target(name="planned_chip",
                                         mesh_shape=(1, 8)))
    rec = registry.get(kind).builder(*args, dname)
    plan = best_plan(rec, ht)
    assert plan.outer_split == split
    ops = [_draw(s, dtype, gen).to(dtype)
           for s in registry.get(kind).operand_shapes(rec)]
    if kind == "mm" and args[1] % 2:
        # an odd N: B as the tied lm_head reads it, the transpose of the
        # [N, K] embedding table
        ops[1] = ops[1].T.contiguous().T
    wrapper = {"mm": widesa_mm, "bmm": bmm}.get(kind, jacobi2d)
    launches = wrapper.launches
    got = lower_plan(plan, "pallas")(*ops)
    torch.cuda.synchronize()
    assert wrapper.launches - launches == ht.groups
    want = registry.get(kind).ref(*ops)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7,
                                   atol=1e-3)
    else:
        _same(got, want)


@pytest.mark.gpu
def test_facade_under_the_serving_target_runs_two_level_on_the_card(gen):
    """``planned_dense`` under the serving hierarchical target: a two-level
    plan, two launches of the column split, no copy of the weight."""
    from repro_torch.core import SERVING_HIERARCHICAL_TARGET

    x = _draw((4, 1024), torch.bfloat16, gen).bfloat16()
    w = (_draw((1024, 2816), torch.bfloat16, gen) / 32).bfloat16()
    planned.planned_report_clear()
    launches = widesa_mm.launches
    with planned.override(target=SERVING_HIERARCHICAL_TARGET):
        got = planned.planned_dense(x, w, site="hier.card")
    torch.cuda.synchronize()
    assert widesa_mm.launches - launches == 2
    st = planned.planned_report()["hier.card"]
    assert st["planned"] == 1 and st["last_plan"].startswith(
        "[hier mm/bfloat16] outer 1x2 split=column")
    torch.testing.assert_close(got.float(), ref.mm(x, w).float(),
                               rtol=2**-7, atol=1e-3)
    planned.planned_report_clear()


#: one schedule of each family at small sizes: (spec, builder args, dtype,
#: backend), each on a logical 2 x 2 mesh of this card
SYSTOLIC_CASES = (
    ("mm", (256, 256, 256), "float32", "systolic"),          # Cannon
    ("bmm", (4, 128, 128, 64), "int16", "systolic"),
    ("fft2d_stage", (64, 64), "float32", "systolic"),        # two planes
    ("jacobi2d_ms", (62, 62, 3), "int16", "systolic"),       # halo
    ("jacobi2d_9pt", (64, 64), "float32", "systolic"),
    ("conv2d", (64, 61, 4, 4), "int8", "systolic"),          # chains
    ("fir", (1024, 15), "int16", "systolic"),
    ("mttkrp", (128, 64, 16, 8), "int8", "systolic"),        # ring
    ("mm", (256, 256, 256), "int8", "allgather"),            # baselines
    ("jacobi2d", (126, 126), "float32", "allgather"),
    ("fft2d_stage", (64, 64), "float32", "allgather"),
)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SYSTOLIC_CASES,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}" for c in SYSTOLIC_CASES])
def test_chip_level_schedule_on_a_logical_mesh_on_the_card(case, gen):
    """The spec's chip-level schedule on a logical 2 x 2 mesh whose four
    members are this card: every member's compute a launch of the hand
    kernel, the result the flat hand kernel's (integers exact, floats
    within the registry's atol)."""
    from repro_torch.core import Target, best_plan, lower_plan
    from repro_torch.parallel import mesh as pm

    kind, args, dname, backend = case
    spec = registry.get(kind)
    rec = spec.builder(*args, dname)
    dtype = getattr(torch, dname)
    ops = [_draw(s, dtype, gen).to(dtype) for s in spec.operand_shapes(rec)]
    flat = lower_plan(best_plan(rec, Target(mesh_shape=(1, 1))),
                      "pallas")(*ops)
    wrapper = {"mm": widesa_mm, "bmm": bmm, "fft2d_stage": widesa_mm,
               "conv2d": conv2d, "fir": fir, "mttkrp": mttkrp}.get(
                   kind, jacobi2d)
    if kind == "fft2d_stage" and backend == "allgather":
        wrapper = fft2d
    with pm.logical_devices(4):
        mesh = pm.make_mesh((2, 2), Target().mesh_axes)
        assert {str(d) for d in mesh.devices.flat} == {
            str(torch.device("cuda", 0))}
        plan = best_plan(rec, Target(mesh_shape=(2, 2)))
        launches = wrapper.launches
        got = lower_plan(plan, backend, mesh=mesh)(*ops)
        torch.cuda.synchronize()
    assert wrapper.launches - launches >= 4
    flats = flat if isinstance(flat, tuple) else (flat,)
    gots = got if isinstance(got, tuple) else (got,)
    for g, w in zip(gots, flats):
        assert g.dtype == w.dtype and g.shape == w.shape
        if dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=0, atol=spec.atol)
        else:
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the DFT planes are not kept (a transform past fft2d.DFT_CACHE_MAX_N)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_fft2d_at_8192_points_leaves_no_allocation_on_the_card(gen):
    """An 8192^2 fft2d_stage (the bench grid, on the FFT kernel) builds no
    DFT plane: past its twiddle tables (64 KB a side, cached at the first
    call), the card's allocation is back at its level before the call."""
    spec = registry.get("fft2d_stage")
    shape = spec.bench_cases[0][1]
    re_, im_ = (torch.randn(shape, generator=gen, device="cuda")
                for _ in range(2))
    tiles = runtime.fft2d_route(*shape)
    assert isinstance(tiles, runtime.FftTile)
    fft2d.fft2d(re_, im_, tiles=tiles)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    fft2d.fft2d(re_, im_, tiles=tiles)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == held
    assert shape[0] > fft2d.DFT_CACHE_MAX_N


# ---------------------------------------------------------------------------
# the mesh paths on logical meshes of the card (chip_smoke's mesh phase at a
# small size)
# ---------------------------------------------------------------------------

def _moe_smoke(arch, ep):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(arch)
    return dataclasses.replace(
        cfg, moe_ep=ep,
        moe_capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
@pytest.mark.parametrize("ep", [False, True], ids=["tp", "ep"])
def test_moe_mesh_path_runs_every_member_on_the_kernels(arch, ep, gen):
    """SMOKE float32 MoE block on a logical (2, 4) mesh of the card,
    nothing dropping: every member's expert stack three bmm launches, y
    within 1e-4 of one device's block on the kernels, and the gradients
    of sum(y * c) through the mesh path's copies and collectives within
    1e-4 of one device's (the router's aside: the per-shard aux)."""
    from repro_torch.models import moe
    from repro_torch.parallel import mesh as pm
    from repro_torch.parallel.sharding import mesh_context

    cfg = _moe_smoke(arch, ep)
    p = moe.init_moe(cfg, gen, "cuda")
    x = torch.randn(8, 4, cfg.d_model, generator=gen, device="cuda")
    c = torch.randn(8, 4, cfg.d_model, generator=gen, device="cuda")

    def grads(mesh):
        live = {k: v.clone().requires_grad_() for k, v in p.items()}
        ctx = mesh_context(mesh) if mesh is not None else None
        if ctx is not None:
            with ctx:
                y = moe.apply_moe(live, cfg, x)
        else:
            y = moe.apply_moe(live, cfg, x)
        (y * c).sum().backward()
        return y.detach(), {k: v.grad for k, v in live.items()}

    y1, g1 = grads(None)
    with pm.logical_devices(8):
        mesh = pm.make_mesh((2, 4), ("data", "model"))
        before = bmm.launches
        ym, gm = grads(mesh)
        torch.cuda.synchronize()
    # forward 3 a member, backward 6 (two products each) a member
    assert bmm.launches - before >= 8 * 3
    torch.testing.assert_close(ym, y1, rtol=0, atol=1e-4)
    for k in ("wg", "wu", "wd"):
        torch.testing.assert_close(gm[k], g1[k], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_ep_decode_of_one_token_raises_on_the_card(gen):
    from repro_torch.models import moe
    from repro_torch.parallel import mesh as pm
    from repro_torch.parallel.sharding import mesh_context

    cfg = _moe_smoke("deepseek-v2-236b", True)
    p = moe.init_moe(cfg, gen, "cuda")
    x = torch.randn(4, 1, cfg.d_model, generator=gen, device="cuda")
    with pm.logical_devices(4), mesh_context(
            pm.make_mesh((1, 4), ("data", "model"))):
        with pytest.raises(ValueError, match="does not divide"):
            moe.apply_moe(p, cfg, x)


@pytest.mark.gpu
def test_elastic_training_on_a_logical_mesh_of_the_card(gen, tmp_path):
    """qwen's SMOKE config: 3 steps on the 4 x 2 mesh of 8 logical
    devices, a resume on the 2 x 2 survivors for 2 more, bit for bit the
    losses of the same run on the card alone."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.parallel import mesh as pm
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_smoke_config("qwen1.5-0.5b")
    shape = ShapeSpec("t", "train", 32, 8)
    tc = TrainConfig(ckpt_every=100, log_every=100, total_steps=5)

    def run(d, meshes):
        hist = []
        for mesh, steps, resume in zip(meshes, (3, 2), (False, True)):
            hist += Trainer(cfg, shape, ckpt_dir=str(d), tcfg=tc,
                            mesh=mesh).run(steps, resume=resume)[2]
        return hist

    with pm.logical_devices(8):
        devs = pm.devices()
        before = widesa_mm.launches
        on_mesh = run(tmp_path / "mesh", (
            make_mesh_from_devices(devs, model_parallel=2),
            make_mesh_from_devices(devs[:4], model_parallel=2)))
        assert widesa_mm.launches > before
    assert on_mesh == run(tmp_path / "one", (None, None))


@pytest.mark.gpu
@pytest.mark.parametrize("dname", ["bfloat16", "float32", "int8"])
def test_ring_reduce_scatter_matmul_on_the_card(dname, gen):
    """Over 8 members: each member's partial one B1 launch in the
    accumulator dtype; floats within 1e-3 of the flat hand kernel's fp32
    product, int8 (operands in [120, 128), k = 2048) bitwise the int64
    product; the bytes moved the ring's model."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import mesh as pm
    from repro_torch.parallel.mesh import P

    m, n, k = 256, 128, 2048
    dtype = getattr(torch, dname)
    if dtype.is_floating_point:
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        w = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
        want = ref.mm(x, w, torch.float32)
    else:
        x, w = (torch.randint(120, 128, s, generator=gen, device="cuda",
                              dtype=torch.int8) for s in ((m, k), (k, n)))
        want = (x.double() @ w.double()).to(torch.int32)
    with pm.logical_devices(8):
        mesh = pm.make_mesh((8,), ("tp",))
        pm.moved_clear()
        before = widesa_mm.launches
        out = C.ring_reduce_scatter_matmul(
            mesh, pm.shard(mesh, x, P(None, "tp")),
            pm.shard(mesh, w, P("tp", None)), "tp")
        got = pm.unshard(mesh, out, P("tp", None), x.device)
        torch.cuda.synchronize()
        assert widesa_mm.launches - before == 8
        assert pm.moved["ppermute"] == C.ring_reduce_scatter_bytes(
            m // 8 * n * 4, 8)
    if dtype.is_floating_point:
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    else:
        assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
def test_quantized_psum_on_the_card(gen):
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import mesh as pm
    from repro_torch.parallel.mesh import P

    g = torch.randn(8, 4096, generator=gen, device="cuda") * 3
    with pm.logical_devices(8):
        mesh = pm.make_mesh((8,), ("dp",))
        out = C.quantized_psum(mesh, pm.shard(mesh, g, P("dp", None)), "dp",
                               torch.Generator(device="cuda").manual_seed(1))
        got = pm.unshard(mesh, out, P("dp", None), g.device)
    scale = g.abs().max().item() / 127.0
    assert (got - g.sum(0)).abs().max().item() < 8 * scale
    assert (got == got[0]).all()


@pytest.mark.gpu
def test_pipeline_apply_of_decoder_layers_on_the_card(gen):
    """qwen's SMOKE decoder layers (a 4-layer variant) over 2 stages and 2
    microbatches of the card: bitwise the fold of the same microbatches,
    every stage's GEMMs on the hand kernels."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as TT
    from repro_torch.parallel import mesh as pm
    from repro_torch.parallel.pipeline import pipeline_apply

    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"), n_layers=4)
    p = TT.init_params(cfg, gen, "cuda")
    x = torch.randn(4, 16, cfg.d_model, generator=gen, device="cuda")

    def block(lp, h):
        return TT._block(lp, cfg, h, TT._positions(h))[0]

    with torch.no_grad():
        want = []
        for mb in x.chunk(2):
            for lp in p["layers"]:
                mb = block(lp, mb)
            want.append(mb)
        with pm.logical_devices(2):
            before = widesa_mm.launches
            got = pipeline_apply(block, p["layers"], x,
                                 mesh=pm.make_mesh((2,), ("pipe",)),
                                 microbatches=2)
            assert widesa_mm.launches > before
    assert torch.equal(got, torch.cat(want))
