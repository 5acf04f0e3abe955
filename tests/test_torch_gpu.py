"""The port's GEMM (the skinny and tensor-core kernels), FIR, conv2d,
fft2d, star-stencil and MTTKRP kernels against their plain versions on the
card.

Every test here is ``gpu``-marked and skips without a CUDA card.  The file
imports only the port (no JAX), so it runs on a machine with a card and
PyTorch alone; like ``chip_smoke.py`` it puts the repository's ``src/`` on
the import path itself, so either start line works from the root:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Integers are bit-exact (int32 wraparound); float32 within the registry's
atol 1e-3 (FIR, conv2d, the stencils: sums of at most 20 products in
another order; MTTKRP: sums of at most 4096 products of three N(0, 1)
draws, in fp32 or as 3xTF32 on the tensor cores; the GEMMs: sums of at
most 11004 products of N(0, 1) draws, 3xTF32 on the tensor-core kernel
at up to 1024; the rounding error of either is ~1e-4) and 1.0 (fft2d,
the fused kernel and the composition: sums of up to 1024 terms of
magnitude ~100); bf16 results within one bf16 rounding step of the
output, ``2^-7 |ref|``, plus 1e-3.
"""

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
    grid, the composition at 96 rows; each launch counted under its form,
    and a fused launch the kernel does not take raises."""
    from repro_torch.core import Target, best_plan, lower_plan

    chip = Target(name="single_chip", mesh_shape=(1, 1))
    spec = registry.get("fft2d_stage")
    for shape, form in (((64, 64), "fused"), ((96, 64), "composition")):
        rec = spec.builder(*shape, "float32")
        ops = registry.operands(rec, gen, "cuda")
        before = dict(fft2d.variants)
        got = lower_plan(best_plan(rec, chip), "pallas")(*ops)
        for g, w in zip(got, spec.ref(*ops)):
            torch.testing.assert_close(g, w, rtol=0, atol=1.0)
        torch.cuda.synchronize()
        assert {k: fft2d.variants[k] - before[k] for k in before} == {
            "fused": form == "fused", "composition": form == "composition"}
        assert isinstance(runtime.last_tiles["fft2d_stage"].tile,
                          runtime.Fft2dTile) == (form == "fused")
    re_, im_ = (torch.randn((12, 515), generator=gen, device="cuda")
                for _ in range(2))
    for split in (0, 9):  # no cluster, and past the portable 8
        with pytest.raises(ValueError, match="not a fused fft2d launch"):
            fft2d.fft2d(re_, im_, tiles=runtime.Fft2dTile(split=split))


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


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["jacobi2d", "jacobi2d_9pt", "jacobi2d_ms"])
def test_star_stencils_match_plain_versions_on_the_card(name, gen):
    """Full-range integers wrap; jacobi2d_ms runs 3 sweeps on the promoted
    int32 state, and an int32 grid takes int8 weights as a halo chain's
    consumer does."""
    fn, plain = getattr(jacobi2d, name), getattr(ref, name)
    n_points = 9 if name == "jacobi2d_9pt" else 5
    before = jacobi2d.launches
    launched = 0
    for shape in STENCIL_GRIDS:
        for dtype in DTYPES:
            grid = _draw(shape, dtype, gen)
            weights = _draw((3, n_points) if name == "jacobi2d_ms"
                            else (n_points,), dtype, gen)
            _same(fn(grid, weights, tiles=build.STENCIL_TILE),
                  plain(grid, weights))
            launched += 3 if name == "jacobi2d_ms" else 1
        grid = _draw(shape, torch.int32, gen)
        weights = _draw((n_points,), torch.int8, gen)
        if name != "jacobi2d_ms":
            _same(fn(grid, weights, tiles=build.STENCIL_TILE),
                  plain(grid, weights))
            launched += 1
    torch.cuda.synchronize()
    assert jacobi2d.launches - before == launched


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
            assert runtime.last_tiles[name].tile == build.STENCIL_TILE


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
    """A B one element off its 16-byte boundary (2-byte aligned rows) is
    not a skinny operand: the runtime gives the tiled tile, and the launch
    counts as tiled."""
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
        assert moved == {"skinny": 0, "wgmma": want[kind], "tiled": 0}


#: every compiled tensor-core tile, by input dtype
TC_COMPILED = [(dtype, tile) for dtype, tiles in runtime.TC_TILES.items()
               for tile in tiles]


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
    """Above 16 rows: a B one element off its 16-byte boundary, rows of an
    odd number of bf16 elements and integer operands take the tiled tile,
    and a tensor-core launch on the misaligned B raises."""
    cases = []
    a = _gemm_draw((64, 64), torch.bfloat16, gen)
    cases.append((a, _gemm_draw((64 * 130 + 1,), torch.bfloat16,
                                gen)[1:].view(64, 130)))
    cases.append((_gemm_draw((64, 63), torch.bfloat16, gen),
                  _gemm_draw((63, 128), torch.bfloat16, gen)))
    cases.append((_gemm_draw((64, 64), torch.int8, gen),
                  _gemm_draw((64, 128), torch.int8, gen)))
    for a, b in cases:
        tile = runtime.gemm_tile(a, b, (64, 32, 32))
        assert tile == (64, 32, 32)
        before = dict(widesa_mm.variants)
        _same_gemm(widesa_mm.matmul(a, b, tiles=tile), ref.mm(a, b))
        torch.cuda.synchronize()
        assert widesa_mm.variants["tiled"] == before["tiled"] + 1
        assert widesa_mm.variants["wgmma"] == before["wgmma"]
    a, b = cases[0]
    with pytest.raises(ValueError, match="TMA"):
        widesa_mm.matmul(a, b, tiles=runtime.tc_tile(64, 130, 64,
                                                     torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", GEMM_DTYPES, ids=str)
def test_padded_a_rows_match_plain_versions_on_the_card(dtype, gen):
    """A in rows padded to whole 16-byte units (the attention values'
    softmax weights at an odd key count, K = 127): the skinny kernel at 12
    rows; at 127 rows the tensor-core kernel in bf16 and float32, the
    tiled one for the integers; mm and bmm, each launch counted as
    routed."""
    k, unit = 127, 16 // dtype.itemsize
    for m in (12, 127):
        rows = _gemm_draw((3, m, -(-k // unit) * unit), dtype, gen)
        if dtype.is_floating_point:  # padding no kernel may read
            rows[..., k:] = float("nan")
        a = rows[..., :k]
        b = _gemm_draw((3, k, 64), dtype, gen)
        for fn, plain, x, y in ((bmm.bmm, ref.bmm, a, b),
                                (widesa_mm.matmul, ref.mm, a[1], b[1])):
            assert runtime.a_pitch(x) == -(-k // unit) * unit
            tile = runtime.gemm_tile(x, y, (64, 32, 32))
            kernel = ("skinny" if m <= 16 else
                      "wgmma" if dtype.is_floating_point else "tiled")
            assert isinstance(tile, {"skinny": runtime.SkinnyTile,
                                     "wgmma": runtime.TcTile,
                                     "tiled": tuple}[kernel])
            mod = bmm if fn is bmm.bmm else widesa_mm
            before = mod.variants[kernel]
            _same_gemm(fn(x, y, tiles=tile), plain(x, y))
            assert mod.variants[kernel] == before + 1
    torch.cuda.synchronize()
