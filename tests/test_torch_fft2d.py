"""The fft2d kernels' routes, operands and arithmetic, on the CPU.

* ``runtime.fft2d_route`` / ``fft2d_tile`` (their constants are the CUDA
  sources'): grids of at most ``FFT2D_MAX_ROWS`` rows whose passes fit
  in shared memory run the fused kernel (``runtime.Fft2dTile``), K split
  over a cluster as far as the grid stays within ``FFT2D_MAX_BLOCKS``
  blocks; taller grids whose sides are powers of two up to
  ``FFT_MAX_SIDE`` run the FFT kernel (``runtime.FftTile``); the rest run
  the composition over the mm kernels at the plan's tiled tile.
* The DFT planes the fused kernel reads: rows padded to whole 16-byte
  units, equal element for element to the JAX package's ``dft_matrix``
  and symmetric (zeros in the padding).
* The fused kernel's arithmetic, emulated in float32 torch: each rank of
  the split forms Y = F_R X for its columns k in the three-product form,
  then each of its 8 warps sums Y F_C over every 8th k in order (operand
  sums formed on load), the warps' sums added in warp order, and the
  ranks' partial tiles in rank order.  Held to the JAX
  package's ``repro.kernels.fft2d.fft2d`` (Pallas, interpret mode) on the
  same numpy operands within 1e-3 (fp32 sums of at most 48 terms of
  magnitude ~30; the registry's atol is 1.0).
* The FFT kernel's plain version (``fft2d.fft_plain``: its radix plans,
  twiddle tables and rounding, stage by stage) against the JAX package's
  ``fft2d`` in interpret mode (``repro.kernels.ops.fft2d``, as
  ``tests/test_kernels.py`` runs it, atol 0.5, rtol 1e-3), its oracle
  ``repro.kernels.ref.fft2d`` and numpy's float64 ``fft2`` (rms error at
  most 1e-5 of the output's rms, the max within the registry's atol);
  its tile's rules (``fft_config``, ``fft_allows``) and twiddle tables.
* On the CPU ``fft2d.fft2d`` runs the composition over ``ref.mm`` whatever
  the tile, and counts no launch.

The kernels themselves run only on the card: ``tests/test_torch_gpu.py``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import fft2d as jax_fft2d  # noqa: E402
from repro_torch.kernels import build, fft2d, planned, ref, registry, runtime  # noqa: E402


@pytest.mark.parametrize("shape,split", [
    ((12, 515), 6),    # whisper-base's frontend tile: 17 column tiles x 6
    ((16, 1024), 3),
    ((64, 64), 8),     # the pipeline's fft2d_stage smoke case: 8 tiles x 8
    ((12, 67), 8),
    ((1, 7), 1),       # too few k to split
    ((8, 16), 2),      # 8 k a rank at the least
    ((64, 8192), 1),   # 1024 tiles: no split
], ids=str)
def test_fused_route_and_split(shape, split):
    """The largest split of at most 8 that keeps the grid within
    ``FFT2D_MAX_BLOCKS`` blocks and every rank at 8 k or more."""
    assert runtime.fft2d_route(*shape) == runtime.Fft2dTile(split=split)
    tiles = -(-shape[0] // 16) * -(-shape[1] // 32)

    def fits(s):
        return tiles * s <= runtime.FFT2D_MAX_BLOCKS \
            and -(-shape[1] // s) >= runtime.FFT2D_MIN_RANK_K

    assert split == 1 or fits(split)
    assert not any(fits(s) for s in range(split + 1,
                                          runtime.FFT2D_MAX_CLUSTER + 1))


@pytest.mark.parametrize("shape,split,ok", [
    ((12, 515), 3, True), ((12, 515), 8, True), ((12, 515), 9, False),
    ((12, 515), 0, False), ((1, 7), 7, True), ((1, 7), 8, False),
    ((9, 9), 6, False),   # ranks of 2 k: the sixth would get none
    ((65, 64), 1, False),
], ids=str)
def test_fused_kernel_takes_splits_that_leave_no_rank_empty(shape, split,
                                                            ok):
    assert runtime.fft2d_allows(*shape, split) is ok


@pytest.mark.parametrize("shape,form", [
    ((65, 64), "composition"),
    ((128, 128), "fft"),
    ((8192, 8192), "fft"),   # the pipeline's two bench grids
    ((96, 96), "composition"),
], ids=str)
def test_taller_grids_take_the_composition(shape, form):
    """Above ``FFT2D_MAX_ROWS`` rows the registry's tiles name the FFT
    kernel's default ``FftTile`` where both sides are powers of two, and
    else the tiled tile the composition's products fall back to."""
    plan = planned.plan_for("fft2d_stage", shape, "float32")
    x = torch.zeros(shape)
    tiles = registry.get("fft2d_stage").tiles(plan, x, x)
    assert tiles.plan == runtime.hopper_tiles(plan).plan
    if form == "fft":
        assert runtime.fft2d_route(*shape) == runtime.fft_config(*shape)
        assert tiles.tile == runtime.fft_config(*shape)
    else:
        assert runtime.fft2d_route(*shape) is None
        assert tiles == runtime.hopper_tiles(plan)


def test_registry_tiles_name_the_fused_route():
    for shape in ((12, 515), (64, 64)):
        plan = planned.plan_for("fft2d_stage", shape, "float32")
        x = torch.zeros(shape)
        tiles = registry.get("fft2d_stage").tiles(plan, x, x)
        assert tiles.tile == runtime.fft2d_route(*shape)
        assert tiles.plan == runtime.hopper_tiles(plan).plan


def test_fused_geometry_matches_the_cuda_source():
    """runtime's FFT2D_* constants are the kernel's kFft* ones, and its
    shared-memory count the larger of the kernel's ``fft_pass_floats`` and
    the k groups' sums, then the tile a split's ranks send
    (``fft_smem_floats``)."""
    src = build.SP_SOURCE.read_text()
    k = {name: int(v) for name, v in
         re.findall(r"constexpr int kFft(\w+) = (\d+);", src)}
    assert runtime.FFT2D_TILE == (k["Rows"], k["Cols"])
    assert (runtime.FFT2D_CHUNK, runtime.FFT2D_MAX_ROWS,
            runtime.FFT2D_MAX_CLUSTER, runtime.FFT2D_MAX_SMEM) == (
        k["Chunk"], k["MaxRows"], k["MaxCluster"], k["MaxSmem"])
    assert runtime.FFT2D_K_GROUPS == k["Threads"] // k["Cols"]
    body = re.search(r"fft_pass_floats\(int nr, int kc\) \{\s*return (.*?);",
                     src, re.S).group(1)
    expr = " ".join(body.split()).replace("kFftCols", "32").replace(
        "kFftRows", "16")
    sums = runtime.FFT2D_K_GROUPS * 2 * 16 * 32
    for nr, kc in ((12, 68), (64, 128), (1, 4)):
        passes = eval(expr, {"nr": nr, "kc": kc})
        assert runtime.fft2d_smem(nr, kc) == 4 * (
            max(passes, sums) + 2 * 16 * 32 + runtime.FFT2D_MAX_CLUSTER)
    assert runtime.fft2d_smem(64, 128) <= runtime.FFT2D_MAX_SMEM


@pytest.mark.parametrize("n", [1, 7, 12, 64, 515])
def test_padded_dft_planes_equal_the_reference_and_are_symmetric(n):
    pitch = -(-n // 4) * 4
    for got, want in zip(fft2d._dft_planes(n, torch.device("cpu"), True),
                         jax_fft2d.dft_matrix(n)):
        assert got.shape == (n, pitch) and got.dtype == torch.float32
        assert got.data_ptr() % 16 == 0 and got.stride(0) * 4 % 16 == 0
        np.testing.assert_array_equal(got[:, :n].numpy(), want)
        assert torch.equal(got[:, :n], got[:, :n].T)
        assert not got[:, n:].any()


def _emulate_fused(x_re, x_im, split):
    """The fused kernel's float32 arithmetic (module docstring)."""
    r, c = x_re.shape
    fr_re, fr_im = (torch.from_numpy(m) for m in fft2d.dft_matrix(r))
    fc_re, fc_im = (torch.from_numpy(m) for m in fft2d.dft_matrix(c))
    kblk = -(-c // split)
    z_re = torch.zeros((r, c))
    z_im = torch.zeros((r, c))
    for rank in range(split):
        ks = range(rank * kblk, min(c, (rank + 1) * kblk))
        # stage 1 for the rank's columns k, summed over r in order
        k1 = torch.zeros((r, len(ks)))
        k2 = torch.zeros((r, len(ks)))
        k3 = torch.zeros((r, len(ks)))
        br, bi = x_re[:, ks.start:ks.stop], x_im[:, ks.start:ks.stop]
        for j in range(r):
            d, s = bi[j] - br[j], br[j] + bi[j]
            ar, ai = fr_re[:, j:j + 1], fr_im[:, j:j + 1]
            k1 = k1 + (ar + ai) * br[j]
            k2 = k2 + ar * d
            k3 = k3 + ai * s
        y_re, y_im = k1 - k3, k1 + k2
        y_s = y_re + y_im
        # stage 2: warp g of the block sums the k of each pass whose offset
        # in the pass is g modulo 8, in order; the warps' sums are added in
        # warp order
        kc = -(-min(kblk, runtime.FFT2D_CHUNK) // 4) * 4
        part_re = part_im = None
        for g in range(runtime.FFT2D_K_GROUPS):
            z1 = torch.zeros((r, c))
            z2 = torch.zeros((r, c))
            z3 = torch.zeros((r, c))
            for i, k in enumerate(ks):
                if i % kc % runtime.FFT2D_K_GROUPS != g:
                    continue
                br, bi = fc_re[k], fc_im[k]
                z1 = z1 + y_s[:, i:i + 1] * br
                z2 = z2 + y_re[:, i:i + 1] * (bi - br)
                z3 = z3 + y_im[:, i:i + 1] * (br + bi)
            if part_re is None:
                part_re, part_im = z1 - z3, z1 + z2
            else:
                part_re, part_im = part_re + (z1 - z3), part_im + (z1 + z2)
        z_re = z_re + part_re
        z_im = z_im + part_im
    return z_re, z_im


@pytest.mark.parametrize("shape,block", [((16, 48), 16), ((8, 40), 8)],
                         ids=str)
def test_fused_arithmetic_matches_the_jax_function(shape, block):
    rng = np.random.default_rng(11)
    re_, im_ = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
    want = jax_fft2d.fft2d(jnp.asarray(re_), jnp.asarray(im_), bm=block,
                           bn=block, bk=block, interpret=True)
    split = runtime.fft2d_route(*shape).split
    assert split > 1
    for s in (split, 1):
        got = _emulate_fused(torch.from_numpy(re_), torch.from_numpy(im_), s)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-3)


def test_cpu_fft2d_runs_the_composition_whatever_the_tile():
    gen = torch.Generator().manual_seed(0)
    re_, im_ = (torch.randn((12, 67), generator=gen) for _ in range(2))
    before = fft2d.launches, dict(fft2d.variants)
    want = ref.fft2d(re_, im_)
    for tiles in (runtime.fft2d_route(12, 67), (16, 32, 32)):
        got = fft2d.fft2d(re_, im_, tiles=tiles)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-3)
    assert (fft2d.launches, dict(fft2d.variants)) == before


def test_large_transforms_leave_no_planes_cached():
    """Past ``DFT_CACHE_MAX_N`` points a transform's DFT planes are built
    for the call, on the host and on the device, and not kept (an
    8192-point pair is 512 MiB); the small side's planes stay cached."""
    n = fft2d.DFT_CACHE_MAX_N + 16
    fft2d._planes_cached.cache_clear()
    fft2d._dft_matrix_cached.cache_clear()
    gen = torch.Generator().manual_seed(4)
    re_, im_ = (torch.randn(4, n, generator=gen) for _ in range(2))
    got_re, got_im = fft2d.fft2d(re_, im_, tiles=build.COMPILED_TILES[0])
    want = torch.fft.fft2(torch.complex(re_.double(), im_.double()))
    torch.testing.assert_close(got_re.double(), want.real, rtol=0, atol=0.05)
    torch.testing.assert_close(got_im.double(), want.imag, rtol=0, atol=0.05)
    # only the 4-point planes (host matrix and device planes) were kept
    assert fft2d._planes_cached.cache_info().currsize == 1
    assert fft2d._dft_matrix_cached.cache_info().currsize == 1
    assert fft2d._planes_cached.cache_info().misses == 1
    assert len(fft2d._dft_planes(n, torch.device("cpu"))[0]) == n
    assert fft2d._planes_cached.cache_info().currsize == 1


# ---------------------------------------------------------------------------
# the FFT kernel (csrc/widesa_fft.cu): tiles, tables, the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,tile", [
    # one row a row-pass block; 16-column strips over a cluster of 16
    ((8192, 8192), ((16, 8, 8, 8), (8, 8, 8), 1, 16, 16)),
    ((4096, 256), ((16, 16), (8, 8, 8), 16, 16, 8)),
    ((512, 8192), ((16, 8, 8, 8), (8, 8, 8), 1, 16, 1)),
    ((128, 128), ((16, 8), (16, 8), 32, 16, 1)),
    ((8192, 2), ((2,), (16, 16, 16), 2048, 2, 2)),
    ((128, 64), ((8, 8), (16, 8), 64, 16, 1)),
], ids=str)
def test_fft_config(shape, tile):
    """``FFT_ROW_POINTS`` points a row-pass block in whole rows,
    ``FFT_STRIP``-column strips (all the columns of a narrower grid), the
    smallest cluster that holds the strip, and radix plans of as few
    stages as radix 16 allows."""
    rows_r, cols_r, rows, strip, cluster = tile
    got = runtime.fft_config(*shape)
    assert got == runtime.FftTile(row_radices=rows_r, col_radices=cols_r,
                                  rows=rows, strip=strip, cluster=cluster)
    assert runtime.fft_allows(*shape, got)
    assert rows * shape[1] <= runtime.FFT_BLOCK_POINTS
    assert shape[0] // cluster * strip <= runtime.FFT_BLOCK_POINTS


@pytest.mark.parametrize("n,radices", [
    (2, (2,)), (16, (16,)), (32, (8, 4)), (128, (16, 8)), (1024, (16, 8, 8)),
    (4096, (16, 16, 16)), (8192, (16, 8, 8, 8)),
], ids=str)
def test_fft_radices(n, radices):
    assert runtime.fft_radices(n) == radices
    assert runtime.radix_logs(radices) == sum(
        (r.bit_length() - 1) << (4 * s) for s, r in enumerate(radices))


@pytest.mark.parametrize("shape,change", [
    ((8192, 8192), dict(strip=32)),          # 32 x 512 points a block
    ((8192, 8192), dict(cluster=32)),        # past the largest cluster
    ((8192, 8192), dict(strip=3)),           # no power of two
    ((128, 128), dict(rows=256)),            # more rows than the grid
    ((128, 128), dict(strip=256)),           # more columns than the grid
    ((128, 128), dict(row_radices=(16, 16))),  # a plan over 256 points
    ((128, 128), dict(col_radices=(32, 4))),   # a radix past 16
], ids=str)
def test_fft_kernel_refuses_tiles(shape, change):
    import dataclasses

    tile = dataclasses.replace(runtime.fft_config(*shape), **change)
    assert not runtime.fft_allows(*shape, tile)


@pytest.mark.parametrize("shape", [(16384, 128), (128, 16384), (96, 128),
                                   (128, 96), (65, 64), (1, 128)], ids=str)
def test_fft_kernel_takes_powers_of_two_up_to_8192(shape):
    assert not runtime.fft_allows(*shape, runtime.fft_config(*shape))


def test_fft_geometry_matches_the_cuda_source():
    """runtime's FFT_* constants are the kernel's kStock* ones, a block of
    the most points fits the card's 227 KB of shared memory (both planes,
    a pad word every 32: ``stock_plane_floats``), and the butterflies'
    literal roots of unity are the twiddle tables' float32 values
    (``w_16^m``: entry m n / 16)."""
    src = build.FFT_SOURCE.read_text()
    k = {name: int(v) for name, v in
         re.findall(r"constexpr int kStock(\w+) = (\d+);", src)}
    assert (runtime.FFT_POINTS, runtime.FFT_MAX_RADIX,
            runtime.FFT_BLOCK_POINTS, runtime.FFT_MAX_CLUSTER,
            runtime.FFT_MAX_SIDE) == (
        k["Points"], k["MaxRadix"], k["BlockPoints"], k["MaxCluster"],
        k["MaxSide"])
    assert "return f + (f >> 5);" in src
    points = runtime.FFT_BLOCK_POINTS
    assert 2 * (points + points // 32) * 4 <= 232448
    assert "__launch_bounds__(kStockMaxThreads, 2)" in src
    cos, sin = fft2d.twiddle_table(16)
    for part, table in (("re", cos), ("im", sin)):
        body = re.search(rf"float w16_{part}\(int m\) \{{(.*?)\n\}}", src,
                         re.S).group(1)
        lits = {int(m): np.float32(float(v)) for m, v in
                re.findall(r"case (\d): return (-?[\d.]+)f;", body)}
        default = np.float32(float(re.search(r"default: return (-?[\d.]+)f;",
                                             body).group(1)))
        for m in range(8):
            if m == 4:   # -i, an exact swap in the kernel
                continue
            assert lits.get(m, default) == table[m], (part, m)


@pytest.mark.parametrize("n", [2, 16, 128, 8192])
def test_twiddle_tables(n):
    """(cos, -sin)(2 pi j / n) in float64 cast to float32, exact zeros at
    the quarter turns, 8 bytes a point (64 KB at 8192)."""
    cos, sin = fft2d.twiddle_table(n)
    ang = 2 * np.pi * np.arange(n) / n
    np.testing.assert_allclose(cos, np.cos(ang), rtol=0, atol=6e-8)
    np.testing.assert_allclose(sin, -np.sin(ang), rtol=0, atol=6e-8)
    assert cos.dtype == sin.dtype == np.float32
    for q in range(4):
        if q * n % 4 == 0:
            j = q * n // 4
            assert (cos[j], sin[j]) == (
                (1, 0), (0, -1), (-1, 0), (0, 1))[q]
    dev = fft2d.twiddles(n, torch.device("cpu"))
    assert dev.shape == (n, 2) and dev.nbytes == 8 * n
    np.testing.assert_array_equal(dev.numpy(), np.stack((cos, sin), 1))


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("shape", [(128, 128), (256, 64)], ids=str)
def test_fft_plain_matches_the_jax_function(shape):
    """The plain version on the runtime's tile against the JAX package's
    ``fft2d`` in interpret mode, as ``tests/test_kernels.py`` runs it."""
    from repro.kernels import ops as jax_ops

    re_, im_ = _planes(shape, 21)
    want = jax_ops.fft2d(jnp.asarray(re_), jnp.asarray(im_), bm=32, bn=32,
                         bk=32)
    tile = runtime.fft2d_route(*shape)
    assert isinstance(tile, runtime.FftTile)
    got = fft2d.fft_plain(torch.from_numpy(re_), torch.from_numpy(im_), tile)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=0.5,
                                   rtol=1e-3)


@pytest.mark.parametrize("cluster", [1, 4], ids=lambda c: f"cluster{c}")
def test_fft_plain_matches_the_jax_oracle(cluster):
    """At (128, 512) against ``repro.kernels.ref.fft2d``, on the default
    tile and with the column split over a cluster of 4."""
    from repro.kernels import ref as jax_ref

    shape = (128, 512)
    re_, im_ = _planes(shape, 22)
    want = jax_ref.fft2d(jnp.asarray(re_), jnp.asarray(im_))
    tile = runtime.fft_config(*shape, cluster=cluster)
    assert runtime.fft_allows(*shape, tile) and tile.cluster == cluster
    got = fft2d.fft_plain(torch.from_numpy(re_), torch.from_numpy(im_), tile)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=0.5,
                                   rtol=1e-3)


@pytest.mark.parametrize("shape,change", [
    ((128, 8192), {}),
    ((1024, 64), dict(strip=8, cluster=16)),   # the widest cluster
    ((2048, 8), dict(rows=64, strip=4, cluster=2)),
], ids=str)
def test_fft_plain_matches_numpy_float64(shape, change):
    """Against numpy's float64 ``fft2``: the rms error at most 1e-5 of the
    output's rms, the largest within the registry's atol."""
    re_, im_ = _planes(shape, 23)
    tile = runtime.fft_config(*shape, **change)
    assert runtime.fft_allows(*shape, tile)
    z_re, z_im = fft2d.fft_plain(torch.from_numpy(re_),
                                 torch.from_numpy(im_), tile)
    want = np.fft.fft2(re_.astype(np.float64) + 1j * im_)
    err = np.abs(z_re.numpy() + 1j * z_im.numpy() - want)
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    assert np.sqrt(np.mean(err ** 2)) <= 1e-5 * rms
    assert err.max() <= registry.get("fft2d_stage").atol


def test_cpu_fft2d_runs_the_composition_on_an_fft_tile():
    """An ``FftTile`` on CPU planes: the composition over ``ref.mm``, no
    launch counted; the plain version within the registry's atol of it."""
    shape = (128, 64)
    re_, im_ = (torch.from_numpy(p) for p in _planes(shape, 24))
    tile = runtime.fft2d_route(*shape)
    assert isinstance(tile, runtime.FftTile)
    before = fft2d.launches, dict(fft2d.variants)
    got = fft2d.fft2d(re_, im_, tiles=tile)
    assert (fft2d.launches, dict(fft2d.variants)) == before
    for g, w in zip(got, ref.fft2d(re_, im_)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-2)
    for g, w in zip(fft2d.fft_plain(re_, im_, tile), got):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-2)
