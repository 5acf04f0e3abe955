"""The fused fft2d kernel's route, operands and arithmetic, on the CPU.

* ``runtime.fft2d_route`` / ``fft2d_tile`` (their constants are the CUDA
  source's): grids of at most ``FFT2D_MAX_ROWS`` rows whose passes fit
  in shared memory run the fused kernel (``runtime.Fft2dTile``), K split
  over a cluster as far as the grid stays within ``FFT2D_MAX_BLOCKS``
  blocks; taller grids run the composition over the mm kernels at the
  plan's tiled tile.
* The DFT planes the fused kernel reads: rows padded to whole 16-byte
  units, equal element for element to the JAX package's ``dft_matrix``
  and symmetric (zeros in the padding).
* The kernel's arithmetic, emulated in float32 torch: each rank of the
  split forms Y = F_R X for its columns k in the three-product form,
  then each of its 8 warps sums Y F_C over every 8th k in order (operand
  sums formed on load), the warps' sums added in warp order, and the
  ranks' partial tiles in rank order.  Held to the JAX
  package's ``repro.kernels.fft2d.fft2d`` (Pallas, interpret mode) on the
  same numpy operands within 1e-3 (fp32 sums of at most 48 terms of
  magnitude ~30; the registry's atol is 1.0).
* On the CPU ``fft2d.fft2d`` runs the composition over ``ref.mm`` whatever
  the tile, and counts no launch.

The kernel itself runs only on the card: ``tests/test_torch_gpu.py``.
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


@pytest.mark.parametrize("shape", [(65, 64), (128, 128), (8192, 8192)],
                         ids=str)
def test_taller_grids_take_the_composition(shape):
    """Above ``FFT2D_MAX_ROWS`` rows the registry's tiles name the
    tiled tile the composition's products fall back to."""
    assert runtime.fft2d_route(*shape) is None
    plan = planned.plan_for("fft2d_stage", shape, "float32")
    x = torch.zeros(shape)
    tiles = registry.get("fft2d_stage").tiles(plan, x, x)
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
