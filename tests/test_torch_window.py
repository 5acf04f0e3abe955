"""The window kernels' schedules and launch choices on the CPU: the
multi-sweep star stencil (``jacobi2d_ms`` on ``sweeps_kernel``) and conv2d
(``conv2d_kernel``), both of ``src/repro_torch/kernels/csrc``.

* A plain-PyTorch model of the multi-sweep schedule the runtime exposes
  (``runtime.SweepTile``: state tiles of ``build.SWEEP_TILE`` loaded with a
  T_b-wide halo, zeros past the grid; T_b sweeps a launch, each over the
  tile grown by the sweeps left, the grid's outer ring kept; the whole
  state, ring included, between launches, the interior from the last) is
  held bit-exactly against the JAX package's ``ops.jacobi2d_ms``, run in
  interpret mode as the JAX package's own tests run it, on seeded numpy
  operands, in int32 and float32 (and int16, promoted as the first
  launch loads it), at ragged sizes with T no multiple of T_b.  The
  model's star is the kernels' ``star_point``: points in s order, one
  fused multiply-add each in float32 (emulated in float64, exact before
  the one rounding to float32), which is the reference kernel's own
  contraction on the CPU.
* The recurrence pipeline runs the registry's four conv2d bench cases, on
  plans equal to the reference's ``best_plan``, on compiled windows.
* The runtime's picks fit: T_b's two tile buffers leave room for a second
  block on an SM, every window kernel's ring fits in static shared memory,
  and every band count fits the grid, at every registry case.

The kernels themselves run only on the card: ``tests/test_torch_gpu.py``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import Target as JaxTarget  # noqa: E402
from repro.core import best_plan as jax_best_plan  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro_torch.core import Target, best_plan  # noqa: E402
from repro_torch.core.recurrence import JACOBI2D_OFFSETS  # noqa: E402
from repro_torch.kernels import (build, conv2d, jacobi2d, ref,  # noqa: E402
                                 registry, runtime)
from repro_torch.launch import recurrences  # noqa: E402

SINGLE_CHIP = Target(name="single_chip", mesh_shape=(1, 1))
JAX_SINGLE_CHIP = JaxTarget(name="single_chip", mesh_shape=(1, 1))


# ---------------------------------------------------------------------------
# the multi-sweep schedule
# ---------------------------------------------------------------------------

def _star(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One 5-point sweep over the interior of ``buf`` as ``star_point``
    computes it: float32 as a chain of fused multiply-adds in s order,
    integers modulo 2^32."""
    h, wd = buf.shape[0] - 2, buf.shape[1] - 2
    pts = [buf[di:di + h, dj:dj + wd] for di, dj in JACOBI2D_OFFSETS]
    if buf.dtype.is_floating_point:
        acc = torch.zeros((h, wd), dtype=torch.float32)
        for x, ws in zip(pts, w):
            acc = (x.double() * ws.double() + acc.double()).float()
        return acc
    acc = torch.zeros((h, wd), dtype=torch.int64)
    for x, ws in zip(pts, w):
        acc = ref._wrap32(acc + x.to(torch.int64) * ws.to(torch.int64))
    return acc.to(torch.int32)


def sweep_model(grid: torch.Tensor, weights: torch.Tensor,
                tile: runtime.SweepTile,
                block: tuple[int, int] = build.SWEEP_TILE) -> torch.Tensor:
    """``jacobi2d_ms`` as ``sweeps_kernel`` schedules it: ``tile.launches``
    launches of at most ``tile.sweeps`` sweeps, each block a ``block`` tile
    of the state."""
    acc = runtime.acc_dtype(grid.dtype)
    h, w = grid.shape
    t = weights.shape[0]
    bh, bw = block
    wts = weights.to(acc)
    src = grid
    for launch in range(tile.launches(t)):
        t0 = launch * tile.sweeps
        n = min(tile.sweeps, t - t0)
        dst = torch.zeros((h, w), dtype=acc)
        for r0 in range(0, h, bh):
            for c0 in range(0, w, bw):
                rows = torch.arange(r0 - n, r0 + bh + n)
                cols = torch.arange(c0 - n, c0 + bw + n)
                r_in = (rows >= 0) & (rows < h)
                c_in = (cols >= 0) & (cols < w)
                buf = torch.zeros((len(rows), len(cols)), dtype=acc)
                buf[np.ix_(r_in.numpy(), c_in.numpy())] = \
                    src[rows[r_in]][:, cols[c_in]].to(acc)
                inner = (((rows >= 1) & (rows <= h - 2))[:, None]
                         & ((cols >= 1) & (cols <= w - 2))[None, :])
                th, tw = buf.shape
                for k in range(1, n + 1):
                    region = (slice(k, th - k), slice(k, tw - k))
                    new = _star(buf[k - 1:th - k + 1, k - 1:tw - k + 1],
                                wts[t0 + k - 1])
                    nxt = buf.clone()
                    nxt[region] = torch.where(inner[region], new,
                                              buf[region])
                    buf = nxt
                own = buf[n:n + bh, n:n + bw]
                keep_r, keep_c = rows[n:n + bh] < h, cols[n:n + bw] < w
                dst[r0:r0 + bh, c0:c0 + bw] = own[keep_r][:, keep_c]
        src = dst
    return src[1:-1, 1:-1].contiguous()


def _draw(rng, shape, dtype):
    if dtype == "float32":
        return rng.standard_normal(shape).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True,
                        dtype=np.int64).astype(dtype)


#: (grid, T, T_b, block): ragged grids, T no multiple of T_b (but one T
#: <= T_b: a single launch), the runtime's T_b and one launch a sweep, on
#: the compiled tile and on smaller ones that cut the grid into many tiles,
#: down to a 3 x 3 grid
SCHEDULES = (
    ((70, 150), 5, 2, build.SWEEP_TILE),
    ((37, 45), 9, runtime.sweep_tile(9).sweeps, (8, 16)),
    ((61, 59), 7, 3, (16, 32)),
    ((45, 33), 4, 1, build.SWEEP_TILE),
    ((29, 40), 3, runtime.sweep_tile(3).sweeps, (8, 8)),
    ((3, 3), 2, 1, (8, 8)),
)


@pytest.mark.parametrize("dtype", ["float32", "int32", "int16"])
@pytest.mark.parametrize("shape,t,tb,block", SCHEDULES,
                         ids=[f"{s[0][0]}x{s[0][1]}-T{s[1]}-Tb{s[2]}-"
                              f"{s[3][0]}x{s[3][1]}" for s in SCHEDULES])
def test_sweep_schedule_model_matches_the_reference_bitwise(shape, t, tb,
                                                            block, dtype):
    rng = np.random.default_rng(sum(shape) + t + tb)
    grid, w = _draw(rng, shape, dtype), _draw(rng, (t, 5), dtype)
    want = np.asarray(jax_ops.jacobi2d_ms(jnp.asarray(grid), jnp.asarray(w),
                                          interpret=True))
    got = sweep_model(torch.from_numpy(grid), torch.from_numpy(w),
                      runtime.SweepTile(sweeps=tb), block).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t", [1, 2, 3, 8, 9, 16, 17])
def test_sweep_launches_are_ceil_t_over_tb(t):
    """The runtime fuses min(T, 8) sweeps a launch; T_b = 1 is one launch
    a sweep."""
    tile = runtime.sweep_tile(t)
    assert tile.sweeps == min(t, build.SWEEP_MAX) >= 1
    assert tile.launches(t) == -(-t // tile.sweeps)
    assert runtime.SweepTile(sweeps=1).launches(t) == t


def test_cpu_multi_sweep_runs_the_plain_version():
    rng = np.random.default_rng(3)
    grid, w = _draw(rng, (20, 17), "int16"), _draw(rng, (5, 5), "int16")
    before = jacobi2d.launches
    got = jacobi2d.jacobi2d_ms(torch.from_numpy(grid), torch.from_numpy(w),
                               tiles=runtime.sweep_tile(5))
    assert jacobi2d.launches == before
    assert torch.equal(got, ref.jacobi2d_ms(torch.from_numpy(grid),
                                            torch.from_numpy(w)))


# ---------------------------------------------------------------------------
# conv2d in the pipeline
# ---------------------------------------------------------------------------

def test_pipeline_runs_the_papers_conv2d_table():
    """``registry_cases("bench")`` yields the registry's four conv2d bench
    cases, the reference's, at full size."""
    cases = [(dtype, args)
             for spec, dtype, args in recurrences.registry_cases("bench")
             if spec.name == "conv2d"]
    assert cases == list(registry.get("conv2d").bench_cases)
    assert cases == list(jax_registry.get("conv2d").bench_cases)
    assert [d for d, _ in cases] == ["float32", "int8", "int16", "int32"]
    assert {args[2:] for _, args in cases} == {(4, 4), (8, 8)}


@pytest.mark.parametrize("dtype,args",
                         list(registry.get("conv2d").bench_cases),
                         ids=lambda v: str(v))
def test_conv2d_bench_plans_match_the_reference(dtype, args):
    """The single-chip plan the pipeline runs equals the reference's
    ``best_plan``, and the runtime launches it on the filter's compiled
    window."""
    spec = registry.get("conv2d")
    plan = best_plan(spec.builder(*args, dtype), SINGLE_CHIP)
    want = jax_best_plan(jax_registry.get("conv2d").builder(*args, dtype),
                         JAX_SINGLE_CHIP)
    assert plan.describe() == want.describe()
    assert plan.partition.block == want.partition.block
    assert plan.feasible == want.feasible
    tiles = runtime.conv2d_tile(plan, args[0], args[1])
    assert tiles.tile.window == args[2:] != build.CONV2D_GENERIC
    assert -(-args[0] // tiles.tile.rows) <= 65535


# ---------------------------------------------------------------------------
# the runtime's choices fit
# ---------------------------------------------------------------------------

#: the static shared memory a block may hold, and one SM's
STATIC_SMEM = 48 * 1024
BLOCK_SMEM = 232448


def _registry_cases(name):
    spec = registry.get(name)
    yield from ((d, spec.smoke_args) for d in spec.parity_dtypes)
    yield from spec.bench_cases


def _source_int(src, name):
    return int(re.search(rf"{name} = (\d+);", src).group(1))


#: shared memory of one SM of an H100 that blocks may use
SM_SMEM = 233472


def _sweep_smem(sweeps):
    """``sweep_smem`` of csrc/widesa_hpc.cu: two buffers of the state tile
    and its halo, rows padded to whole quads and 8 columns more."""
    bh, bw = build.SWEEP_TILE
    pitch = -(-(bw + 2 * sweeps) // 4) * 4 + 8
    return 2 * (bh + 2 * sweeps) * pitch * 4


def test_sweep_tiles_fit_shared_memory_at_every_registry_case():
    """The multi-sweep kernel's geometry is the one the runtime and the
    schedule model use, and the T_b the runtime picks at every registry
    case leaves room for two blocks an SM."""
    src = build.HPC_SOURCE.read_text()
    assert (_source_int(src, "kSweepRows"),
            _source_int(src, "kSweepCols")) == build.SWEEP_TILE
    assert _source_int(src, "kMaxSweeps") == build.SWEEP_MAX
    for _, args in _registry_cases("jacobi2d_ms"):
        tile = runtime.sweep_tile(args[2])
        assert tile.sweeps >= min(2, args[2])
        assert _sweep_smem(tile.sweeps) <= BLOCK_SMEM
        assert 2 * (_sweep_smem(tile.sweeps) + 1024) <= SM_SMEM


def _ring_bytes(elem, strip, halo, slots_past_prefetch):
    """The window kernels' static ring (csrc/window.cuh): 4 warps x
    (``kPrefetchRows`` + extra) slots of ``strip + halo`` elements in
    16-byte units, one unit more."""
    header = (build.CSRC / "window.cuh").read_text()
    d = _source_int(header, "kPrefetchRows")
    slot = ((strip + halo) * elem + 15) // 16 * 16 + 16
    return build.WINDOW_WARPS * (d + slots_past_prefetch) * slot


@pytest.mark.parametrize("dtype", ["float32", "int8", "int16", "int32"])
def test_generic_conv2d_window_fits_shared_memory(dtype):
    """The generic instantiation takes any filter up to ``MAX_FILTER``: its
    ring, sized for the widest halo, and its filter fit in static shared
    memory at every dtype."""
    elem = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    smem = _ring_bytes(elem, 128, conv2d.MAX_FILTER - 1, 1) \
        + 4 * conv2d.MAX_FILTER ** 2
    assert smem <= STATIC_SMEM, smem


@pytest.mark.parametrize("name", ["conv2d", "jacobi2d", "jacobi2d_9pt"])
def test_window_picks_fit_shared_memory_at_every_registry_case(name):
    """Every registry case of conv2d and the one-sweep stars (smoke and
    bench, every dtype) gets a compiled launch whose ring fits in static
    shared memory, and a grid of at most 65535 bands."""
    spec = registry.get(name)
    for dtype, args in _registry_cases(name):
        elem = torch.empty((), dtype=getattr(torch, dtype)).element_size()
        rec = spec.builder(*args, dtype)
        plan = best_plan(rec, SINGLE_CHIP)
        if name == "conv2d":
            tile = runtime.conv2d_tile(plan, args[0], args[1]).tile
            generic = tile.window == build.CONV2D_GENERIC
            assert tile.window == runtime.conv2d_window(*args[2:])
            p, q = args[2:]
            strip = 128
            halo = (conv2d.MAX_FILTER - 1 if generic else q - 1) + (
                4 if dtype == "int8" and not generic and q % 4 == 0 else 0)
            smem = _ring_bytes(elem, strip, halo, 1) + (
                4 * conv2d.MAX_FILTER ** 2 if generic else 4)
        else:
            tile = runtime.stencil_tile(plan).tile
            radius = 2 if name == "jacobi2d_9pt" else 1
            assert isinstance(tile, runtime.StarTile)
            smem = _ring_bytes(elem, 128, 2 * radius, radius + 1)
        assert smem <= STATIC_SMEM, (dtype, args, smem)
        assert 1 <= tile.rows and -(-args[0] // tile.rows) <= 65535
