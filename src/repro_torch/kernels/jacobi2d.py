"""Weighted star stencils on the hand-written Hopper kernels: one sweep of
the 5-point star (``jacobi2d``), of the radius-2 9-point star
(``jacobi2d_9pt``), and ``weights.shape[0]`` sweeps (``jacobi2d_ms``).

The port of ``repro.kernels.jacobi2d`` (``jacobi_kernel``) and of its
staging in ``repro.kernels.ops`` (``_star2d``, ``jacobi2d_ms``), on two
kernels of ``csrc/widesa_hpc.cu``:

* ``star_kernel`` runs one sweep, a window kernel of ``csrc/window.cuh``
  (each grid row streamed through shared memory once, the star's centre
  column sliding through registers) instead of reading the reference's
  shifted-point stack.  The two stars are compile-time cases
  (``build.STAR_POINTS``).
* ``sweeps_kernel`` runs T_b sweeps of ``jacobi2d_ms`` a launch on state
  tiles with a T_b-wide halo, instead of the reference's host loop of one
  sweep a launch; ``runtime.sweep_tile`` picks T_b.

The wrappers check their operands, allocate the outputs and launch on the
current stream; a CPU tensor runs the plain version in ``ref.py`` instead.
``launches`` counts kernel launches; ``variants`` the same launches by
kernel ("star5", "star9": ``star_kernel``; "sweeps": ``sweeps_kernel``).
"""

from __future__ import annotations

import torch

from repro_torch.core.recurrence import JACOBI2D_9PT_OFFSETS, JACOBI2D_OFFSETS

from . import build, ref, runtime

launches = 0
variants = {"star5": 0, "star9": 0, "sweeps": 0}

#: the compiled stars: their points (``Star<5>``, ``Star<9>``) -> offsets
STARS = {5: tuple(JACOBI2D_OFFSETS), 9: tuple(JACOBI2D_9PT_OFFSETS)}


def _check(grid, weights, offsets, out_dtype, *, weight_dims: int):
    """Validate a CUDA launch over ``grid``; return ``(points, radius,
    out_dtype)``."""
    if grid.dim() != 2 or weights.dim() != weight_dims:
        raise ValueError(f"expected a 2-D grid and {weight_dims}-D weights, "
                         f"got {tuple(grid.shape)} and "
                         f"{tuple(weights.shape)}")
    if weights.shape[-1] != len(offsets):
        raise ValueError(f"{weights.shape[-1]} weights for a star of "
                         f"{len(offsets)} points")
    if grid.dtype.is_floating_point != weights.dtype.is_floating_point:
        raise TypeError(f"grid and weights mix float and integer dtypes: "
                        f"{grid.dtype} vs {weights.dtype}")
    if grid.device != weights.device or grid.device.type != "cuda":
        raise ValueError(f"operands must share one CUDA device, got "
                         f"{grid.device} and {weights.device}")
    out_dtype = out_dtype or runtime.out_dtype(grid.dtype)
    if (grid.dtype, out_dtype) not in build.HPC_DTYPES:
        raise TypeError(f"no stencil kernel for {grid.dtype} -> "
                        f"{out_dtype}")
    points = len(offsets)
    if STARS.get(points) != tuple(map(tuple, offsets)):
        raise ValueError(f"star {offsets} is not compiled (the stars of "
                         f"{build.STAR_POINTS} points)")
    radius = ref._star_pad(offsets)
    oh, ow = grid.shape[0] - 2 * radius, grid.shape[1] - 2 * radius
    if oh < 1 or ow < 1 or grid.numel() >= 2**31:
        raise ValueError(f"a radius-{radius} star over {tuple(grid.shape)} "
                         "is outside the kernel's range")
    if not grid.is_contiguous():
        raise ValueError("the stencil grid must be contiguous")
    return points, radius, out_dtype


def star2d(grid: torch.Tensor, weights: torch.Tensor, offsets, *,
           tiles: runtime.StarTile,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One weighted sweep of the star ``offsets`` (padded-grid (di, dj)
    per point: ``JACOBI2D_OFFSETS`` or ``JACOBI2D_9PT_OFFSETS``) over the
    interior of ``grid``, each warp walking ``tiles.rows`` output rows
    (``runtime.star_tile``): float32 gives float32, integers give int32.
    Integer weights may be of another integer dtype than the grid (a halo
    chain feeds an int32 grid)."""
    global launches
    if grid.device.type == "cpu" and weights.device.type == "cpu":
        return ref.star2d(grid, weights, offsets, out_dtype)
    points, radius, out_dtype = _check(grid, weights, offsets, out_dtype,
                                       weight_dims=1)
    oh, ow = grid.shape[0] - 2 * radius, grid.shape[1] - 2 * radius
    if tiles.rows < 1 or -(-oh // tiles.rows) > 65535:
        raise ValueError(f"{tiles} is outside the kernel's range")
    out = torch.empty((oh, ow), dtype=out_dtype, device=grid.device)
    w_acc = weights.to(runtime.acc_dtype(grid.dtype)).contiguous()
    with torch.cuda.device(grid.device):
        build.call("widesa_star_launch", grid.data_ptr(), w_acc.data_ptr(),
                   out.data_ptr(), oh, ow, points,
                   build.DTYPE_CODES[grid.dtype],
                   build.DTYPE_CODES[out_dtype], tiles.rows)
    launches += 1
    variants[f"star{points}"] += 1
    return out


def jacobi2d(grid, weights, *, tiles, out_dtype=None):
    """One weighted 5-point Jacobi sweep: (H, W) -> (H - 2, W - 2)."""
    return star2d(grid, weights, JACOBI2D_OFFSETS, tiles=tiles,
                  out_dtype=out_dtype)


def jacobi2d_9pt(grid, weights, *, tiles, out_dtype=None):
    """One weighted 9-point radius-2 star sweep: (H, W) -> (H - 4, W - 4)."""
    return star2d(grid, weights, JACOBI2D_9PT_OFFSETS, tiles=tiles,
                  out_dtype=out_dtype)


def jacobi2d_ms(grid: torch.Tensor, weights: torch.Tensor, *,
                tiles: runtime.SweepTile,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``weights.shape[0]`` = T weighted 5-point sweeps (``weights`` (T,
    5)), each over the previous sweep's interior inside the fixed boundary
    ring, as ``ops.jacobi2d_ms`` loops on the host: ``tiles.sweeps`` (T_b,
    from ``runtime.sweep_tile``; 1 gives one launch a sweep) sweeps a
    launch, ``tiles.launches(T)`` launches.  The first launch reads the
    grid in its own dtype and promotes it as it loads; each launch but the
    last writes the whole state, ring included, in the accumulator dtype
    (int32 for integers) to a buffer of the grid's shape that the next
    reads (two take turns from three launches up), and the last writes the
    interior.  No copy of the state is made on the host side."""
    global launches
    if grid.device.type == "cpu" and weights.device.type == "cpu":
        return ref.jacobi2d_ms(grid, weights, out_dtype)
    acc = runtime.acc_dtype(grid.dtype)
    _, radius, out_dtype = _check(grid, weights, JACOBI2D_OFFSETS,
                                  out_dtype, weight_dims=2)
    if not 1 <= tiles.sweeps <= build.SWEEP_MAX:
        raise ValueError(f"{tiles} is outside the kernel's range (at most "
                         f"{build.SWEEP_MAX} sweeps a launch)")
    h, w = grid.shape
    sweeps = weights.shape[0]
    if sweeps == 0:
        return grid[radius:-radius, radius:-radius].to(out_dtype)
    w_acc = weights.to(acc).contiguous()
    out = torch.empty((h - 2 * radius, w - 2 * radius), dtype=out_dtype,
                      device=grid.device)
    n = tiles.launches(sweeps)
    states = [torch.empty((h, w), dtype=acc, device=grid.device)
              for _ in range(min(n - 1, 2))]
    src = grid
    with torch.cuda.device(grid.device):
        for i in range(n):
            t0 = i * tiles.sweeps
            last = i == n - 1
            dst = out if last else states[i % 2]
            build.call("widesa_sweeps_launch", src.data_ptr(),
                       w_acc[t0].data_ptr(), dst.data_ptr(), h, w,
                       min(tiles.sweeps, sweeps - t0), int(last),
                       build.DTYPE_CODES[src.dtype],
                       build.DTYPE_CODES[dst.dtype])
            launches += 1
            variants["sweeps"] += 1
            src = dst
    return out
