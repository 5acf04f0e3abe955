"""Weighted star stencils on the hand-written Hopper kernel: one sweep of
the 5-point star (``jacobi2d``), of the radius-2 9-point star
(``jacobi2d_9pt``), and ``weights.shape[0]`` sweeps (``jacobi2d_ms``).

The port of ``repro.kernels.jacobi2d`` (``jacobi_kernel``) and of its
staging in ``repro.kernels.ops`` (``_star2d``, ``jacobi2d_ms``): the kernel
is ``csrc/widesa_hpc.cu`` (``star_kernel``), which stages an input tile
with its halo in shared memory instead of reading the reference's
shifted-point stack.  ``star2d`` checks its operands, allocates the output
and launches on the current stream; a CPU tensor runs the plain version in
``ref.py`` instead.  ``launches`` counts kernel launches (one per sweep).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.recurrence import JACOBI2D_9PT_OFFSETS, JACOBI2D_OFFSETS

from . import build, ref, runtime

launches = 0

#: the most star points the kernel takes (``kMaxPoints`` in the source)
MAX_POINTS = 16


def _check(grid, weights, offsets, tiles, out_dtype, *, state_dtype,
           weight_dims: int):
    """Validate a CUDA launch over ``grid`` whose kernel reads a state of
    ``state_dtype``; return ``(radius, out_dtype)``."""
    if grid.dim() != 2 or weights.dim() != weight_dims:
        raise ValueError(f"expected a 2-D grid and {weight_dims}-D weights, "
                         f"got {tuple(grid.shape)} and "
                         f"{tuple(weights.shape)}")
    if weights.shape[-1] != len(offsets) or not 1 <= len(offsets) <= MAX_POINTS:
        raise ValueError(f"{weights.shape[-1]} weights for a star of "
                         f"{len(offsets)} points")
    if grid.dtype.is_floating_point != weights.dtype.is_floating_point:
        raise TypeError(f"grid and weights mix float and integer dtypes: "
                        f"{grid.dtype} vs {weights.dtype}")
    if grid.device != weights.device or grid.device.type != "cuda":
        raise ValueError(f"operands must share one CUDA device, got "
                         f"{grid.device} and {weights.device}")
    out_dtype = out_dtype or runtime.out_dtype(state_dtype)
    if (state_dtype, out_dtype) not in build.HPC_DTYPES:
        raise TypeError(f"no stencil kernel for {state_dtype} -> "
                        f"{out_dtype}")
    if tuple(tiles) != build.STENCIL_TILE:
        raise ValueError(f"stencil tile {tiles} is not compiled")
    radius = ref._star_pad(offsets)
    if radius not in build.STENCIL_RADII or any(
            not (0 <= d <= 2 * radius) for pt in offsets for d in pt):
        raise ValueError(f"star {offsets} is outside the compiled radii "
                         f"{build.STENCIL_RADII}")
    oh, ow = grid.shape[0] - 2 * radius, grid.shape[1] - 2 * radius
    if oh < 1 or ow < 1 or grid.numel() >= 2**31 \
            or -(-oh // tiles[0]) > 65535:
        raise ValueError(f"a radius-{radius} star over {tuple(grid.shape)} "
                         "is outside the kernel's range")
    return radius, out_dtype


def _launch(grid, weights, out, offsets, radius, tiles) -> None:
    """One sweep of the star over ``grid`` into ``out`` (row stride
    ``out.stride(0)``); ``weights`` hold the accumulator dtype."""
    global launches
    flat = (ctypes.c_int * (2 * len(offsets)))(
        *(d for pt in offsets for d in pt))
    with torch.cuda.device(grid.device):
        build.call("widesa_star_launch", grid.data_ptr(), weights.data_ptr(),
                   out.data_ptr(), out.shape[0], out.shape[1], out.stride(0),
                   radius, len(offsets), flat, build.DTYPE_CODES[grid.dtype],
                   build.DTYPE_CODES[out.dtype], tiles=tuple(tiles))
    launches += 1


def star2d(grid: torch.Tensor, weights: torch.Tensor, offsets, *,
           tiles: tuple[int, int],
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One weighted sweep of the star ``offsets`` (padded-grid (di, dj)
    per point) over the interior of ``grid`` with the compiled tile
    ``tiles = (BH, BW)`` (``build.STENCIL_TILE``): float32 gives
    float32, integers give int32.  Integer weights may be of another
    integer dtype than the grid (a halo chain feeds an int32 grid)."""
    if grid.device.type == "cpu" and weights.device.type == "cpu":
        return ref.star2d(grid, weights, offsets, out_dtype)
    radius, out_dtype = _check(grid, weights, offsets, tiles, out_dtype,
                               state_dtype=grid.dtype, weight_dims=1)
    if not grid.is_contiguous():
        raise ValueError("the stencil grid must be contiguous")
    out = torch.empty((grid.shape[0] - 2 * radius, grid.shape[1] - 2 * radius),
                      dtype=out_dtype, device=grid.device)
    w_acc = weights.to(runtime.acc_dtype(grid.dtype)).contiguous()
    _launch(grid, w_acc, out, offsets, radius, tiles)
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
                tiles: tuple[int, int],
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``weights.shape[0]`` weighted 5-point sweeps (``weights`` (T, 5)),
    each over the previous sweep's interior inside the fixed boundary
    ring, as ``ops.jacobi2d_ms`` loops on the host.  The state is promoted
    to the accumulator dtype (int32 for integers) once, up front, and two
    state buffers take turns: each sweep's kernel writes its interior
    straight into the other buffer, inside the ring both hold, so no
    re-embedding copy is made; the last sweep writes the result.  One
    launch per sweep."""
    if grid.device.type == "cpu" and weights.device.type == "cpu":
        return ref.jacobi2d_ms(grid, weights, out_dtype)
    acc = runtime.acc_dtype(grid.dtype)
    radius, out_dtype = _check(grid, weights, JACOBI2D_OFFSETS, tiles,
                               out_dtype, state_dtype=acc, weight_dims=2)
    state = grid.to(dtype=acc, memory_format=torch.contiguous_format,
                    copy=True)
    inner = (slice(radius, -radius), slice(radius, -radius))
    if weights.shape[0] == 0:
        return state[inner].contiguous()
    spare = state.clone() if weights.shape[0] > 1 else None
    w_acc = weights.to(acc).contiguous()
    for t in range(weights.shape[0]):
        last = t == weights.shape[0] - 1
        dst = (torch.empty(state[inner].shape, dtype=out_dtype,
                           device=grid.device) if last else spare[inner])
        _launch(state, w_acc[t], dst, JACOBI2D_OFFSETS, radius, tiles)
        if not last:
            state, spare = spare, state
    return dst
