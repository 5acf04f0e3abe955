"""Chip-level systolic schedules on a single-controller mesh (the port of
``repro.kernels.systolic``), dispatched per recurrence through
``KernelSpec.systolic_lowering`` / ``allgather_lowering`` /
``fused_systolic_lowering``.

Each lowering is a hook ``lowering(plan, mesh) -> Callable(*operands)``
over a ``parallel.mesh.Mesh`` whose axis names are the plan target's
``mesh_axes``.  The schedules are the reference's, with its names,
checks and error text:

  cannon_mm / cannon_bmm / cannon_fft2d
                  Cannon's ring on the square space mesh: the static
                  pre-skew (``_skew_perms``), then one multiply and one
                  rotation (A west along ax1, B north along ax0) a step;
                  bmm carries the whole batch in each block, fft2d
                  co-rotates both real planes of each operand so the four
                  cross products of a complex MAC stay on one member.
  halo_stencil    width-k halo exchange for the star stencils (k the
                  radius from ``recurrence.stencil_star``): a sweep sends
                  four k-wide edge strips one hop; a member with no
                  neighbour receives zeros and substitutes the fixed
                  (Dirichlet) boundary strip.
  chain_conv2d / chain_fir
                  1-D chains over the linearised mesh: a member receives
                  its right neighbour's first ``p - 1`` rows (``taps - 1``
                  samples); the last one substitutes the global tail.
  ring_mttkrp     Cannon over ``l``: X rotates west, C north, B stays.
  fused_halo_chain / fused_cannon_mm / fused_cannon_fft2d
                  a fused chain's stages back to back on the members: one
                  deep halo feeds every stencil stage (the south strip
                  carries the east halo along), one skew serves each mm
                  ring with the bias and activation applied on the
                  members, both DFT stages on one ring.
  allgather_*     the GSPMD all-gather / broadcast baselines.

The step loop runs in lockstep over all members (``parallel/mesh.py``).
Each member's compute is one ``acc + contract(...)`` a step in
``runtime.acc_dtype`` and a final cast to ``runtime.out_dtype``, as the
reference's, so integers are bit-exact.  It runs the port's hand kernels,
through the same wrappers and the runtime's tile choice as the ``pallas``
backend: the ring and all-gather products of mm, bmm and fft2d on B1/B2
(``widesa_mm.matmul`` / ``bmm.bmm``, asked for the accumulator dtype),
each halo sweep on B6's star kernel over the member's block extended by
its received strips, the conv2d and FIR chains on B5 and B3 over the
block and the received window tail, ``ring_mttkrp``'s step on B7, and
the broadcast baselines' whole problem on each member on the same
kernels.  On the CPU the wrappers run the plain versions of ``ref.py``.
The elementwise steps (the halo selection, bias and activation, the
plane combines) are plain torch operations, as the reference's are
``jnp``.

Divisibility (and a square mesh for the Cannon rings) is checked up
front with the reference's errors; nothing is padded.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import torch

from repro_torch.core.hierarchy import halo_fits  # noqa: F401 - shared
from repro_torch.core.recurrence import stencil_star
from repro_torch.parallel import mesh as pm
from repro_torch.parallel.mesh import P

from . import bmm, build, conv2d, fft2d, fir, jacobi2d, mttkrp, runtime
from . import widesa_mm

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.mapper import ExecutionPlan


def _space_axes(plan: "ExecutionPlan") -> tuple[str, str]:
    """The two mesh axes the plan's space loops fold onto (named by the
    plan's target; the mesh passed to the hook must use the same names)."""
    axes = plan.target.mesh_axes
    return axes[0], axes[1] if len(axes) > 1 else axes[0]


def _require_divisible(what: str, extent: int, width: int, axis: str):
    if extent % width:
        raise ValueError(
            f"{what}: extent {extent} does not divide over the {width}-wide "
            f"mesh axis {axis!r} — pad the operand or pick a mesh whose "
            "axis widths divide the space extents")


def _require_square(plan: "ExecutionPlan", mesh, what: str) -> tuple:
    ax0, ax1 = _space_axes(plan)
    n0, n1 = mesh.shape[ax0], mesh.shape[ax1]
    if n0 != n1:
        raise ValueError(
            f"{what} needs a square space array, got {ax0}={n0} x "
            f"{ax1}={n1}")
    return ax0, ax1, n0


def _shard_map(mesh, local: Callable, in_specs, out_specs) -> Callable:
    """``shard_map`` on a single-controller mesh: every operand split by
    its spec onto the members, ``local(*block arrays)`` run in lockstep,
    its block array(s) joined back by ``out_specs`` on the first
    operand's device."""

    def fn(*operands):
        device = operands[0].device
        blocks = [pm.shard(mesh, x, spec)
                  for x, spec in zip(operands, in_specs)]
        out = local(*blocks)
        if isinstance(out_specs, tuple) and not isinstance(out_specs, P):
            return tuple(pm.unshard(mesh, o, spec, device)
                         for o, spec in zip(out, out_specs))
        return pm.unshard(mesh, out, out_specs, device)

    return fn


# ---------------------------------------------------------------------------
# one member's compute on the hand kernels (the plain versions on the CPU)
# ---------------------------------------------------------------------------

def _gemm(plan, a, b, out_dtype):
    """``a @ b`` (2-D on B1, batched on B2) flushed at ``out_dtype``, on
    the configuration ``runtime.gemm_tiles`` picks (the plan's tiled tile
    its fallback).  Integer operands of two dtypes (a fused chain's int32
    intermediate by its int16 weights) both widen to int32, as the
    reference's ``dot2d`` does: the product is the same modulo 2^32."""
    if a.dtype != b.dtype and not a.is_floating_point():
        a, b = a.to(torch.int32), b.to(torch.int32)
    tiles = runtime.gemm_tiles(plan, a, b).tile
    fn = widesa_mm.matmul if a.dim() == 2 else bmm.bmm
    return fn(a, b, tiles=tiles, out_dtype=out_dtype)


def _star(grid, weights, offsets, out_dtype):
    """One sweep of the padded-offsets star over ``grid`` on B6's star
    kernel."""
    r = max(max(di, dj) for di, dj in offsets) // 2
    tiles = runtime.star_tile(grid.shape[0] - 2 * r, grid.shape[1] - 2 * r)
    return jacobi2d.star2d(grid, weights, offsets, tiles=tiles,
                           out_dtype=out_dtype)


def _sweeps(grid, wts, offsets):
    """``wts.shape[0]`` sweeps of the star over ``grid``'s interior, the
    state in the accumulator dtype (``ref.star2d_ms``): one star launch
    for one sweep, else the multi-sweep kernel (jacobi2d_ms, the 5-point
    star, is the only recurrence of more than one)."""
    acc = runtime.acc_dtype(grid.dtype)
    sweeps = wts.shape[0]
    if sweeps == 1:
        return _star(grid, wts[0], offsets, acc)
    return jacobi2d.jacobi2d_ms(grid, wts, tiles=runtime.sweep_tile(sweeps),
                                out_dtype=acc)


def _conv2d(img, filt, out_dtype):
    p, q = filt.shape
    tiles = runtime.conv2d_config(p, q, img.shape[0] - p + 1,
                                  img.shape[1] - q + 1)
    return conv2d.conv2d(img, filt, tiles=tiles, out_dtype=out_dtype)


def _fir(x, taps, out_dtype):
    tiles = runtime.fir_config(x.shape[0] - taps.shape[0] + 1,
                               taps.shape[0], x.element_size())
    return fir.fir(x, taps, tiles=tiles, out_dtype=out_dtype)


def _mttkrp(x, b, c, out_dtype):
    ni, nk, nl = x.shape
    tiles = runtime.mttkrp_route((ni, b.shape[1], nk, nl), x.dtype,
                                 x.data_ptr(), b.data_ptr())
    return mttkrp.mttkrp(x, b, c, tiles=tiles or build.MTTKRP_TILE,
                         out_dtype=out_dtype)


def _fft2d(plan, x_re, x_im):
    tiles = runtime.fft2d_tile(plan, x_re, x_im).tile
    return fft2d.fft2d(x_re, x_im, tiles=tiles)


# ---------------------------------------------------------------------------
# Cannon rings: mm, the batched bmm, and the complex two-plane fft2d
# ---------------------------------------------------------------------------

def _skew_perms(n: int) -> tuple[list, list]:
    """Cannon pre-skew as STATIC perms over the linearized (ax0, ax1) pair:
    A(i, k) -> A(i, (k+i) mod n) ; B(k, j) -> B((k+j) mod n, j)."""
    skew_a = [(r * n + ((c + r) % n), r * n + c)
              for r in range(n) for c in range(n)]
    skew_b = [(((r + c) % n) * n + c, r * n + c)
              for r in range(n) for c in range(n)]
    return skew_a, skew_b


def _rot_perm(n: int) -> list:
    """One ring rotation: every member receives from its +1 neighbour
    (A moves one hop west along ax1 / B one hop north along ax0)."""
    return [((i + 1) % n, i) for i in range(n)]


def _ring(plan, mesh, ax0, ax1, steps, a, b, acc_t):
    """One Cannon ring over block arrays ``a``, ``b``: the pre-skew, then
    ``steps`` of ``acc += a @ b`` and a rotation; the accumulators."""
    skew_a, skew_b = _skew_perms(steps)
    rot = _rot_perm(steps)
    a = pm.ppermute(mesh, a, (ax0, ax1), skew_a)
    b = pm.ppermute(mesh, b, (ax0, ax1), skew_b)
    acc = pm.map_members(mesh, lambda _, x, y: torch.zeros(
        x.shape[:-1] + y.shape[-1:], dtype=acc_t, device=x.device), a, b)
    for _ in range(steps):
        acc = pm.map_members(
            mesh, lambda _, x, y, c: c.add_(_gemm(plan, x, y, acc_t)),
            a, b, acc)
        a = pm.ppermute(mesh, a, ax1, rot)
        b = pm.ppermute(mesh, b, ax0, rot)
    return acc


def _cannon_ring(plan: "ExecutionPlan", mesh, batched: bool) -> Callable:
    """Shared Cannon schedule; ``batched`` carries a leading unsharded
    batch axis in every block."""
    ax0, ax1, steps = _require_square(plan, mesh, "cannon schedule")

    def local(a_blk, b_blk):
        dtype = a_blk.flat[0].dtype
        acc = _ring(plan, mesh, ax0, ax1, steps, a_blk, b_blk,
                    runtime.acc_dtype(dtype))
        out_t = runtime.out_dtype(dtype)
        return pm.map_members(mesh, lambda _, c: c.to(out_t), acc)

    spec = P(None, ax0, ax1) if batched else P(ax0, ax1)
    fn = _shard_map(mesh, local, (spec, spec), spec)

    def run(a, b):
        _require_divisible("cannon A rows", a.shape[-2], steps, ax0)
        _require_divisible("cannon A cols", a.shape[-1], steps, ax1)
        _require_divisible("cannon B rows", b.shape[-2], steps, ax0)
        _require_divisible("cannon B cols", b.shape[-1], steps, ax1)
        return fn(a, b)

    return run


def cannon_mm(plan: "ExecutionPlan", mesh) -> Callable:
    """Cannon-style systolic matmul over the plan's two space axes: A
    sharded (i->ax0, k->ax1), B (k->ax0, j->ax1), C (i->ax0, j->ax1);
    each of the ``steps`` iterations multiplies the local blocks on the
    hand GEMM, then rotates A west and B north.  No member ever holds a
    gathered operand."""
    return _cannon_ring(plan, mesh, batched=False)


def cannon_bmm(plan: "ExecutionPlan", mesh) -> Callable:
    """Batched Cannon: the mm ring with the (unsharded) batch in every
    block, one bmm launch a member a step."""
    return _cannon_ring(plan, mesh, batched=True)


def _cring(plan, mesh, ax0, ax1, steps, ar, ai, br, bi):
    """The complex two-plane ring: both planes of each operand skewed and
    rotated together; a step's complex MAC is four fp32 products."""
    skew_a, skew_b = _skew_perms(steps)
    rot = _rot_perm(steps)
    ar, ai = (pm.ppermute(mesh, v, (ax0, ax1), skew_a) for v in (ar, ai))
    br, bi = (pm.ppermute(mesh, v, (ax0, ax1), skew_b) for v in (br, bi))
    f32 = torch.float32

    def zeros(_, x, y):
        return torch.zeros((x.shape[0], y.shape[1]), dtype=f32,
                           device=x.device)

    accr = pm.map_members(mesh, zeros, ar, br)
    acci = pm.map_members(mesh, zeros, ar, br)

    def mac(_, xr, xi, yr, yi, cr, ci):
        # complex MAC on co-resident blocks (4-mult form)
        return (cr + _gemm(plan, xr, yr, f32) - _gemm(plan, xi, yi, f32),
                ci + _gemm(plan, xr, yi, f32) + _gemm(plan, xi, yr, f32))

    for _ in range(steps):
        accr, acci = pm.map_members(mesh, mac, ar, ai, br, bi, accr, acci)
        ar, ai = (pm.ppermute(mesh, v, ax1, rot) for v in (ar, ai))
        br, bi = (pm.ppermute(mesh, v, ax0, rot) for v in (br, bi))
    return accr, acci


def cannon_fft2d(plan: "ExecutionPlan", mesh) -> Callable:
    """Complex two-plane Cannon for the 2-D FFT's DFT stages: both stages
    of ``Z = F_R @ X @ F_C`` ride the same ring, one call each, the DFT
    planes staged on the caller's device.  It stays in the DFT form at
    every size: a Cannon ring is a distributed product of ``F_R``, ``X``
    and ``F_C`` by construction, so the FFT kernel has no place in it."""
    ax0, ax1, steps = _require_square(plan, mesh, "complex cannon (fft2d)")

    def local(ar, ai, br, bi):
        return _cring(plan, mesh, ax0, ax1, steps, ar, ai, br, bi)

    spec = P(ax0, ax1)
    cfn = _shard_map(mesh, local, (spec,) * 4, (spec, spec))

    def run(x_re, x_im):
        r, c = x_re.shape
        _require_divisible("fft2d rows", r, steps, ax0)
        _require_divisible("fft2d cols", c, steps, ax1)
        # the DFT planes, staged on the caller's device once (B4's cache)
        fr_re, fr_im = fft2d._dft_planes(r, x_re.device)
        fc_re, fc_im = fft2d._dft_planes(c, x_re.device)
        y_re, y_im = cfn(fr_re, fr_im, x_re, x_im)    # stage 1: F_R @ X
        return cfn(y_re, y_im, fc_re, fc_im)          # stage 2: Y @ F_C

    return run


# ---------------------------------------------------------------------------
# Width-k halo exchange for star stencils (jacobi2d, jacobi2d_ms, 9-point)
# ---------------------------------------------------------------------------

def _star_of(plan: "ExecutionPlan") -> tuple[tuple[tuple[int, int], ...], int]:
    """(signed star offsets, radius) from the recurrence's access
    functions — the IR, not the kernel, declares the halo width."""
    star = stencil_star(plan.recurrence)
    if star is None:
        raise ValueError(
            f"halo_stencil: recurrence {plan.recurrence.name!r} carries no "
            "multi-point read access — not a stencil")
    radius = 0
    for off in star:
        di, dj = off[0], off[1] if len(off) > 1 else 0
        if di and dj:
            raise ValueError(
                "halo_stencil handles star stencils only (no diagonal "
                f"points / corner halos), got offset {off}")
        radius = max(radius, abs(di), abs(dj))
    return tuple((o[0], o[1] if len(o) > 1 else 0) for o in star), radius


def halo_stencil(plan: "ExecutionPlan", mesh) -> Callable:
    """Width-k halo-exchange schedule over the plan's two space axes.

    The (h, w) interior is sharded (i->ax0, j->ax1); the four global
    boundary strips of the padded grid (``radius`` wide) ride along
    sharded on the matching axis.  A sweep sends each member's four
    ``radius``-wide edge strips one hop; members on the array boundary
    substitute the fixed strip for the zeros they receive.  The member
    then runs one star sweep on its block extended by the four strips
    (the corners, which a star never reads, zero), in the accumulator
    dtype; jacobi2d_ms repeats this on the updated interior."""
    star, radius = _star_of(plan)
    padded = tuple((di + radius, dj + radius) for di, dj in star)
    ax0, ax1 = _space_axes(plan)
    n0, n1 = mesh.shape[ax0], mesh.shape[ax1]
    r = radius

    def local(x, wts, top, bot, lft, rgt):
        acc_t = runtime.acc_dtype(x.flat[0].dtype)
        x, top, bot, lft, rgt = (pm.map_members(mesh, lambda _, v: v.to(
            acc_t), v) for v in (x, top, bot, lft, rgt))
        south_perm = [(q, q + 1) for q in range(n0 - 1)]  # edge strips S
        north_perm = [(q + 1, q) for q in range(n0 - 1)]  # edge strips N
        east_perm = [(q, q + 1) for q in range(n1 - 1)]   # edge strips E
        west_perm = [(q + 1, q) for q in range(n1 - 1)]   # edge strips W

        def edge(rows, cols):
            return pm.map_members(mesh, lambda _, v: v[rows, cols], x)

        for t in range(wts.flat[0].shape[0]):
            halo_n = pm.ppermute(mesh, edge(slice(-r, None), slice(None)),
                                 ax0, south_perm)
            halo_s = pm.ppermute(mesh, edge(slice(None, r), slice(None)),
                                 ax0, north_perm)
            halo_w = pm.ppermute(mesh, edge(slice(None), slice(-r, None)),
                                 ax1, east_perm)
            halo_e = pm.ppermute(mesh, edge(slice(None), slice(None, r)),
                                 ax1, west_perm)

            def sweep(member, v, w, hn, hs, hw, he, tp, bt, lf, rg):
                row = pm.axis_index(mesh, member, ax0)
                col = pm.axis_index(mesh, member, ax1)
                hl, wl = v.shape
                ext = v.new_zeros((hl + 2 * r, wl + 2 * r))
                ext[r:-r, r:-r] = v
                ext[:r, r:-r] = tp if row == 0 else hn
                ext[-r:, r:-r] = bt if row == n0 - 1 else hs
                ext[r:-r, :r] = lf if col == 0 else hw
                ext[r:-r, -r:] = rg if col == n1 - 1 else he
                return _star(ext, w[t], padded, acc_t)

            x = pm.map_members(mesh, sweep, x, wts, halo_n, halo_s, halo_w,
                               halo_e, top, bot, lft, rgt)
        return x

    fn = _shard_map(mesh, local,
                    (P(ax0, ax1), P(None, None), P(None, ax1), P(None, ax1),
                     P(ax0, None), P(ax0, None)), P(ax0, ax1))

    def run(grid, weights):
        h, w = grid.shape[0] - 2 * r, grid.shape[1] - 2 * r
        if h <= 0 or w <= 0:
            raise ValueError(
                f"stencil needs a grid of at least "
                f"{2 * r + 1}x{2 * r + 1} (got {tuple(grid.shape)})")
        _require_divisible("stencil interior rows", h, n0, ax0)
        _require_divisible("stencil interior cols", w, n1, ax1)
        if r > h // n0 or r > w // n1:
            raise ValueError(
                f"halo radius {r} exceeds the {h // n0}x{w // n1} shard — "
                "a one-hop exchange can only import the adjacent shard; "
                "use fewer chips or a larger grid")
        wts = weights if weights.dim() == 2 else weights[None, :]
        out = fn(grid[r:-r, r:-r], wts,
                 grid[:r, r:-r], grid[-r:, r:-r],
                 grid[r:-r, :r], grid[r:-r, -r:])
        return out.to(runtime.out_dtype(grid.dtype))

    return run


# ---------------------------------------------------------------------------
# 1-D neighbour chains with shifted-window halo: conv2d and fir
# ---------------------------------------------------------------------------

def _chain(plan: "ExecutionPlan", mesh) -> tuple[tuple[str, ...], int]:
    """The linearized 1-D device chain over the plan's space axes: both
    mesh axes fold into one chain (row-major), so a rectangular mesh is
    fine and every member joins the chain."""
    ax0, ax1 = _space_axes(plan)
    if ax1 == ax0:
        return (ax0,), mesh.shape[ax0]
    return (ax0, ax1), mesh.shape[ax0] * mesh.shape[ax1]


def _chain_recv_next(mesh, val, axes: tuple[str, ...], width: int):
    """Every chain member receives ``val`` from its right neighbour (one
    hop); the last member receives zeros (substituted by the caller)."""
    if width == 1:
        return pm.map_members(mesh, lambda _, v: torch.zeros_like(v), val)
    return pm.ppermute(mesh, val, axes if len(axes) > 1 else axes[0],
                       [(i + 1, i) for i in range(width - 1)])


def _with_tail(mesh, x, tail, axes, width, n):
    """Each member's block extended by ``n`` leading elements of its
    right neighbour's (the global tail on the chain's last member)."""
    if n == 0:
        return x
    halo = _chain_recv_next(
        mesh, pm.map_members(mesh, lambda _, v: v[:n], x), axes, width)

    def extend(member, v, h, t):
        last = pm.axis_index(mesh, member, axes) == width - 1
        return torch.cat([v, t if last else h])

    return pm.map_members(mesh, extend, x, halo, tail)


def chain_conv2d(plan: "ExecutionPlan", mesh) -> Callable:
    """1-D neighbour-chain conv2d with a shifted-window halo: the h output
    rows are sharded over the linearized chain (the full image width
    local); each member closes its windows with its right neighbour's top
    ``p - 1`` rows, fetched with one one-hop ppermute (the last member
    substitutes the global input tail), and runs B5 on the extended
    block."""
    axes, width = _chain(plan, mesh)

    def local(x, tail, filt):
        p = filt.flat[0].shape[0]
        acc_t = runtime.acc_dtype(x.flat[0].dtype)
        x = _with_tail(mesh, x, tail, axes, width, p - 1)
        return pm.map_members(mesh, lambda _, v, f: _conv2d(v, f, acc_t),
                              x, filt)

    fn = _shard_map(mesh, local, (P(axes, None), P(None, None),
                                  P(None, None)), P(axes, None))

    def run(img, filt):
        p, q = filt.shape
        h = img.shape[0] - p + 1
        _require_divisible("conv2d output rows", h, width, "+".join(axes))
        if p - 1 > h // width:
            raise ValueError(
                f"window height {p} exceeds the {h // width}-row shard — "
                "the width-(p-1) halo must come from the adjacent shard "
                "(one hop); use fewer chips or larger images")
        out = fn(img[:h], img[h:], filt)
        return out.to(runtime.out_dtype(img.dtype))

    return run


def chain_fir(plan: "ExecutionPlan", mesh) -> Callable:
    """1-D neighbour-chain FIR: the n output samples are sharded over the
    linearized chain; each member one-hop-receives the first ``taps - 1``
    samples of its right neighbour (the last substitutes the global input
    tail) and runs B3 on the extended block."""
    axes, width = _chain(plan, mesh)

    def local(x, tail, taps):
        t = taps.flat[0].shape[0]
        acc_t = runtime.acc_dtype(x.flat[0].dtype)
        x = _with_tail(mesh, x, tail, axes, width, t - 1)
        return pm.map_members(mesh, lambda _, v, h: _fir(v, h, acc_t),
                              x, taps)

    fn = _shard_map(mesh, local, (P(axes), P(None), P(None)), P(axes))

    def run(x, taps):
        t = taps.shape[0]
        n_out = x.shape[0] - t + 1
        _require_divisible("fir outputs", n_out, width, "+".join(axes))
        if t - 1 > n_out // width:
            raise ValueError(
                f"tap count {t} exceeds the {n_out // width}-sample shard "
                "— the width-(t-1) halo must come from the adjacent shard "
                "(one hop); use fewer chips or longer signals")
        out = fn(x[:n_out], x[n_out:], taps)
        return out.to(runtime.out_dtype(x.dtype))

    return run


# ---------------------------------------------------------------------------
# MTTKRP: 2-D ring over (i, j) with the factor matrices staged
# ---------------------------------------------------------------------------

def ring_mttkrp(plan: "ExecutionPlan", mesh) -> Callable:
    """2-D ring for M[i,j] += X[i,k,l] B[k,j] C[l,j]: Cannon over ``l``.
    X is sharded (i->ax0, l->ax1) and rotates west; C (l->ax0, j->ax1)
    co-rotates north with mm's pre-skew; B (j->ax1) stays on its column
    of members.  One three-operand contraction a step on B7, accumulated
    in ``acc_dtype``; the ``k`` contraction stays on the member."""
    ax0, ax1, steps = _require_square(plan, mesh, "mttkrp ring")

    def local(x_blk, b_blk, c_blk):
        skew_a, skew_b = _skew_perms(steps)
        rot = _rot_perm(steps)
        x = pm.ppermute(mesh, x_blk, (ax0, ax1), skew_a)
        c = pm.ppermute(mesh, c_blk, (ax0, ax1), skew_b)
        dtype = x.flat[0].dtype
        acc_t, out_t = runtime.acc_dtype(dtype), runtime.out_dtype(dtype)
        acc = pm.map_members(mesh, lambda _, xv, cv: torch.zeros(
            (xv.shape[0], cv.shape[1]), dtype=acc_t, device=xv.device),
            x, c)
        for _ in range(steps):
            acc = pm.map_members(
                mesh, lambda _, xv, bv, cv, a: a.add_(
                    _mttkrp(xv, bv, cv, acc_t)), x, b_blk, c, acc)
            x = pm.ppermute(mesh, x, ax1, rot)
            c = pm.ppermute(mesh, c, ax0, rot)
        return pm.map_members(mesh, lambda _, a: a.to(out_t), acc)

    fn = _shard_map(mesh, local, (P(ax0, None, ax1), P(None, ax1),
                                  P(ax0, ax1)), P(ax0, ax1))

    def run(x, b, c):
        _require_divisible("mttkrp X rows (i)", x.shape[0], steps, ax0)
        _require_divisible("mttkrp X depth (l)", x.shape[2], steps, ax1)
        _require_divisible("mttkrp C rows (l)", c.shape[0], steps, ax0)
        _require_divisible("mttkrp B cols (j)", b.shape[1], steps, ax1)
        _require_divisible("mttkrp C cols (j)", c.shape[1], steps, ax1)
        return fn(x, b, c)

    return run


# ---------------------------------------------------------------------------
# Fused chains: every chain stage back to back on the members
# (KernelSpec.fused_systolic_lowering hooks — see core/fusion.py)
# ---------------------------------------------------------------------------

def fused_halo_chain(fused_plan, mesh) -> Callable:
    """Deep-halo schedule for stencil->stencil chains (conv2d ->
    jacobi2d, jacobi2d -> jacobi2d_9pt, ...).

    The chain shrinks the grid by ``(s_h, s_w)``, the sum of its stages'
    window shrinks.  The final output is sharded (ax0, ax1); each member
    imports its east and south deep-halo strips with ONE ppermute per
    axis (the south strip is the lower neighbour's top rows of its
    *extended* block, so its east halo rides along and covers the
    corner), members on the array boundary substitute the global tail
    strips, and every stage then runs on the member's extended block,
    the intermediate in the accumulator dtype (conv stages on B5, star
    stages on B6)."""
    from repro_torch.core import fusion

    ax0, ax1 = _space_axes(fused_plan.stage_plans[0])
    n0, n1 = mesh.shape[ax0], mesh.shape[ax1]
    descs = fusion.halo_stage_descs(fused_plan.chain)
    s_h, s_w = fusion.halo_shrink(fused_plan.chain)

    def local(x, bot, rgt, *wops):
        acc_t = runtime.acc_dtype(x.flat[0].dtype)
        xe = x
        if s_w:
            he = (pm.ppermute(mesh, pm.map_members(
                mesh, lambda _, v: v[:, :s_w], x), ax1,
                [(q + 1, q) for q in range(n1 - 1)]) if n1 > 1
                else pm.map_members(mesh, lambda _, v: v.new_zeros(
                    (v.shape[0], s_w)), x))

            def east(member, v, h, rg):
                row = pm.axis_index(mesh, member, ax0)
                if pm.axis_index(mesh, member, ax1) == n1 - 1:
                    bh = v.shape[0]
                    h = rg[row * bh:(row + 1) * bh]
                return torch.cat([v, h], dim=1)

            xe = pm.map_members(mesh, east, x, he, rgt)
        xx = xe
        if s_h:
            hs = (pm.ppermute(mesh, pm.map_members(
                mesh, lambda _, v: v[:s_h], xe), ax0,
                [(q + 1, q) for q in range(n0 - 1)]) if n0 > 1
                else pm.map_members(mesh, lambda _, v: v.new_zeros(
                    (s_h, v.shape[1])), xe))

            def south(member, v, h, bt, core):
                col = pm.axis_index(mesh, member, ax1)
                if pm.axis_index(mesh, member, ax0) == n0 - 1:
                    bw = core.shape[1]
                    h = bt[:, col * bw:col * bw + bw + s_w]
                return torch.cat([v, h], dim=0)

            xx = pm.map_members(mesh, south, xe, hs, bot, x)

        def stages(_, cur, *ws):
            for wi, desc in enumerate(descs):
                if desc[0] == "conv":
                    f = ws[wi] if cur.dtype == ws[wi].dtype \
                        else ws[wi].to(cur.dtype)
                    cur = _conv2d(cur.contiguous(), f.contiguous(), acc_t)
                else:
                    cur = _star(cur.contiguous(), ws[wi], desc[1], acc_t)
            return cur

        return pm.map_members(mesh, stages, xx, *wops)

    wspecs = tuple(
        P(None, None) if desc[0] == "conv" else P(None) for desc in descs)
    fn = _shard_map(mesh, local, (P(ax0, ax1), P(None, None),
                                  P(None, None), *wspecs), P(ax0, ax1))

    def run(*operands):
        stage_ops, _ = fusion.split_operands(fused_plan, operands)
        grid = stage_ops[0][0]
        wops = [*stage_ops[0][1:]]
        for ops in stage_ops[1:]:
            wops.extend(ops)
        hh, ww = grid.shape
        hf, wf = hh - s_h, ww - s_w
        _require_divisible("fused chain output rows", hf, n0, ax0)
        _require_divisible("fused chain output cols", wf, n1, ax1)
        if (n0 > 1 and s_h > hf // n0) or (n1 > 1 and s_w > wf // n1):
            raise ValueError(
                f"fused deep halo {s_h}x{s_w} exceeds the "
                f"{hf // n0}x{wf // n1} shard — a one-hop exchange can "
                "only import the adjacent shard; use fewer chips or a "
                "larger grid")
        out = fn(grid[:hf, :wf], grid[hf:, :], grid[:hf, wf:], *wops)
        return out.to(runtime.out_dtype(grid.dtype))

    return run


def fused_cannon_mm(fused_plan, mesh) -> Callable:
    """Back-to-back Cannon rings for dense->dense chains (the MLP
    up-projection -> down-projection pair).  Stage 1's accumulator lands
    unskewed at (i, j), the (i->ax0, k->ax1) sharding the next stage's
    left operand needs, so C never leaves the members: the interstage
    bias (sharded P(ax1)) and activation apply there, then C re-skews
    into the next ring."""
    from repro_torch.core import fusion

    ax0, ax1, steps = _require_square(
        fused_plan.stage_plans[0], mesh, "fused cannon chain")
    inter = fused_plan.interstage
    n_bound = len(fused_plan.chain.stages) - 1

    def local(*blks):
        it = iter(blks)
        a, b = next(it), next(it)
        dtype = a.flat[0].dtype
        acc_t, out_t = runtime.acc_dtype(dtype), runtime.out_dtype(dtype)

        def ring(plan, x, y):
            acc = _ring(plan, mesh, ax0, ax1, steps, x, y, acc_t)
            # the unfused stages' flush ladder: an int chain stays in the
            # int32 accumulator, so parity is bit-exact
            return pm.map_members(mesh, lambda _, c: c.to(out_t), acc)

        cur = ring(fused_plan.stage_plans[0], a, b)
        for bnd in range(n_bound):
            if fusion.interstage_has_bias(inter[bnd]):
                bias = next(it)
                cur = pm.map_members(
                    mesh, lambda _, c, bv, op=inter[bnd]:
                    fusion.interstage_apply(op, c, bv), cur, bias)
            else:
                cur = pm.map_members(
                    mesh, lambda _, c, op=inter[bnd]:
                    fusion.interstage_apply(op, c), cur)
            cur = ring(fused_plan.stage_plans[bnd + 1], cur, next(it))
        return cur

    in_specs = [P(ax0, ax1), P(ax0, ax1)]
    for bnd in range(n_bound):
        if fusion.interstage_has_bias(inter[bnd]):
            in_specs.append(P(ax1))
        in_specs.append(P(ax0, ax1))
    fn = _shard_map(mesh, local, tuple(in_specs), P(ax0, ax1))

    def run(*operands):
        stage_ops, _ = fusion.split_operands(fused_plan, operands)
        a, b = stage_ops[0]
        _require_divisible("fused cannon A rows", a.shape[0], steps, ax0)
        _require_divisible("fused cannon A cols", a.shape[1], steps, ax1)
        _require_divisible("fused cannon B cols", b.shape[1], steps, ax1)
        for ops in stage_ops[1:]:
            _require_divisible(
                "fused cannon stage cols", ops[0].shape[1], steps, ax1)
        return fn(*operands)

    return run


def fused_cannon_fft2d(fused_plan, mesh) -> Callable:
    """Both DFT stages of the 2-D FFT on ONE complex two-plane ring:
    after ring 1 the Y block sits unskewed at (i, j), the left-operand
    sharding ring 2 re-skews from, so Y never leaves the members.  Like
    ``cannon_fft2d`` it stays in the DFT form: the ring distributes the
    products of ``F_R``, ``X`` and ``F_C``."""
    plan = fused_plan.stage_plans[0]
    ax0, ax1, steps = _require_square(
        plan, mesh, "fused complex cannon (fft2d)")

    def local(fr_r, fr_i, x_r, x_i, fc_r, fc_i):
        yr, yi = _cring(plan, mesh, ax0, ax1, steps, fr_r, fr_i, x_r, x_i)
        return _cring(plan, mesh, ax0, ax1, steps, yr, yi, fc_r, fc_i)

    spec = P(ax0, ax1)
    fn = _shard_map(mesh, local, (spec,) * 6, (spec, spec))

    def run(*operands):
        x_re, x_im = operands[0], operands[1]
        r, c = x_re.shape
        _require_divisible("fused fft2d rows", r, steps, ax0)
        _require_divisible("fused fft2d cols", c, steps, ax1)
        fr_re, fr_im = fft2d._dft_planes(r, x_re.device)
        fc_re, fc_im = fft2d._dft_planes(c, x_re.device)
        return fn(fr_re, fr_im, x_re, x_im, fc_re, fc_im)

    return run


# ---------------------------------------------------------------------------
# GSPMD all-gather baselines (the "unconstrained compiler" references)
# ---------------------------------------------------------------------------

def allgather_mm(plan: "ExecutionPlan", mesh) -> Callable:
    """GSPMD-style baseline: all-gather the k-shards, then one local
    product on the hand GEMM."""
    return _allgather_dot(plan, mesh, batched=False)


def allgather_bmm(plan: "ExecutionPlan", mesh) -> Callable:
    """Batched all-gather baseline (batch axis unsharded)."""
    return _allgather_dot(plan, mesh, batched=True)


def _allgather_dot(plan: "ExecutionPlan", mesh, batched: bool) -> Callable:
    ax0, ax1 = _space_axes(plan)
    lead = 1 if batched else 0

    def local(a_blk, b_blk):
        b_full = pm.all_gather(mesh, b_blk, ax0, dim=lead)
        a_full = pm.all_gather(mesh, a_blk, ax1, dim=lead + 1)
        dtype = a_blk.flat[0].dtype
        acc_t, out_t = runtime.acc_dtype(dtype), runtime.out_dtype(dtype)
        return pm.map_members(
            mesh, lambda _, a, b: _gemm(plan, a, b, acc_t).to(out_t),
            a_full, b_full)

    spec = P(None, ax0, ax1) if batched else P(ax0, ax1)
    return _shard_map(mesh, local, (spec, spec), spec)


def _own_block(mesh, member, full, ax0, ax1):
    """The member's (row, col) block of a full (n0 * bh, n1 * bw) plane."""
    n0, n1 = mesh.shape[ax0], mesh.shape[ax1]
    bh, bw = full.shape[0] // n0, full.shape[1] // n1
    row = pm.axis_index(mesh, member, ax0)
    col = pm.axis_index(mesh, member, ax1)
    return full[row * bh:(row + 1) * bh, col * bw:(col + 1) * bw]


def allgather_stencil(plan: "ExecutionPlan", mesh) -> Callable:
    """Broadcast baseline for the star stencils: every member receives the
    full grid, runs all sweeps (B6) and keeps its own block.  The star
    comes from the recurrence's access functions, as ``halo_stencil``'s."""
    star, radius = _star_of(plan)
    padded = tuple((di + radius, dj + radius) for di, dj in star)
    ax0, ax1 = _space_axes(plan)
    n0, n1 = mesh.shape[ax0], mesh.shape[ax1]

    def local(grid, wts):
        return pm.map_members(mesh, lambda member, g, w: _own_block(
            mesh, member, _sweeps(g, w, padded), ax0, ax1), grid, wts)

    fn = _shard_map(mesh, local, (P(None, None), P(None, None)),
                    P(ax0, ax1))

    def run(grid, weights):
        h, w = grid.shape[0] - 2 * radius, grid.shape[1] - 2 * radius
        _require_divisible("stencil interior rows", h, n0, ax0)
        _require_divisible("stencil interior cols", w, n1, ax1)
        wts = weights if weights.dim() == 2 else weights[None, :]
        return fn(grid, wts).to(runtime.out_dtype(grid.dtype))

    return run


def _allgather_chain(plan: "ExecutionPlan", mesh, kernel, out_ndim,
                     out_len) -> Callable:
    """Shared broadcast baseline for the 1-D chains: every member receives
    the full operands, runs the whole problem on the hand kernel and keeps
    its own slice of the leading output axis."""
    axes, width = _chain(plan, mesh)

    def local(a, b):
        def own(member, x, y):
            full = kernel(x, y, runtime.acc_dtype(x.dtype))
            bl = full.shape[0] // width
            idx = pm.axis_index(mesh, member, axes)
            return full[idx * bl:(idx + 1) * bl]

        return pm.map_members(mesh, own, a, b)

    fn = _shard_map(mesh, local, (P(), P()),
                    P(axes, None) if out_ndim == 2 else P(axes))

    def run(a, b):
        _require_divisible("chain outputs", out_len(a, b), width,
                           "+".join(axes))
        return fn(a, b)

    return run


def allgather_conv2d(plan: "ExecutionPlan", mesh) -> Callable:
    """Broadcast baseline for the conv2d chain: the full image on every
    member, B5 over it, each keeping its own row block."""
    return _allgather_chain(
        plan, mesh, _conv2d, 2,
        lambda img, filt: img.shape[0] - filt.shape[0] + 1)


def allgather_fir(plan: "ExecutionPlan", mesh) -> Callable:
    """Broadcast baseline for the FIR chain: the full signal on every
    member, B3 over it, each keeping its own sample block."""
    return _allgather_chain(
        plan, mesh, _fir, 1,
        lambda x, taps: x.shape[0] - taps.shape[0] + 1)


def allgather_mttkrp(plan: "ExecutionPlan", mesh) -> Callable:
    """All-gather baseline for mttkrp: gather X's l-shards (ax1) and C's
    l-shards (ax0), then one local three-operand contraction on B7."""
    ax0, ax1 = _space_axes(plan)

    def local(x_blk, b_blk, c_blk):
        x_full = pm.all_gather(mesh, x_blk, ax1, dim=2)
        c_full = pm.all_gather(mesh, c_blk, ax0, dim=0)
        dtype = x_blk.flat[0].dtype
        acc_t, out_t = runtime.acc_dtype(dtype), runtime.out_dtype(dtype)
        return pm.map_members(
            mesh, lambda _, x, b, c: _mttkrp(x, b, c, acc_t).to(out_t),
            x_full, b_blk, c_full)

    fn = _shard_map(mesh, local, (P(ax0, None, ax1), P(None, ax1),
                                  P(ax0, ax1)), P(ax0, ax1))

    def run(x, b, c):
        n0, n1 = mesh.shape[ax0], mesh.shape[ax1]
        _require_divisible("mttkrp X rows (i)", x.shape[0], n0, ax0)
        _require_divisible("mttkrp X depth (l)", x.shape[2], n1, ax1)
        _require_divisible("mttkrp C rows (l)", c.shape[0], n0, ax0)
        _require_divisible("mttkrp B cols (j)", b.shape[1], n1, ax1)
        return fn(x, b, c)

    return run


def allgather_fft2d(plan: "ExecutionPlan", mesh) -> Callable:
    """Broadcast baseline for fft2d: both planes on every member, the
    hand fft2d (the fused kernel, the FFT kernel, or the composition over
    B1, as ``runtime.fft2d_route`` picks for the whole grid) over the
    whole grid, each keeping its own (row, col) block of each plane."""
    ax0, ax1 = _space_axes(plan)
    n0, n1 = mesh.shape[ax0], mesh.shape[ax1]

    def local(xr, xi):
        def own(member, r, i):
            zr, zi = _fft2d(plan, r, i)
            return (_own_block(mesh, member, zr, ax0, ax1),
                    _own_block(mesh, member, zi, ax0, ax1))

        return pm.map_members(mesh, own, xr, xi)

    fn = _shard_map(mesh, local, (P(None, None), P(None, None)),
                    (P(ax0, ax1), P(ax0, ax1)))

    def run(x_re, x_im):
        _require_divisible("fft2d rows", x_re.shape[0], n0, ax0)
        _require_divisible("fft2d cols", x_re.shape[1], n1, ax1)
        return fn(x_re, x_im)

    return run
