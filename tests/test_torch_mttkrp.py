"""The tensor-core MTTKRP kernel's route and arithmetic, on the CPU.

* ``runtime.mttkrp_route`` / ``mttkrp_tile`` (their constants are the
  CUDA source's): every dtype goes to the tensor-core kernel
  (``runtime.MttkrpTile``) at the bench, smoke and (32, 48, 64, 64)
  shapes (int16 and int32 as int8 limbs); rows of X or B that allow no
  4-byte copies (int8 L % 4 != 0 or J % 4 != 0, int16 L or J odd, or an
  operand off its boundary) and a C tile past the shared memory go to
  the CUDA-core kernel (``build.MTTKRP_TILE``).  K is split over 8 blocks of
  a cluster where every rank keeps 16 k, else over the largest power of
  two that does.
* The kernel's float32 arithmetic, emulated in torch: for each k, T_k =
  X[:, k, :] @ C from TF32 products summed in fp32 (3xTF32: lo*hi + hi*lo
  + hi*hi, each operand split as hi = rna_tf32(x) and lo = x - hi, which
  the tensor cores read truncated to TF32), then acc += B[k] * T_k in
  fp32.  Held against the JAX package's
  ``repro.kernels.ref.mttkrp`` on the same numpy operands it falls within
  ``recurrences.float_bound``; with one TF32 product (hi*hi alone) it
  does not.
* The kernel's integer arithmetic (exact T_k, then acc += B[k] * T_k
  wrapping modulo 2^32) equals the reference's int32 einsum bitwise on
  int8 operands whose int32 sums wrap.  For int16 and int32 the same
  with T_k from int8 limbs (top limb signed, the others unsigned): the
  limb products grouped by shift into one s32 sum each (int32 a step of
  32 l at a time), every sum inside int32, then folded modulo 2^32;
  bitwise equal to the reference at full-range and extreme operands whose
  exact sums overflow int32.

The kernels themselves run only on the card: ``tests/test_torch_gpu.py``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core import Target, best_plan  # noqa: E402
from repro_torch.kernels import build, mttkrp, ref, registry, runtime  # noqa: E402
from repro_torch.launch import recurrences  # noqa: E402
from test_torch_recurrences import _tf32  # noqa: E402

SINGLE_CHIP = Target(name="single_chip", mesh_shape=(1, 1))
#: (I, J, K, L): the bench size, the registry's smoke size, a small one
TC_SHAPES = ((4096, 400, 256, 256), (128, 64, 16, 8), (32, 48, 64, 64))


@pytest.mark.parametrize("shape", TC_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", ("float32", "int8", "int16", "int32"))
def test_route_by_dtype_and_shape(shape, dtype):
    """Every dtype on the tensor cores (int16 and int32 as int8 limbs;
    16-byte copies where a row of X is a whole number of them); the
    plan's route is the same."""
    dt = getattr(torch, dtype)
    route = runtime.mttkrp_route(shape, dt)
    row = shape[3] * dt.itemsize
    assert route == runtime.MttkrpTile(
        split=runtime.mttkrp_split(shape[2]),
        copy=16 if row % 16 == 0 else 4)
    plan = best_plan(registry.get("mttkrp").builder(*shape, dtype),
                     SINGLE_CHIP)
    assert runtime.mttkrp_tile(plan).tile == (route or build.MTTKRP_TILE)


@pytest.mark.parametrize("dtype,shape,x_ptr,b_ptr,want", [
    ("int16", (37, 45, 7, 5), 0, 0, None),     # odd L: rows of 10 bytes
    ("int16", (37, 46, 7, 6), 0, 0, 4),        # rows of 12 bytes
    ("int16", (16, 9, 4, 32), 0, 0, None),     # odd J: B's rows of 18 bytes
    ("int16", (16, 8, 4, 32), 2, 0, None),     # X two bytes off
    ("int16", (16, 8, 4, 32), 4, 0, 4),
    ("int16", (16, 8, 4, 32), 0, 2, None),     # B two bytes off
    ("int16", (64, 80, 4, 1024), 0, 0, 16),    # C's tile 160 KB: fits
    ("int16", (64, 80, 4, 1026), 0, 0, None),  # past the shared memory
    ("int32", (37, 45, 7, 5), 0, 0, 4),        # any L, any J
    ("int32", (16, 9, 4, 32), 0, 0, 16),
    ("int32", (64, 80, 4, 512), 0, 0, 16),
    ("int32", (64, 80, 4, 513), 0, 0, None),
], ids=str)
def test_wider_integers_route_by_alignment_and_fit(dtype, shape, x_ptr,
                                                   b_ptr, want):
    """int16 and int32 take the tensor cores where X's and B's rows allow
    4-byte copies and C's limb planes fit beside the ring, else the CUDA
    cores."""
    dt = getattr(torch, dtype)
    route = runtime.mttkrp_route(shape, dt, x_ptr, b_ptr)
    assert (route and route.copy) == want
    fits = runtime.mttkrp_smem(shape[3], dt) <= runtime.MTTKRP_TC_MAX_SMEM
    assert fits or route is None


def test_runtime_geometry_matches_the_cuda_source():
    """runtime's MTTKRP_TC_* constants are the tensor-core kernel's kTc*
    ones, which ``mttkrp_route`` sizes shared memory by."""
    src = build.HPC_SOURCE.read_text()
    k = {name: int(v) for name, v in
         re.findall(r"constexpr int kTc(\w+) = (\d+);", src)}
    assert runtime.MTTKRP_TC_TILE == (k["Rows"], k["Cols"])
    assert (runtime.MTTKRP_TC_CHUNK, runtime.MTTKRP_TC_STAGES,
            runtime.MTTKRP_TC_B_SLOTS, runtime.MTTKRP_TC_PAD,
            runtime.MTTKRP_TC_MAX_CLUSTER, runtime.MTTKRP_TC_MAX_SMEM) == (
        k["Chunk"], k["Stages"], k["BSlots"], k["Pad"], k["MaxCluster"],
        k["MaxSmem"])


@pytest.mark.parametrize("shape,x_ptr,b_ptr,want", [
    ((37, 45, 7, 5), 0, 0, None),       # int8 rows of X of 5 bytes
    ((16, 8, 4, 6), 0, 0, None),        # of 6 bytes
    ((16, 8, 4, 12), 0, 0, 4),          # 4-byte aligned rows
    ((16, 8, 4, 32), 1, 0, None),       # X one byte off its boundary
    ((16, 8, 4, 32), 4, 0, 4),
    ((16, 8, 4, 32), 16, 0, 16),
    ((16, 10, 4, 32), 0, 0, None),      # rows of B of 10 bytes
    ((16, 8, 4, 32), 0, 2, None),       # B two bytes off
], ids=str)
def test_int8_route_follows_the_alignment_of_x_and_b(shape, x_ptr, b_ptr,
                                                     want):
    route = runtime.mttkrp_route(shape, torch.int8, x_ptr, b_ptr)
    assert (route and route.copy) == want


def test_float32_rows_take_4_byte_copies_and_c_must_fit():
    """float32 X off a 16-byte boundary copies 4 bytes at a time; an L
    whose C tile (hi and lo in float32, an eighth of that in int8) does not
    fit beside the ring goes to the CUDA cores."""
    assert runtime.mttkrp_route((37, 45, 7, 5), torch.float32).copy == 4
    assert runtime.mttkrp_route((64, 80, 4, 32), torch.float32, 4).copy == 4
    assert runtime.mttkrp_smem(256, torch.float32) == \
        2 * 80 * 1024 + 3 * 128 * 160 + 4 * 80 * 4
    assert runtime.mttkrp_smem(257, torch.float32) > \
        runtime.MTTKRP_TC_MAX_SMEM
    assert runtime.mttkrp_route((64, 80, 4, 257), torch.float32) is None
    assert runtime.mttkrp_route((64, 80, 4, 2048), torch.int8).copy == 16
    assert runtime.mttkrp_route((64, 80, 4, 2052), torch.int8) is None


@pytest.mark.parametrize("nk,want", [(256, 8), (130, 8), (121, 8),
                                     (120, 4), (64, 4), (40, 2), (31, 2),
                                     (30, 1), (7, 1), (1, 1)], ids=str)
def test_split_is_the_largest_power_of_two_leaving_16_k_a_rank(nk, want):
    """K split over 8 blocks of a cluster (the portable maximum) where
    every rank keeps 16 k or more, else over the largest power of two
    that does; no rank is left without k."""
    split = runtime.mttkrp_split(nk)
    assert split == want
    assert -(-nk // split) >= runtime.MTTKRP_MIN_RANK_K or split == 1
    assert (split - 1) * -(-nk // split) < nk


def test_cpu_tensors_run_the_plain_version_whatever_the_tile():
    gen = torch.Generator().manual_seed(0)
    x, b, c = (torch.randn(s, generator=gen)
               for s in ((9, 4, 6), (4, 5), (6, 5)))
    before = dict(mttkrp.variants), mttkrp.launches
    got = mttkrp.mttkrp(x, b, c, tiles=runtime.MttkrpTile(2, 16))
    assert torch.equal(got, ref.mttkrp(x, b, c))
    assert (dict(mttkrp.variants), mttkrp.launches) == before


def _numpy_operands(shape, dtype, seed, low=None, high=None):
    ni, nj, nk, nl = shape
    rng = np.random.default_rng(seed)
    shapes = ((ni, nk, nl), (nk, nj), (nl, nj))
    if dtype == "float32":
        return [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return [rng.integers(low, high + 1, s).astype(np.int8) for s in shapes]


def _truncated(t):
    """``t`` with its significand cut to TF32's 10 bits, as the tensor
    cores read a .tf32 operand."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _emulate_f32(x, b, c, passes):
    """The tensor-core kernel's float32 arithmetic (module docstring):
    ``passes`` = 3 for 3xTF32, 1 for a single TF32 product."""
    xh, ch = _tf32(x), _tf32(c)
    xl, cl = _truncated(x - xh), _truncated(c - ch)
    acc = torch.zeros((x.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(x.shape[1]):
        t = xh[:, k, :] @ ch
        if passes == 3:
            t = (xl[:, k, :] @ ch + xh[:, k, :] @ cl) + t
        acc = acc + b[k] * t
    return acc


def test_3xtf32_emulation_is_within_float_bound_and_tf32_is_not():
    shape = (32, 48, 64, 64)
    spec = registry.get("mttkrp")
    rec = spec.builder(*shape, "float32")
    arrays = _numpy_operands(shape, "float32", seed=5)
    ops = [torch.from_numpy(a) for a in arrays]
    want = torch.from_numpy(np.array(
        jax_ref.mttkrp(*(jnp.asarray(a) for a in arrays))))
    err3, ok3 = recurrences.compare(spec, rec, ops, _emulate_f32(*ops, 3),
                                    want)
    err1, ok1 = recurrences.compare(spec, rec, ops, _emulate_f32(*ops, 1),
                                    want)
    bound = recurrences.float_bound(spec, rec, ops)
    assert ok3 and err3 < bound.min().item() / 10
    assert not ok1 and err1 > 10 * err3


def _emulate_int(x, b, c):
    """The tensor-core kernel's integer arithmetic: T_k exact (the int8
    products' s32 sums are), acc += B[k] * T_k modulo 2^32."""
    x, b, c = (t.to(torch.int64) for t in (x, b, c))
    acc = torch.zeros((x.shape[0], b.shape[1]), dtype=torch.int64)
    for k in range(x.shape[1]):
        acc = (acc + b[k] * (x[:, k, :] @ c)) & 0xFFFFFFFF
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


@pytest.mark.parametrize("low,high", [(110, 127), (-128, -110), (-128, 127)],
                         ids=str)
def test_two_step_int8_wraps_like_the_reference(low, high):
    """int8 operands whose int32 sums wrap (2048 terms of at least 110^3
    in magnitude, same sign), and full-range ones: the two-step form
    equals the reference's int32 einsum bitwise."""
    shape = (16, 24, 32, 64)
    arrays = _numpy_operands(shape, "int8", seed=6, low=low, high=high)
    want = np.asarray(jax_ref.mttkrp(*(jnp.asarray(a) for a in arrays)))
    got = _emulate_int(*(torch.from_numpy(a) for a in arrays))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.einsum("ikl,kj,lj->ij", *(a.astype(np.int64) for a in arrays))
    if low > 0 or high < 0:
        assert (np.abs(exact) >= 2**31).all()


def _limbs(t, n):
    """``t``'s n int8 limbs, low first: unsigned bytes, the top one
    signed (``t = sum_p 2^(8p) t_p``)."""
    t = t.to(torch.int64)
    return [(t >> (8 * p)) & 0xFF for p in range(n - 1)] + [t >> (8 * (n - 1))]


def _emulate_limbs(x, b, c):
    """The tensor-core kernel's int16 / int32 arithmetic: for each k the
    limb products X_p C_q with p + q < 4, each an exact int8 product,
    summed by shift p + q into one s32 sum each (asserted inside int32)
    and folded into T_k modulo 2^32 (int16 over all of l; int32 a step of
    32 l at a time, as the kernel folds each group as it completes), then
    acc += B[k] * T_k modulo 2^32."""
    n = x.element_size()
    xl, cl = _limbs(x, n), _limbs(c, n)
    acc = torch.zeros((x.shape[0], b.shape[1]), dtype=torch.int64)
    b = b.to(torch.int64)
    nl = x.shape[2]
    step = 32 if n == 4 else nl
    for k in range(x.shape[1]):
        t = torch.zeros_like(acc)
        for l0 in range(0, nl, step):
            ls = slice(l0, l0 + step)
            for shift in range(min(2 * n - 1, 4)):
                sums = sum(xl[p][:, k, ls] @ cl[shift - p][ls]
                           for p in range(n) if 0 <= shift - p < n)
                assert (sums.abs() < 2**31).all()
                t = (t + (sums << (8 * shift))) & 0xFFFFFFFF
        acc = (acc + b[k] * t) & 0xFFFFFFFF
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


def _wide_operands(shape, dtype, fill, seed):
    ni, nj, nk, nl = shape
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    out = []
    for s in ((ni, nk, nl), (nk, nj), (nl, nj)):
        if fill == "full":
            out.append(rng.integers(info.min, info.max, s, endpoint=True,
                                    dtype=np.int64).astype(dtype))
        elif fill == "mixed":
            out.append(rng.choice(np.array([info.min, info.max], dtype),
                                  size=s))
        else:
            out.append(np.full(s, getattr(info, fill), dtype))
    return out


@pytest.mark.parametrize("fill", ["full", "min", "max", "mixed"])
@pytest.mark.parametrize("dtype", ["int16", "int32"])
def test_limb_products_wrap_like_the_reference(dtype, fill):
    """int16 / int32 operands at full range and at their extremes (all
    -32768 or 32767; all -2^31 or 2^31 - 1; the two mixed), whose exact
    sums overflow int32: the limb form equals the reference's int32
    einsum bitwise."""
    shape = (16, 24, 8, 64)
    arrays = _wide_operands(shape, np.dtype(dtype), fill, seed=8)
    want = np.asarray(jax_ref.mttkrp(*(jnp.asarray(a) for a in arrays)))
    got = _emulate_limbs(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.einsum("ikl,kj,lj->ij", *(a.astype(object) for a in arrays))
    assert (np.abs(exact.astype(float)) >= 2**31).any()


@pytest.mark.parametrize("dtype", ["int16", "int32"])
def test_limb_sums_stay_inside_int32_at_every_l_that_fits(dtype):
    """The largest L the shared memory admits (1024 in int16, 512 in
    int32): no shift's s32 sum of limb products can leave int32, whatever
    the operands, so the kernel never depends on how wgmma overflows."""
    dt = getattr(torch, dtype)
    n = dt.itemsize
    nl = max(l for l in range(4, 4096, 2)
             if runtime.mttkrp_smem(l, dt) <= runtime.MTTKRP_TC_MAX_SMEM)
    assert nl == {2: 1024, 4: 512}[n]
    top = 128  # |signed top limb| <= 128, unsigned limbs <= 255
    worst = max(sum((top if p == n - 1 else 255) * (top if s - p == n - 1
                                                    else 255)
                    for p in range(n) if 0 <= s - p < n)
                for s in range(min(2 * n - 1, 4)))
    assert worst * nl < 2**31

