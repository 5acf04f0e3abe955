"""The port's integer GEMMs above 16 rows (B1 mm, B2 bmm in int8, int16 and
int32 -> int32) on the tensor cores, checked on the CPU.

* Routes: every integer mm / bmm of more than 16 rows whose operands TMA
  can address takes the tensor-core kernel (``runtime.TcTile``) at the
  recurrence path's shapes and the paper's MM/BMM table; operands TMA
  cannot address (a contiguous A whose K leaves no whole 16-byte row, a
  row-major B whose N does, a base off its 16-byte boundary) stay on the
  tiled kernel, as does a K longer than 8 ranks may reduce.
* Configurations: the integer tiles fit in shared memory, their split
  fills the card within one wave, and no rank reduces more K than
  ``TC_INT_MAX_RANK_K``, the most at which no s32 accumulator set of limb
  products can leave int32 (computed here from the limbs' ranges).
* Arithmetic: the kernel's limb-plane layout (``limb_planes_kernel``),
  its limb products summed by shift into s32 sets (asserted inside int32),
  each set folded into uint32 and the split's partial tiles added modulo
  2^32, emulated in torch, equal the JAX package's ``repro.kernels.ref``
  ``matmul`` / ``bmm`` bitwise, at full range and at each dtype's
  extremes.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core.mapper import best_plan  # noqa: E402
from repro_torch.kernels import build, registry, runtime  # noqa: E402
from repro_torch.kernels.planned import PLANNED_TARGET  # noqa: E402

INTS = (torch.int8, torch.int16, torch.int32)
TILED = (64, 32, 32)

#: the integer GEMMs the recurrence path runs: the registry's smoke shapes
#: of mm and bmm, and the paper's MM/BMM table (the registry's bench cases)
SMOKE = (("mm", (256, 256, 256)), ("bmm", (4, 128, 128, 64)))
PAPER = tuple((name, getattr(torch, dtype), args)
              for name in ("mm", "bmm")
              for dtype, args in registry.get(name).bench_cases
              if dtype.startswith("int"))


def _meta(kind, shape, dtype, col_major=False):
    """Meta operands (shapes and strides, no data) of a GEMM shape."""
    (m, n, k), lead = shape[-3:], shape[:-3]
    a = torch.empty((*lead, m, k), dtype=dtype, device="meta")
    if col_major:
        b = torch.empty((*lead, n, k), dtype=dtype,
                        device="meta").transpose(-1, -2)
    else:
        b = torch.empty((*lead, k, n), dtype=dtype, device="meta")
    return a, b


def _route(kind, shape, dtype, col_major=False):
    """The configuration the registry's ``tiles`` gives (as
    ``execute_plan`` asks) for meta operands of a GEMM shape."""
    a, b = _meta(kind, shape, dtype, col_major)
    spec = registry.get(kind)
    plan = best_plan(spec.builder(*shape, str(dtype).removeprefix("torch.")),
                     PLANNED_TARGET)
    return spec.tiles(plan, a, b).tile


def _holds_the_int_rule(tile, shape, dtype):
    """The integer configuration rule (``runtime.tc_tile``): 128-row tiles,
    int8 256 columns wide from N = ``TC_WIDE_N`` up and 64 below, int16
    and int32 64; K split over the blocks of a cluster only while the grid
    stays within one block an SM and each rank keeps
    ``TC_MIN_RANK_KTILES`` k-tiles, unless a rank's K must shrink to
    ``TC_INT_MAX_RANK_K``; the deepest ring a rank's k-tiles fill."""
    m, n, k = shape[-3:]
    batch = shape[0] if len(shape) == 4 else 1
    if dtype == torch.int8:
        assert (tile.bm, tile.bn) == (128,
                                      256 if n >= runtime.TC_WIDE_N else 64)
    else:
        assert (tile.bm, tile.bn) == (128, 64)
    ktiles = -(-k * dtype.itemsize // runtime.TC_ROW_BYTES)
    ktper = -(-ktiles // tile.split)
    assert 1 <= tile.split <= runtime.TC_MAX_CLUSTER
    assert (tile.split - 1) * ktper < ktiles
    assert runtime.tc_rank_k(k, dtype, tile.split) <= \
        runtime.TC_INT_MAX_RANK_K[dtype]
    assert tile.split == 1 or (tile.blocks(m, n, batch) <= runtime.SMS
                               and ktper >= runtime.TC_MIN_RANK_KTILES)
    assert tile.stages == min(runtime.TC_MAX_STAGES, max(2, ktper))
    assert tile.smem(dtype) <= runtime.TC_MAX_SMEM


@pytest.mark.parametrize("kind,shape", SMOKE, ids=[f"{k}{s}" for k, s in SMOKE])
@pytest.mark.parametrize("dtype", INTS, ids=str)
@pytest.mark.parametrize("col_major", [False, True], ids=["row", "col"])
def test_smoke_integer_gemms_take_the_tensor_cores(kind, shape, dtype,
                                                   col_major):
    tile = _route(kind, shape, dtype, col_major)
    assert isinstance(tile, runtime.TcTile)
    _holds_the_int_rule(tile, shape, dtype)


@pytest.mark.parametrize("kind,dtype,shape", PAPER,
                         ids=[f"{k}-{d}-{s}" for k, d, s in PAPER])
def test_paper_integer_gemms_take_the_tensor_cores(kind, dtype, shape):
    """The paper's MM table (int8 10240^3, int16 9600^3, int32 8192^3) and
    BMM table (64 x 4096^3): one 128 x 256 or 128 x 64 tile a block, no
    split (the tiles fill the card many times over), a ring of 4."""
    tile = _route(kind, shape, dtype)
    assert isinstance(tile, runtime.TcTile)
    _holds_the_int_rule(tile, shape, dtype)
    assert tile.split == 1 and tile.stages == runtime.TC_MAX_STAGES
    assert tile.blocks(*shape[-3:-1], shape[0] if kind == "bmm" else 1) \
        >= 20 * runtime.SMS


@pytest.mark.parametrize("dtype", INTS, ids=str)
def test_integer_operands_tma_cannot_address_take_the_tiled_kernel(dtype):
    """A contiguous A whose rows are no whole 16-byte units (int8 K % 16,
    int16 K % 8, int32 K % 4), a row-major B whose N leaves the same, a B
    one element off its 16-byte boundary: the tensor cores all the same,
    through the limb pre-pass, which reads any layout the GEMMs read and
    writes planes TMA addresses (never the cp.async producer, which is
    the floats'), as do A in padded rows (the attention values' layout)
    at the same K and a column-major B.  Only an integer K past 8 ranks'
    ``TC_INT_MAX_RANK_K`` stays on the tiled tile
    (``test_largest_admitted_k_cannot_overflow_an_s32_set``)."""
    unit = 16 // dtype.itemsize
    plain = runtime.TcTile
    for k in (8 * unit, 8 * unit + unit // 2):
        a = torch.zeros((40, k), dtype=dtype)
        for b in (torch.zeros((k, 8 * unit), dtype=dtype),
                  torch.zeros((8 * unit, k), dtype=dtype).t()):
            got = runtime.gemm_tile(a, b, TILED)
            assert isinstance(got, plain) and got.producer == "tma", \
                (k, b.stride())
            runtime.check_tc(got, a, b)
        padded = torch.zeros((40, 9 * unit), dtype=dtype)[:, :k]
        assert runtime.a_pitch(padded) == 9 * unit
        assert isinstance(runtime.gemm_tile(
            padded, torch.zeros((k, 8 * unit), dtype=dtype), TILED),
            runtime.TcTile)
    a = torch.zeros((40, 8 * unit), dtype=dtype)
    odd_n = torch.zeros((8 * unit, 8 * unit + unit // 2), dtype=dtype)
    assert runtime.gemm_tile(a, odd_n, TILED).producer == "tma"
    flat = torch.zeros(8 * unit * 8 * unit + 1, dtype=dtype)
    offset = flat[1:].view(8 * unit, 8 * unit)
    assert runtime.gemm_tile(a, offset, TILED).producer == "tma"
    runtime.check_tc(runtime.gemm_tile(a, offset, TILED), a, offset)
    # K past 8 ranks of the largest admitted K: the tiled tile
    long_k = 8 * runtime.TC_INT_MAX_RANK_K[dtype] + 128
    assert runtime.gemm_tile(
        torch.empty((40, long_k), dtype=dtype, device="meta"),
        torch.empty((long_k, 64), dtype=dtype, device="meta"),
        TILED) == TILED
    # 16 rows stay on the skinny kernel
    assert isinstance(runtime.gemm_tile(torch.zeros((16, 8 * unit),
                                                    dtype=dtype),
                                        torch.zeros((8 * unit, 8 * unit),
                                                    dtype=dtype), TILED),
                      runtime.SkinnyTile)


def _worst_per_k(n):
    """The most one element of K adds to any s32 set of limb products of
    n-byte integers: the unsigned limbs reach 255, the signed top one
    -128, and set s sums the pairs p + q = s (s <= 3)."""
    top = 128

    def limb(p):
        return top if p == n - 1 else 255

    return max(sum(limb(p) * limb(s - p) for p in range(n) if 0 <= s - p < n)
               for s in range(min(2 * n - 1, 4)))


@pytest.mark.parametrize("dtype", INTS, ids=str)
def test_largest_admitted_k_cannot_overflow_an_s32_set(dtype):
    """``TC_INT_MAX_RANK_K`` (and ``kTc*MaxRankK`` in the source) is the
    most K at which no set's s32 sum can leave int32, whatever the
    operands; ``tc_tile`` splits K until a rank stays within it (8 ranks
    at the most, beyond which the tiled kernel runs) and ``check_tc``
    refuses a launch whose rank would reduce more."""
    n = dtype.itemsize
    worst = _worst_per_k(n)
    assert worst == {1: 2**14, 2: 65280, 4: 195330}[n]
    limit = runtime.TC_INT_MAX_RANK_K[dtype]
    assert limit == (2**31 - 1) // worst
    assert limit * worst <= 2**31 - 1 < (limit + 1) * worst
    src = build.SOURCE.read_text()
    name = {1: "I8", 2: "I16", 4: "I32"}[n]
    assert re.search(rf"constexpr int kTc{name}MaxRankK = {limit};", src)
    e = runtime.TC_ROW_BYTES // n
    most = limit // e * e  # whole k-tiles a rank
    bn = runtime.TC_TILES[dtype][0][1]
    runtime.check_tc(runtime.TcTile(128, bn, 4, 1),
                     torch.zeros((130, most), dtype=dtype),
                     torch.zeros((most, 144), dtype=dtype))
    # one k-tile more must split, and a K past 8 ranks has no tile
    longer = runtime.tc_tile(4096, 4096, most + e, dtype)
    assert longer.split >= 2
    assert runtime.tc_rank_k(most + e, dtype, longer.split) <= limit
    assert runtime.tc_tile(130, 144, 8 * most + 8 * e, dtype) is None
    a = torch.zeros((130, most + e), dtype=dtype)
    b = torch.zeros((most + e, 144), dtype=dtype)
    with pytest.raises(ValueError, match="tensor-core"):
        runtime.check_tc(runtime.TcTile(128, bn, 4, 1), a, b)


def test_integer_tiles_fit_in_shared_memory_and_the_split_fills_the_card():
    """Every compiled integer tile fits with the deepest ring; at the
    registry's smoke mm (4 or 8 output tiles of 256^3) int32's 8 k-tiles
    split over 2 blocks, int8's 2 and int16's 4 k-tiles too few to split;
    a tall-K product of few tiles splits over up to ``TC_MAX_SPLIT``
    blocks within one wave."""
    for dtype in INTS:
        for bm, bn in runtime.TC_TILES[dtype]:
            tile = runtime.TcTile(bm, bn, runtime.TC_MAX_STAGES)
            assert tile.smem(dtype) <= runtime.TC_MAX_SMEM
    assert runtime.tc_tile(256, 256, 256, torch.int8) == runtime.TcTile(
        128, 64, 2, 1)
    assert runtime.tc_tile(256, 256, 256, torch.int16) == runtime.TcTile(
        128, 64, 4, 1)
    assert runtime.tc_tile(256, 256, 256, torch.int32) == runtime.TcTile(
        128, 64, 4, 2)
    for dtype in INTS:
        tile = runtime.tc_tile(256, 512, 8192, dtype)
        assert tile.split == runtime.TC_MAX_SPLIT
        assert tile.blocks(256, 512) <= runtime.SMS


@pytest.mark.parametrize("dtype", INTS, ids=str)
@pytest.mark.parametrize("col_major", [0, 1], ids=["row", "col"])
def test_limb_planes_scratch_holds_each_operand_the_kernel_cannot_read(
        dtype, col_major):
    """The wrapper's scratch for the pre-pass: [batch, rows, k-tiles x
    128] bytes for every operand but an int8 K-major one (A; a
    column-major B) that TMA can address (K = 320), which TMA reads as it
    is; at K = 300 (int8 rows of 300 bytes) the pre-pass writes planes of
    that one too."""
    from repro_torch.kernels import widesa_mm

    batch, m, n = 3, 40, 24
    for k in (320, 300):
        a = torch.empty((batch, m, k), dtype=dtype, device="meta")
        b = torch.empty((batch, n, k) if col_major else (batch, k, n),
                        dtype=dtype, device="meta")
        if col_major:
            b = b.transpose(1, 2)
        planes = widesa_mm.limb_planes(a, b, batch, m, n, k, col_major, k)
        row = -(-k * dtype.itemsize // 128) * 128
        plane = dtype.itemsize > 1 or k % 16 != 0
        want = ((batch, m, row) if plane else None,
                (batch, n, row) if plane or not col_major else None)
        assert tuple(None if p is None else tuple(p.shape)
                     for p in planes) == want
        assert all(p is None or p.dtype == torch.uint8 for p in planes)


# ---------------------------------------------------------------------------
# the arithmetic, emulated
# ---------------------------------------------------------------------------

def _planes(t, k):
    """``limb_planes_kernel``'s output for a K-major [rows, K] operand:
    [rows, k-tiles x 128] bytes, each 128-byte k-tile one plane of 128 /
    size bytes a limb (byte p of each value at p (128 / size) + j), values
    past K zero."""
    n = t.element_size()
    e = runtime.TC_ROW_BYTES // n
    units = -(-k // e)
    v = torch.zeros((t.shape[0], units * e), dtype=torch.int64)
    v[:, :k] = t.to(torch.int64)
    out = torch.zeros((t.shape[0], units, runtime.TC_ROW_BYTES),
                      dtype=torch.uint8)
    for p in range(n):
        out[:, :, p * e:(p + 1) * e] = ((v >> (8 * p)) & 0xFF).to(
            torch.uint8).view(t.shape[0], units, e)
    return out.view(t.shape[0], -1)


def _limb(planes, p, n, tiles):
    """Limb p of the k-tiles ``tiles`` as the tensor cores read its bytes:
    unsigned (.u8), the top limb signed (.s8)."""
    e = runtime.TC_ROW_BYTES // n
    rows = planes.shape[0]
    x = planes.view(rows, -1, runtime.TC_ROW_BYTES)[:, tiles,
                                                    p * e:(p + 1) * e]
    x = x.reshape(rows, -1).to(torch.int64)
    return x - 256 * (x >= 128) if p == n - 1 else x


def _emulate(a, b, split):
    """The tensor-core kernel's integer arithmetic on [M, K] @ [K, N]: the
    limb planes of A and of B^T; for each rank's k-tiles the products of
    limbs p, q with p + q <= 3, summed by shift into one s32 set each
    (asserted inside int32, as the launcher's K bound promises), folded
    modulo 2^32; the ranks' partial tiles added modulo 2^32."""
    n = a.element_size()
    k = a.shape[1]
    pa, pb = _planes(a, k), _planes(b.t(), k)
    units = pa.shape[1] // runtime.TC_ROW_BYTES
    ktper = -(-units // split)
    total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64)
    for rank in range(split):
        tiles = slice(rank * ktper, min(units, (rank + 1) * ktper))
        part = torch.zeros_like(total)
        for shift in range(min(2 * n - 1, 4)):
            s = sum(_limb(pa, p, n, tiles) @ _limb(pb, shift - p, n, tiles).t()
                    for p in range(n) if 0 <= shift - p < n)
            assert (s.abs() < 2**31).all()
            part = (part + (s << (8 * shift))) & 0xFFFFFFFF
        total = (total + part) & 0xFFFFFFFF
    return torch.where(total >= 2**31, total - 2**32, total).to(torch.int32)


def _ints(shape, dtype, fill, rng):
    info = np.iinfo(dtype)
    if fill == "full":
        return rng.integers(info.min, info.max, shape, endpoint=True,
                            dtype=np.int64).astype(dtype)
    if fill == "mixed":
        return rng.choice(np.array([info.min, info.max], dtype), size=shape)
    return np.full(shape, getattr(info, fill), dtype)


@pytest.mark.parametrize("fill", ["full", "min", "max", "mixed"])
@pytest.mark.parametrize("dtype", ["int8", "int16", "int32"])
@pytest.mark.parametrize("split", [1, 3])
def test_limb_arithmetic_equals_the_reference_matmul(dtype, fill, split):
    """Against ``repro.kernels.ref.matmul`` (int32 wraparound) on the same
    numpy operands, at full range and at the extremes (all -128 / 127,
    -32768 / 32767, INT_MIN / INT_MAX, and the two mixed), with K of
    several k-tiles and a ragged remainder, whole or split over 3 ranks:
    bitwise equal, though the exact sums overflow int32."""
    e = 128 // np.dtype(dtype).itemsize
    m, n, k = 24, 20, 3 * e + e // 2 + 4
    rng = np.random.default_rng(18)
    a, b = _ints((m, k), dtype, fill, rng), _ints((k, n), dtype, fill, rng)
    want = np.asarray(jax_ref.matmul(jnp.asarray(a), jnp.asarray(b)))
    got = _emulate(torch.from_numpy(a), torch.from_numpy(b), split)
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype != "int8":  # int8 sums of 452 terms stay inside int32
        exact = a.astype(object) @ b.astype(object)
        assert (np.abs(exact.astype(float)) >= 2**31).any()


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32"])
def test_limb_arithmetic_equals_the_reference_bmm(dtype):
    """Batch entry by batch entry, as the kernel's grid slices them,
    against ``repro.kernels.ref.bmm``; K = 64, half an int8 k-tile."""
    rng = np.random.default_rng(19)
    a = _ints((3, 17, 64), dtype, "full", rng)
    b = _ints((3, 64, 9), dtype, "mixed", rng)
    want = np.asarray(jax_ref.bmm(jnp.asarray(a), jnp.asarray(b)))
    got = torch.stack([_emulate(torch.from_numpy(a[z]),
                                torch.from_numpy(b[z]), 1)
                       for z in range(3)])
    np.testing.assert_array_equal(got.numpy(), want)
