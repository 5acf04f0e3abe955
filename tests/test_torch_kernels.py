"""The port's mm/bmm kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions (``ref.py``);
these are held against the JAX package's Pallas kernels (interpret mode,
through ``runtime.execute_plan``) on the same numpy operands, for every
registry parity dtype and bf16, at the smoke sizes and at ragged shapes.
Integers are bit-exact; float32 is within the registry's atol; bf16 is
within one bf16 rounding step of the output (``2^-7·|ref|``) plus the
float atol, since both sides round fp32 sums taken in different orders.

The runtime's choice of kernel is checked on every full-width serving
shape: the skinny kernel (at most 16 rows of A) with its K split, the
tiled kernel's tile beside it (the plan-tile -> tile adapter), and the
operands that must take the tiled kernel; on every qwen prefill shape of
17-512 tokens, quickstart's 1024^3, the registry's smoke shapes and the
paper's MM/BMM table: the tensor-core kernels for bf16, float32 and
integer operands TMA can address, the tiled kernel for the rest.  The tensor-core kernel's float32
arithmetic (3xTF32) is emulated in torch against the JAX package's
matmul.  The kernels themselves run only on the card (``gpu``-marked
tests, skipped here).
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.mapper import best_plan as jax_best_plan  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.kernels.runtime import execute_plan as jax_execute  # noqa: E402
from repro_torch.core.mapper import best_plan  # noqa: E402
from repro_torch.kernels import bmm, build, ref, registry, runtime  # noqa: E402
from repro_torch.kernels import widesa_mm  # noqa: E402
from repro_torch.kernels.planned import PLANNED_TARGET  # noqa: E402

BF16_RTOL = 2.0 ** -7


def _draw(rng, shape, dtype):
    if dtype.startswith("int"):
        return rng.integers(-8, 8, shape).astype(dtype)
    return rng.standard_normal(shape).astype(np.float32)


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _numpy(out):
    if isinstance(out, torch.Tensor):
        return out.float().numpy() if out.dtype == torch.bfloat16 \
            else out.numpy()
    out = np.asarray(out)
    return out.astype(np.float32) if out.dtype.name == "bfloat16" else out


def _cases():
    for name, ragged in (("mm", (61, 126, 37)), ("bmm", (3, 61, 126, 37))):
        spec = jax_registry.get(name)
        for dtype in (*spec.parity_dtypes, "bfloat16"):
            for args in (spec.smoke_args, ragged):
                yield pytest.param(name, args, dtype,
                                   id=f"{name}-{dtype}-{'x'.join(map(str, args))}")


@pytest.mark.parametrize("name,args,dtype", list(_cases()))
def test_ref_matches_jax_kernel(name, args, dtype):
    jspec = jax_registry.get(name)
    rec = jspec.builder(*args, dtype)
    a, b = (_draw(np.random.default_rng(0), x.shape, dtype)
            for x in jspec.operands(rec, np.random.default_rng(0)))
    want = jax_execute(jax_best_plan(rec, PLANNED_TARGET),
                       _to_jax(a, dtype), _to_jax(b, dtype))
    plan = best_plan(registry.get(name).builder(*args, dtype),
                     PLANNED_TARGET)
    got = runtime.execute_plan(plan, _to_torch(a, dtype),
                               _to_torch(b, dtype))
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).removeprefix("torch.") == jnp.dtype(
        want.dtype).name
    g, w = _numpy(got), _numpy(want)
    if dtype.startswith("int"):
        np.testing.assert_array_equal(g, w)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=jspec.atol)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=jspec.atol)


def test_registry_tolerances_match_the_reference():
    for name in ("mm", "bmm"):
        assert registry.get(name).parity_dtypes == \
            jax_registry.get(name).parity_dtypes
        assert registry.get(name).atol == jax_registry.get(name).atol
        assert registry.get(name).arity == jax_registry.get(name).arity
        assert registry.get(name).grid_loops == \
            jax_registry.get(name).grid_loops


def test_ref_int32_wraps_like_xla():
    rng = np.random.default_rng(3)
    a = rng.integers(-2**31, 2**31, (5, 7, 40), dtype=np.int64)
    b = rng.integers(-2**31, 2**31, (5, 40, 9), dtype=np.int64)
    want = np.asarray(jnp.einsum(
        "bik,bkj->bij", jnp.asarray(a.astype(np.int32)),
        jnp.asarray(b.astype(np.int32)),
        preferred_element_type=jnp.int32))
    got = ref.bmm(torch.from_numpy(a).to(torch.int32),
                  torch.from_numpy(b).to(torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ref_bmm_out_dtype_flushes_fp32_from_bf16():
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal((4, 8, 32)), rng.standard_normal((4, 32, 8))
    ja, jb = (jnp.asarray(x, jnp.bfloat16) for x in (a, b))
    want = jnp.einsum("bik,bkj->bij", ja, jb,
                      preferred_element_type=jnp.float32)
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = ref.bmm(ta, tb, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


#: the full-width serving shapes of qwen1.5-0.5b and the blocks the
#: planner gives them
MOTIVATION = (
    ("mm", (12, 1024, 1024), {"i": 12, "j": 128, "k": 512}),
    ("mm", (12, 2816, 1024), {"i": 12, "j": 32, "k": 512}),
    ("mm", (12, 1024, 2816), {"i": 12, "j": 128, "k": 128}),
    ("mm", (4, 151936, 1024), {"i": 4, "j": 32, "k": 512}),
    ("bmm", (64, 1, 128, 64), {"b": 64, "i": 1, "j": 16, "k": 64}),
    ("bmm", (64, 1, 64, 128), {"b": 64, "i": 1, "j": 8, "k": 128}),
    ("bmm", (16, 12, 12, 64), {"b": 16, "i": 3, "j": 12, "k": 32}),
)


@pytest.mark.parametrize("kind,shape,block", MOTIVATION,
                         ids=[f"{k}{s}" for k, s, _ in MOTIVATION])
def test_hopper_tiles_on_serving_shapes(kind, shape, block):
    plan = best_plan(registry.get(kind).builder(*shape, "bfloat16"),
                     PLANNED_TARGET)
    assert plan.feasible and plan.backend == "pallas"
    assert plan.partition.block == block
    for col_major in (False, True):
        tiles = runtime.hopper_tiles(plan, b_col_major=col_major)
        assert tiles.plan == (block["i"], block["j"], block["k"])
        assert tiles.tile in build.COMPILED_TILES
        bm, bn, bk = tiles.tile
        # the row tile covers the plan's; every block has 128 threads;
        # the K slice follows B's layout
        assert bm >= block["i"] or bm == max(build.COMPILED_BM)
        assert bm * bn >= 128
        assert bk == (8 if col_major else 32)


def _plan_with_block(block):
    kind = "bmm" if "b" in block else "mm"
    shape = (64, 1, 64, 128) if kind == "bmm" else (12, 1024, 1024)
    plan = best_plan(registry.get(kind).builder(*shape, "bfloat16"),
                     PLANNED_TARGET)
    return dataclasses.replace(
        plan, partition=dataclasses.replace(plan.partition, block=block))


@pytest.mark.parametrize("block,tile", [
    ({"i": 3, "j": 12, "k": 6}, (4, 32, 32)),
    ({"b": 64, "i": 1, "j": 8, "k": 128}, (1, 128, 32)),
    ({"i": 12, "j": 128, "k": 512}, (16, 32, 32)),
    ({"i": 200, "j": 1000, "k": 7}, (64, 32, 32)),
])
def test_hopper_tiles_adapts_odd_blocks(block, tile):
    tiles = runtime.hopper_tiles(_plan_with_block(block))
    assert tiles.tile == tile and tiles.tile in build.COMPILED_TILES


@pytest.mark.parametrize("block,tile", [
    ({"i": 4, "j": 32, "k": 512}, (4, 32, 8)),
    ({"i": 1, "j": 32, "k": 512}, (1, 128, 8)),
])
def test_hopper_tiles_column_major_b_takes_the_short_k_slice(block, tile):
    tiles = runtime.hopper_tiles(_plan_with_block(block), b_col_major=True)
    assert tiles.tile == tile


def test_compiled_tiles_match_the_cuda_source():
    """build.COMPILED_TILES lists exactly the tiles launch_dtype compiles
    for the tiled kernel, runtime's SKINNY_* constants are the skinny
    kernel's kSkinny* ones, and its TC_* constants and TC_TILES the
    tensor-core kernel's kTc* ones and compiled tiles."""
    src = build.SOURCE.read_text()
    body = src[src.index("int launch_dtype"):src.index("int launch(")]
    body = body[body.index("#else"):]
    pairs = re.findall(r"WIDESA_BK\((\d+), (\d+)\)", body)
    compiled = {(int(m), int(n), k) for m, n in pairs for k in (8, 32)}
    assert compiled == set(build.COMPILED_TILES)
    consts = dict(re.findall(r"constexpr int kSkinny(\w+) = (\d+);", src))
    assert {"Rows": runtime.SKINNY_ROWS, "BN": runtime.SKINNY_BN,
            "RunBytes": runtime.SKINNY_RUN_BYTES,
            "MaxCluster": runtime.SKINNY_MAX_CLUSTER} == {
        name: int(consts[name])
        for name in ("Rows", "BN", "RunBytes", "MaxCluster")}
    tc = {name: int(v) for name, v in
          re.findall(r"constexpr int kTc(\w+) = (\d+);", src)}
    assert {"Consumers": runtime.TC_THREADS - 32,
            "RowBytes": runtime.TC_ROW_BYTES,
            "MaxStages": runtime.TC_MAX_STAGES,
            "MaxCluster": runtime.TC_MAX_CLUSTER,
            "MaxSmem": runtime.TC_MAX_SMEM} == {
        name: tc[name] for name in ("Consumers", "RowBytes", "MaxStages",
                                    "MaxCluster", "MaxSmem")}
    assert "kTcThreads = kTcConsumers + 32;" in src
    for fn, dtype in (("int launch_tc_bf16", torch.bfloat16),
                      ("int launch_tc_f32", torch.float32),
                      ("int launch_tc_int(", torch.int8),
                      ("int launch_tc_int(", torch.int16),
                      ("int launch_tc_int(", torch.int32)):
        body = src[src.index(fn):]
        body = body[:body.index("\n}\n")]
        if dtype in runtime.TC_INT_MAX_RANK_K:  # one dispatch for the three
            code = {1: "I8", 2: "I16", 4: "I32"}[dtype.itemsize]
            body = "\n".join(line for line in body.splitlines()
                             if f"in_dtype == {code} " in line)
        tiles = re.findall(r"bm == (\d+) && bn == (\d+)", body)
        assert {(int(m), int(n)) for m, n in tiles} == \
            set(runtime.TC_TILES[dtype])


#: every GEMM shape of the two serving paths at full width, as (kind,
#: shape, B column-major): qwen1.5-0.5b's prefill of a 12-token prompt
#: and 4-lane decode step; whisper-base's 4-lane decode (the tied lm_head,
#: cross-attention over the 1500-frame encoder cache) and its 8-frame
#: encoder chunk (projections, MLP, attention over the cache)
SERVING = (
    ("mm", (12, 1024, 1024), False), ("mm", (12, 2816, 1024), False),
    ("mm", (12, 1024, 2816), False), ("mm", (1, 151936, 1024), True),
    ("mm", (4, 1024, 1024), False), ("mm", (4, 2816, 1024), False),
    ("mm", (4, 1024, 2816), False), ("mm", (4, 151936, 1024), True),
    ("bmm", (64, 1, 128, 64), False), ("bmm", (64, 1, 64, 128), False),
    ("bmm", (16, 12, 12, 64), False), ("bmm", (16, 12, 64, 12), False),
    ("mm", (4, 51865, 512), True), ("mm", (4, 512, 512), False),
    ("bmm", (32, 1, 1500, 64), False), ("bmm", (32, 1, 64, 1500), False),
    ("mm", (8, 512, 512), False), ("mm", (8, 2048, 512), False),
    ("mm", (8, 512, 2048), False),
    ("bmm", (8, 8, 1500, 64), False), ("bmm", (8, 8, 64, 1500), False),
)


def _meta_operands(kind, shape, col_major, dtype=torch.bfloat16,
                   padded=False):
    """Operands of a GEMM shape on the meta device (no memory; pointers
    read 0, so aligned); ``padded``: A in rows padded to whole 16-byte
    units, as the attention layer hands the values bmm its weights."""
    if kind == "mm":
        (m, n, k), lead = shape, ()
    else:
        (z, m, n, k), lead = shape, (shape[0],)
    unit = 16 // dtype.itemsize
    a = torch.empty((*lead, m, -(-k // unit) * unit if padded else k),
                    dtype=dtype, device="meta")[..., :k]
    b = (torch.empty((*lead, n, k), dtype=dtype, device="meta")
         .transpose(-1, -2) if col_major
         else torch.empty((*lead, k, n), dtype=dtype, device="meta"))
    return a, b


@pytest.mark.parametrize("kind,shape,col_major", SERVING,
                         ids=[f"{k}{s}" for k, s, _ in SERVING])
def test_runtime_picks_the_skinny_kernel_on_serving_shapes(kind, shape,
                                                           col_major):
    """Every serving GEMM has at most 16 rows and B rows that allow
    4-byte copies: the runtime's pick (through the registry, as
    ``execute_plan`` asks) is the skinny kernel, a launch it takes."""
    a, b = _meta_operands(kind, shape, col_major)
    plan = best_plan(registry.get(kind).builder(*shape, "bfloat16"),
                     PLANNED_TARGET)
    tiles = registry.get(kind).tiles(plan, a, b)
    assert isinstance(tiles.tile, runtime.SkinnyTile)
    assert tiles.plan == runtime.hopper_tiles(plan).plan
    runtime.check_skinny(tiles.tile, a.shape[-2], a.shape[-1], a.dtype)
    assert runtime.b_copy_bytes(b) >= 4


DECODE = [c for c in SERVING if c[1][-3] <= 4]


@pytest.mark.parametrize("kind,shape,col_major", DECODE,
                         ids=[f"{k}{s}" for k, s, _ in DECODE])
def test_decode_shapes_above_one_mib_fill_the_card(kind, shape, col_major):
    """A decode GEMM whose B exceeds 1 MiB launches a block for every one
    of the card's 132 SMs (K split over a cluster where the column tiles
    alone are too few)."""
    a, b = _meta_operands(kind, shape, col_major)
    tile = runtime.gemm_tile(a, b, (4, 32, 32))
    n, batch = b.shape[-1], (a.shape[0] if kind == "bmm" else 1)
    if b.numel() * b.element_size() > 2**20:
        assert tile.blocks(n, batch) >= runtime.SMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.int16, torch.int32],
                         ids=str)
def test_skinny_splits_stay_in_one_portable_cluster(dtype):
    """Over M = 1..16 and a spread of N and K: the split is 1..8 (the
    portable cluster size the source launches), every block of a cluster
    gets a non-empty K range of whole stages, and A's stage fits."""
    bk = runtime.skinny_bk(dtype)
    for m in range(1, 17):
        for n in (1, 31, 96, 1024, 151936):
            for k in (1, 7, 64, 77, 1000, 1004, 2816, 20000):
                tile = runtime.skinny_tile(m, n, k, 1, dtype)
                if tile is None:
                    assert m * -(-k // 8) * dtype.itemsize > \
                        runtime.SKINNY_A_BYTES
                    continue
                assert 1 <= tile.split <= runtime.SKINNY_MAX_CLUSTER
                assert tile.kblk % bk == 0
                assert (tile.split - 1) * tile.kblk < k <= \
                    tile.split * tile.kblk
                runtime.check_skinny(tile, m, k, dtype)
    assert runtime.skinny_tile(17, 1024, 1024, 1, dtype) is None


def test_misaligned_or_odd_operands_take_the_tiled_kernel():
    """B rows the skinny kernel cannot copy 4 bytes at a time (a storage
    offset of one 2-byte element, an odd row of bf16, an int8 row of 130)
    take the tiled tile; rows aligned to 8 bytes (whisper's 1500-key score
    rows) and a single column stay on the skinny kernel.  A of more than
    16 rows takes the tensor-core kernel in bf16 and int8 where TMA can
    address both operands, the tiled tile where it cannot (B one element
    off its 16-byte boundary, rows of 63 or 130 bf16 elements, int8 rows
    of 72 bytes)."""
    tiled = (4, 32, 32)
    a = torch.zeros((4, 64), dtype=torch.bfloat16)
    flat = torch.zeros(64 * 130 + 8, dtype=torch.bfloat16)
    offset = flat[1:1 + 64 * 130].view(64, 130)
    assert runtime.gemm_tile(a, flat[:64 * 130].view(64, 130), tiled) != \
        tiled
    assert runtime.gemm_tile(a, offset, tiled) == tiled
    assert runtime.gemm_tile(
        a, torch.zeros((64, 131), dtype=torch.bfloat16), tiled) == tiled
    odd_k = torch.zeros((96, 63), dtype=torch.bfloat16).t()
    assert runtime.gemm_tile(torch.zeros((4, 63), dtype=torch.bfloat16),
                             odd_k, tiled) == tiled
    assert runtime.gemm_tile(
        torch.zeros((4, 64), dtype=torch.int8),
        torch.zeros((64, 130), dtype=torch.int8), tiled) == tiled
    assert runtime.gemm_tile(
        torch.zeros((17, 64), dtype=torch.bfloat16),
        torch.zeros((64, 128), dtype=torch.bfloat16), tiled) == \
        runtime.TcTile(bm=128, bn=64, stages=2, split=1)
    rows17 = torch.zeros((17, 64), dtype=torch.bfloat16)
    for b in (offset, torch.zeros((64, 130), dtype=torch.bfloat16)):
        assert runtime.gemm_tile(rows17, b, tiled) == tiled
    assert runtime.gemm_tile(torch.zeros((17, 63), dtype=torch.bfloat16),
                             odd_k, tiled) == tiled
    assert runtime.gemm_tile(
        torch.zeros((17, 64), dtype=torch.int8),
        torch.zeros((64, 128), dtype=torch.int8), tiled) == \
        runtime.TcTile(bm=128, bn=64, stages=2, split=1)
    assert runtime.gemm_tile(
        torch.zeros((17, 72), dtype=torch.int8),
        torch.zeros((72, 128), dtype=torch.int8), tiled) == tiled
    scores = torch.zeros((64, 1500), dtype=torch.bfloat16)
    assert runtime.b_copy_bytes(scores) == 8
    assert isinstance(runtime.gemm_tile(a, scores, tiled),
                      runtime.SkinnyTile)
    # a single column of keys (one-token scores) is read column-major: its
    # 64 elements lie in one 128-byte run
    column = torch.zeros((64, 1), dtype=torch.bfloat16)
    assert runtime.b_col_major(column) == 1
    assert runtime.b_copy_bytes(column) == 16
    assert isinstance(runtime.gemm_tile(a, column, tiled),
                      runtime.SkinnyTile)


def _route(kind, shape, col_major, dtype, padded=False):
    """The runtime's configuration (through the registry, as
    ``execute_plan`` asks) for a GEMM shape on meta operands (A in padded
    rows where ``padded``)."""
    a, b = _meta_operands(kind, shape, col_major, dtype, padded)
    plan = best_plan(registry.get(kind).builder(*shape, planned_name(dtype)),
                     PLANNED_TARGET)
    return registry.get(kind).tiles(plan, a, b).tile


def planned_name(dtype):
    return str(dtype).removeprefix("torch.")


#: qwen1.5-0.5b's prefill GEMMs of a P-token prompt: (kind, shape, B
#: column-major, A in padded rows); the scores read K column-major, the
#: lm_head the tied embedding table, the values their softmax weights in
#: padded rows
def _prefill(p):
    return (("mm", (p, 1024, 1024), False, False),
            ("mm", (p, 2816, 1024), False, False),
            ("mm", (p, 1024, 2816), False, False),
            ("mm", (1, 151936, 1024), True, False),
            ("bmm", (16, p, p, 64), True, False),
            ("bmm", (16, p, 64, p), False, True))


PREFILL = [(p, *case) for p in (17, 64, 127, 512) for case in _prefill(p)]


@pytest.mark.parametrize("p,kind,shape,col_major,padded", PREFILL,
                         ids=[f"P{c[0]}-{c[1]}{c[2]}" for c in PREFILL])
def test_prefill_gemms_take_the_tensor_core_kernel(p, kind, shape,
                                                   col_major, padded):
    """Every GEMM of a qwen prefill with more than 16 rows of A takes the
    tensor-core kernel, at odd prompt lengths too; the lm_head (one row)
    stays on the skinny kernel.  The values bmm of an odd length takes it
    only because its A comes in padded rows: contiguous, its rows of P
    bf16 elements are no whole 16-byte units (the tiled kernel)."""
    tile = _route(kind, shape, col_major, torch.bfloat16, padded)
    m, k = shape[-3], shape[-1]
    if m <= runtime.SKINNY_ROWS:
        assert isinstance(tile, runtime.SkinnyTile)
        return
    assert isinstance(tile, runtime.TcTile)
    _holds_the_tc_rule(tile, shape, torch.bfloat16)
    if padded and k % 8:
        assert _route(kind, shape, col_major, torch.bfloat16) in \
            build.COMPILED_TILES


def test_a_pitch_reads_contiguous_and_padded_rows_only():
    """A's row pitch: K when contiguous, the row stride of rows padded
    evenly (batch entries M rows apart), None for a transpose, a column
    stride or batch entries out of step."""
    a = torch.zeros((3, 5, 24))
    assert runtime.a_pitch(a) == 24
    assert runtime.a_pitch(a[..., :17]) == 24
    assert runtime.a_pitch(a.transpose(1, 2)) is None
    assert runtime.a_pitch(a[..., ::2]) is None
    assert runtime.a_pitch(a[:, :4, :17]) is None
    assert runtime.a_pitch(a[0, :, :17]) == 24


def _holds_the_tc_rule(tile, shape, dtype):
    """The tensor-core configuration rule (``runtime.tc_tile``): bf16 tiles
    of 128 rows, 128 columns wide from N = ``TC_WIDE_N`` up and 64 below;
    float32 tiles of 128 columns, 64 rows tall up to M = 64 and 128
    above; int8 tiles of 128 rows, 256 columns wide from N =
    ``TC_WIDE_N`` up and 64 below; int16 and int32 128 x 64; K split
    over at most ``TC_MAX_SPLIT`` blocks, each with a k-tile and at least
    ``TC_MIN_RANK_KTILES`` of them, the split grid within one block an SM,
    an integer rank's K within ``TC_INT_MAX_RANK_K``; the deepest ring a
    rank's k-tiles fill (2 at the least)."""
    m, n, k = shape[-3:]
    batch = shape[0] if len(shape) == 4 else 1
    if dtype == torch.bfloat16:
        assert (tile.bm, tile.bn) == (
            128, 128 if n >= runtime.TC_WIDE_N else 64)
    elif dtype == torch.int8:
        assert (tile.bm, tile.bn) == (
            128, 256 if n >= runtime.TC_WIDE_N else 64)
    elif dtype == torch.float32:
        assert (tile.bm, tile.bn) == (64 if m <= 64 else 128, 128)
    else:
        assert (tile.bm, tile.bn) == (128, 64)
    if dtype in runtime.TC_INT_MAX_RANK_K:
        assert runtime.tc_rank_k(k, dtype, tile.split) <= \
            runtime.TC_INT_MAX_RANK_K[dtype]
    ktiles = -(-k * dtype.itemsize // runtime.TC_ROW_BYTES)
    ktper = -(-ktiles // tile.split)
    assert 1 <= tile.split <= runtime.TC_MAX_SPLIT
    assert (tile.split - 1) * ktper < ktiles
    assert tile.split == 1 or (tile.blocks(m, n, batch) <= runtime.SMS
                               and ktper >= runtime.TC_MIN_RANK_KTILES)
    assert tile.stages == min(runtime.TC_MAX_STAGES, max(2, ktper))
    assert tile.smem(dtype) <= runtime.TC_MAX_SMEM


#: the recurrence path's GEMMs above 16 rows: quickstart's 1024^3, the
#: registry's smoke shapes of mm, bmm and the fft2d stages (64 x 64 DFT
#: planes times 64 x 64 data), and the paper's MM/BMM table (the
#: registry's bench shapes of mm and bmm)
RECURRENCE = (("mm", (1024, 1024, 1024)), ("mm", (256, 256, 256)),
              ("bmm", (4, 128, 128, 64)), ("mm", (64, 64, 64)),
              ("mm", (8192, 8192, 8192)), ("mm", (10240, 10240, 10240)),
              ("mm", (9600, 9600, 9600)), ("bmm", (64, 4096, 4096, 4096)))


@pytest.mark.parametrize("kind,shape", RECURRENCE,
                         ids=[f"{k}{s}" for k, s in RECURRENCE])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.int16, torch.int32], ids=str)
def test_recurrence_gemms_route_by_dtype(kind, shape, dtype):
    """Every dtype takes the tensor-core kernels (the integers as int8
    limbs): TMA addresses the operands of every one of these shapes."""
    tile = _route(kind, shape, False, dtype)
    assert isinstance(tile, runtime.TcTile)
    _holds_the_tc_rule(tile, shape, dtype)


def test_tc_split_fills_the_card_within_one_wave():
    """At qwen's q/k/v/o prefill of 512 tokens the 64 column tiles split K
    over 2 blocks (128 blocks); at 127 tokens the 16 tiles over 4; the
    gate/up's 88 wide tiles do not split; quickstart's float32 1024^3 (64
    tiles) splits over 2; a K of fewer than 8 k-tiles never splits."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert runtime.tc_tile(512, 1024, 1024, bf16) == runtime.TcTile(
        bm=128, bn=64, stages=4, split=2)
    assert runtime.tc_tile(127, 1024, 1024, bf16).split == 4
    assert runtime.tc_tile(512, 2816, 1024, bf16) == runtime.TcTile(
        bm=128, bn=128, stages=4, split=1)
    assert runtime.tc_tile(1024, 1024, 1024, f32) == runtime.TcTile(
        bm=128, bn=128, stages=4, split=2)
    # the scores' K of 64 is one k-tile: no split, a ring of 2; the
    # values' K of 127 two k-tiles, too few to split
    assert runtime.tc_tile(512, 512, 64, bf16, 16) == runtime.TcTile(
        bm=128, bn=64, stages=2, split=1)
    assert runtime.tc_tile(127, 64, 127, bf16, 16) == runtime.TcTile(
        bm=128, bn=64, stages=2, split=1)


def test_tc_operands_need_aligned_bases_and_16_byte_rows():
    """TMA addresses an operand whose base is 16-byte aligned and whose
    rows are whole 16-byte units: float32 rows of a multiple of 4
    elements, bf16 of 8; a base one element off, or A not contiguous,
    takes the tiled tile; a launch the kernel cannot take raises."""
    tiled = (64, 32, 32)
    for dtype, unit in ((torch.float32, 4), (torch.bfloat16, 8)):
        for k in (unit * 9, unit * 9 + unit // 2):
            a = torch.zeros((40, k), dtype=dtype)
            b = torch.zeros((k, 24), dtype=dtype)
            whole = k % unit == 0
            assert isinstance(runtime.gemm_tile(a, b, tiled),
                              runtime.TcTile) == whole
            assert isinstance(runtime.gemm_tile(a, b.t().contiguous().t(),
                                                tiled), runtime.TcTile) == \
                whole
        flat = torch.zeros(40 * 64 + 1, dtype=dtype)
        a = flat[1:].view(40, 64)
        b = torch.zeros((64, 32), dtype=dtype)
        assert runtime.gemm_tile(a, b, tiled) == tiled
        assert runtime.gemm_tile(torch.zeros((64, 40), dtype=dtype).t(), b,
                                 tiled) == tiled
        with pytest.raises(ValueError, match="TMA"):
            runtime.check_tc(runtime.tc_tile(40, 32, 64, dtype), a, b)
    good = torch.zeros((40, 64)), torch.zeros((64, 32))
    for tile in (runtime.TcTile(128, 64, 4),      # a bf16 tile in float32
                 runtime.TcTile(64, 128, 1),      # one stage
                 runtime.TcTile(64, 128, 5),      # past the deepest ring
                 runtime.TcTile(64, 128, 2, 9),   # past the cluster
                 runtime.TcTile(64, 128, 2, 3)):  # K = 64 is 2 k-tiles
        with pytest.raises(ValueError, match="tensor-core"):
            runtime.check_tc(tile, *good)
    runtime.check_tc(runtime.TcTile(64, 128, 2, 2), *good)
    runtime.check_tc(runtime.tc_tile(40, 32, 64, torch.float32), *good)


def test_tc_tiles_fit_in_shared_memory():
    for dtype, tiles in runtime.TC_TILES.items():
        for bm, bn in tiles:
            tile = runtime.TcTile(bm, bn, runtime.TC_MAX_STAGES)
            assert tile.smem(dtype) <= runtime.TC_MAX_SMEM
            assert tile.blocks(512, 1024) == -(-512 // bm) * -(-1024 // bn)


def _truncated(t):
    """``t`` with its significand cut to TF32's 10 bits, as the tensor
    cores read a .tf32 operand."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _emulate_3xtf32(a, b, passes=3):
    """The tensor-core kernel's float32 arithmetic: A's tile read by the
    tensor cores as trunc_tf32(a) with lo = a - trunc_tf32(a) beside it,
    B split hi = rna_tf32(b), lo = b - hi; each lo read truncated; lo*hi +
    hi*lo + hi*hi with fp32 sums (``passes`` = 1: one product of the
    operands rounded to TF32)."""
    from test_torch_recurrences import _tf32

    if passes == 1:
        return _tf32(a) @ _tf32(b)
    ah, bh = _truncated(a), _tf32(b)
    al, bl = _truncated(a - ah), _truncated(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


@pytest.mark.parametrize("shape", [(256, 256, 256), (64, 1024, 1024)],
                         ids=str)
def test_3xtf32_emulation_is_within_atol_and_one_tf32_is_not(shape):
    """Against the JAX package's ``repro.kernels.ref.matmul`` on the same
    N(0, 1) operands: 3xTF32 within the registry's atol 1e-3 (at K = 1024
    as close as two fp32 sums in different orders, ~1e-4), one TF32
    product outside it and over 10x further off."""
    from repro.kernels import ref as jax_ref

    m, n, k = shape
    rng = np.random.default_rng(7)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(jax_ref.matmul(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    atol = registry.get("mm").atol
    err3 = np.abs(_emulate_3xtf32(ta, tb).numpy() - want).max()
    err1 = np.abs(_emulate_3xtf32(ta, tb, passes=1).numpy() - want).max()
    assert err3 <= atol
    assert err1 > atol and err1 > 10 * err3


def test_check_skinny_refuses_launches_the_kernel_cannot_take():
    good = runtime.skinny_tile(4, 1024, 1000, 1, torch.bfloat16)
    runtime.check_skinny(good, 4, 1000, torch.bfloat16)
    for tile, m, k in (
            (good, 17, 1000),                               # too many rows
            (runtime.SkinnyTile(9, 128), 4, 1100),          # cluster of 9
            (runtime.SkinnyTile(2, 100), 4, 200),           # partial stage
            (runtime.SkinnyTile(8, 128), 4, 500),           # empty ranks
            (runtime.SkinnyTile(1, 512), 4, 1000)):         # K left over
        with pytest.raises(ValueError, match="skinny"):
            runtime.check_skinny(tile, m, k, torch.bfloat16)


def test_xla_stamp_runs_the_plain_version():
    plan = best_plan(registry.get("mm").builder(6, 5, 4, "float32"),
                     PLANNED_TARGET)
    a, b = torch.randn(6, 4), torch.randn(4, 5)
    got = runtime.execute_plan(dataclasses.replace(plan, backend="xla"),
                               a, b)
    torch.testing.assert_close(got, ref.mm(a, b))


def test_wrappers_raise_off_the_cpu_instead_of_falling_back():
    a = torch.empty((4, 8), device="meta")
    b = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        widesa_mm.matmul(a, b, tiles=(4, 32, 8))
    with pytest.raises(ValueError, match="CUDA"):
        bmm.bmm(a[None], b[None], tiles=(4, 32, 8))
    with pytest.raises(ValueError, match="CUDA"):
        widesa_mm.matmul(a, b, tiles=runtime.gemm_tile(a, b, (4, 32, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        bmm.bmm(a[None], b[None], tiles=runtime.tc_tile(4, 3, 8,
                                                        torch.float32))


def test_cpu_wrappers_run_the_plain_version_and_count_no_launch():
    before = (widesa_mm.launches, bmm.launches, dict(widesa_mm.variants),
              dict(bmm.variants))
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 2)
    torch.testing.assert_close(bmm.bmm(a, b, tiles=(4, 32, 8)), a @ b)
    torch.testing.assert_close(
        widesa_mm.matmul(a[0], b[0], tiles=(4, 32, 8)), a[0] @ b[0])
    skinny = runtime.gemm_tile(a[0], b[0], (4, 32, 8))
    torch.testing.assert_close(
        widesa_mm.matmul(a[0], b[0], tiles=skinny), a[0] @ b[0])
    tc = runtime.tc_tile(5, 2, 7, torch.float32)
    torch.testing.assert_close(bmm.bmm(a, b, tiles=tc), a @ b)
    assert (widesa_mm.launches, bmm.launches, widesa_mm.variants,
            bmm.variants) == before


@pytest.mark.gpu
@pytest.mark.parametrize("kind,shape,block", MOTIVATION,
                         ids=[f"{k}{s}" for k, s, _ in MOTIVATION])
def test_kernels_match_plain_versions_on_the_card(kind, shape, block):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels run only there")
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan = best_plan(registry.get(kind).builder(*shape, "bfloat16"),
                     PLANNED_TARGET)
    tiles = runtime.hopper_tiles(plan).tile
    fn = widesa_mm.matmul if kind == "mm" else bmm.bmm
    plain = ref.mm if kind == "mm" else ref.bmm
    m, n, k = shape[-3:]
    lead = shape[:-3]
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.int16,
                  torch.int32):
        if dtype.is_floating_point:
            a = torch.randn((*lead, m, k), generator=gen, device="cuda")
            b = torch.randn((*lead, k, n), generator=gen, device="cuda")
        else:
            a = torch.randint(-99, 99, (*lead, m, k), generator=gen,
                              device="cuda")
            b = torch.randint(-99, 99, (*lead, k, n), generator=gen,
                              device="cuda")
        a, b = a.to(dtype), b.to(dtype)
        got, want = fn(a, b, tiles=tiles), plain(a, b)
        torch.cuda.synchronize()
        if dtype.is_floating_point:
            rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=rtol, atol=1e-3)
        else:
            assert torch.equal(got, want)
