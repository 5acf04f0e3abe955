"""The port's mm/bmm kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions (``ref.py``);
these are held against the JAX package's Pallas kernels (interpret mode,
through ``runtime.execute_plan``) on the same numpy operands, for every
registry parity dtype and bf16, at the smoke sizes and at ragged shapes.
Integers are bit-exact; float32 is within the registry's atol; bf16 is
within one bf16 rounding step of the output (``2^-7·|ref|``) plus the
float atol, since both sides round fp32 sums taken in different orders.

The plan-tile -> Hopper-tile adapter is checked on every full-width
serving shape.  The kernels themselves run only on the card
(``gpu``-marked test, skipped here).
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
    """build.COMPILED_TILES lists exactly the tiles launch_dtype compiles."""
    src = build.SOURCE.read_text()
    body = src[src.index("int launch_dtype"):src.index("int launch(")]
    body = body[body.index("#else"):]
    pairs = re.findall(r"WIDESA_BK\((\d+), (\d+)\)", body)
    compiled = {(int(m), int(n), k) for m, n in pairs for k in (8, 32)}
    assert compiled == set(build.COMPILED_TILES)


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


def test_cpu_wrappers_run_the_plain_version_and_count_no_launch():
    before = (widesa_mm.launches, bmm.launches)
    a, b = torch.randn(3, 5, 7), torch.randn(3, 7, 2)
    torch.testing.assert_close(bmm.bmm(a, b, tiles=(4, 32, 8)), a @ b)
    torch.testing.assert_close(
        widesa_mm.matmul(a[0], b[0], tiles=(4, 32, 8)), a[0] @ b[0])
    assert (widesa_mm.launches, bmm.launches) == before


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
