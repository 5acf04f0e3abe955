"""The port's FIR on the CPU: ``fir.fir_complex`` against the JAX
package's, the launch ``runtime.fir_tile`` picks, and the paper's FIR
table in the recurrence pipeline.

* ``fir.fir_complex`` on CPU tensors (its plain version,
  ``ref.fir_complex``) is held against the JAX package's
  ``ops.fir_complex``, four real passes on the Pallas FIR kernel in
  interpret mode as ``tests/test_kernels.py`` runs it, and against its
  oracle ``repro.kernels.ref.fir_complex``, on the same numpy operands
  (full-range integers, so the int32 wraparound of ``rr - ii`` shows):
  integers bit-exact, float32 within 1e-5 of the oracle (the same four
  passes in the same order) and within the registry's atol 1e-3 of the
  Pallas passes (another summation order).
* ``runtime.fir_tile`` / ``fir_config`` pick the instantiation of the tap
  count (15 compiled, the generic one else), 256 lanes a block where
  that leaves every SM a chunk and 128 else, and as many blocks as the
  card keeps resident, at most one a chunk, at the frontend, ragged and
  bench shapes; every launch's ring fits an SM's shared memory.
* The constants the runtime sizes launches with are the CUDA source's.
* The pipeline's bench run selects the registry's four FIR cases, the
  reference's, on plans equal to the reference's ``best_plan``.

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
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro_torch.core import Target, best_plan  # noqa: E402
from repro_torch.kernels import (build, fir, planned, ref,  # noqa: E402
                                 registry, runtime)
from repro_torch.launch import recurrences  # noqa: E402

SINGLE_CHIP = Target(name="single_chip", mesh_shape=(1, 1))
JAX_SINGLE_CHIP = JaxTarget(name="single_chip", mesh_shape=(1, 1))
DTYPES = ("float32", "int8", "int16", "int32")
#: the reference test's shape (400 samples, 15 taps), whisper-base's
#: frontend (6180 outputs of 15 taps), and two that the card runs on the
#: generic instantiation: a ragged one of 7 taps and one of 16
COMPLEX_SHAPES = ((386, 15), (6180, 15), (1000, 7), (97, 16))


def _planes(n_out, taps, dtype, seed):
    """(x_re, x_im, h_re, h_im) as numpy arrays: standard normal float32,
    full-range integers."""
    rng = np.random.default_rng(seed)
    shapes = ((n_out + taps - 1,),) * 2 + ((taps,),) * 2
    if dtype == "float32":
        return [rng.standard_normal(s).astype(np.float32) for s in shapes]
    info = np.iinfo(dtype)
    return [rng.integers(info.min, info.max, s, endpoint=True).astype(dtype)
            for s in shapes]


def _check(got, want, dtype, atol):
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).removeprefix("torch.") == jnp.dtype(want.dtype).name
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# fir_complex
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_out,taps", COMPLEX_SHAPES,
                         ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", DTYPES)
def test_fir_complex_matches_the_jax_package(n_out, taps, dtype):
    ops = _planes(n_out, taps, dtype, seed=n_out + taps)
    before = fir.launches
    got = fir.fir_complex(*(torch.from_numpy(o) for o in ops))
    assert fir.launches == before
    oracle = jax_ref.fir_complex(*(jnp.asarray(o) for o in ops))
    pallas = jax_ops.fir_complex(*(jnp.asarray(o) for o in ops), bn=128)
    for g, o, p in zip(got, oracle, pallas):
        _check(g, o, dtype, 1e-5)
        _check(g, p, dtype, jax_registry.get("fir").atol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ref_fir_complex_is_the_four_real_passes(dtype):
    """``rr - ii``, ``ri + ir`` of four ``ref.fir`` passes, the integers
    wrapped modulo 2^32 (here the extremes, where int32 overflows)."""
    ops = [torch.from_numpy(o) for o in _planes(300, 15, dtype, seed=3)]
    if dtype != "float32":
        info = torch.iinfo(getattr(torch, dtype))
        ops = [torch.full_like(o, info.min) for o in ops[:2]] + [
            torch.full_like(o, info.max) for o in ops[2:]]
    x_re, x_im, h_re, h_im = ops
    rr, ii = ref.fir(x_re, h_re), ref.fir(x_im, h_im)
    ri, ir = ref.fir(x_re, h_im), ref.fir(x_im, h_re)
    y_re, y_im = ref.fir_complex(*ops)
    if dtype == "float32":
        assert torch.equal(y_re, rr - ii) and torch.equal(y_im, ri + ir)
    else:
        def wrap(v):
            return ((v + 2**31) % 2**32 - 2**31).to(torch.int32)

        assert torch.equal(y_re, wrap(rr.long() - ii.long()))
        assert torch.equal(y_im, wrap(ri.long() + ir.long()))


def test_fir_wrappers_refuse_what_the_kernel_does_not_take():
    """Checks that run before any launch: meta tensors stand in for card
    tensors (they do not lie on the CPU, so no plain version runs)."""
    def meta(n, dtype=torch.float32):
        return torch.empty(n, dtype=dtype, device="meta")

    tile = runtime.FirTile(taps=15, lanes=128, blocks=1)
    with pytest.raises(ValueError, match="CUDA"):
        fir.fir_complex(meta(100), meta(100), meta(15), meta(15))
    with pytest.raises(ValueError, match="CUDA"):
        fir.fir(meta(100), meta(15), tiles=tile)
    with pytest.raises(TypeError, match="differ"):
        fir.fir_complex(meta(100), meta(100, torch.int16), meta(15),
                        meta(15), tiles=tile)
    with pytest.raises(ValueError, match="1-D"):
        fir.fir_complex(meta((10, 10)), meta(100), meta(15), meta(15),
                        tiles=tile)


# ---------------------------------------------------------------------------
# the launch the runtime picks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,dtype,tile", [
    ((6180, 15), "int16", runtime.FirTile(taps=15, lanes=128, blocks=13)),
    ((1000, 7), "float32", runtime.FirTile(taps=0, lanes=128, blocks=2)),
    ((70001, 15), "int8", runtime.FirTile(taps=15, lanes=128, blocks=137)),
    ((3001, 64), "int32", runtime.FirTile(taps=0, lanes=128, blocks=6)),
    ((1048576, 15), "float32",
     runtime.FirTile(taps=15, lanes=256, blocks=528)),
    ((1048576, 15), "cfloat",
     runtime.FirTile(taps=15, lanes=256, blocks=528))],
    ids=lambda v: str(v))
def test_fir_tile_picks_for_the_frontend_ragged_and_bench_shapes(args, dtype,
                                                                 tile):
    """The tap count's instantiation, lanes and grid, beside the plan's
    TPU block ({n: 103} at the frontend)."""
    plan = best_plan(registry.get("fir").builder(*args, dtype),
                     planned.PLANNED_TARGET)
    tiles = runtime.fir_tile(plan, args[0])
    assert tiles.tile == tile
    assert tiles.plan == (plan.partition.block["n"],)
    if args == (6180, 15):
        assert tiles.plan == (103,)


@pytest.mark.parametrize("taps", [1, 7, 15, 16, 64, 255, 4096])
@pytest.mark.parametrize("planes", [1, 2])
def test_fir_config_fills_the_card_within_shared_memory(taps, planes):
    """At every size, dtype and tap count the grid is at most one block a
    chunk and at most what the card keeps resident (lanes by the launch
    bounds, shared memory by the ring), every SM has a block from 1M
    outputs, and a block's ring fits the shared memory a block may use."""
    for elem in (1, 2, 4):
        for n_out in (1, 511, 6180, 1048576, 2**26):
            tile = runtime.fir_config(n_out, taps, elem, planes)
            assert tile.taps == (taps if taps in build.FIR_TAPS
                                 else build.FIR_GENERIC)
            smem = runtime.fir_smem(tile, taps, elem, planes)
            assert smem <= runtime.MTTKRP_TC_MAX_SMEM
            per_sm = min(build.FIR_SM_LANES // planes // tile.lanes,
                         runtime.SM_SMEM // (
                             smem + runtime.BLOCK_RESERVED_SMEM))
            chunks = -(-n_out // tile.chunk)
            assert tile.blocks == min(chunks, runtime.SMS * per_sm)
            if n_out >= 2**20:
                assert tile.lanes == max(build.FIR_LANES)
                assert tile.blocks >= runtime.SMS


def test_fir_constants_match_the_cuda_source():
    """The FIR's launch geometry and compiled tap counts are the source's
    (``launch_fir``: 15, then the generic instantiation, 0)."""
    src = build.SP_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert const("kFirLanes") == max(build.FIR_LANES) == \
        2 * min(build.FIR_LANES)
    assert const("kFirLaneOutputs") == build.FIR_LANE_OUTPUTS
    assert const("kFirStages") == build.FIR_STAGES
    assert const("kFirSmLanes") == build.FIR_SM_LANES
    assert const("kFirMaxTaps") == fir.MAX_TAPS
    assert const("kFirSlack") == runtime.FIR_SLACK
    body = src[src.index("int launch_fir("):]
    body = body[:body.index("\n}\n")]
    cases = re.findall(r"return fir_launch<TIn, TOut, (\d+), PLANES>", body)
    assert tuple(int(c) for c in cases) == (*build.FIR_TAPS,
                                            build.FIR_GENERIC)
    for taps in build.FIR_TAPS:
        assert f"ctaps == {taps} && a.taps == {taps}" in body
    assert "ctaps == 0)" in body


# ---------------------------------------------------------------------------
# the paper's FIR table in the pipeline
# ---------------------------------------------------------------------------

def test_pipeline_runs_the_papers_fir_table():
    """``registry_cases("bench")`` yields the registry's four FIR bench
    cases, the reference's, at full size (cfloat on float32 planes)."""
    cases = [(dtype, args)
             for spec, dtype, args in recurrences.registry_cases("bench")
             if spec.name == "fir"]
    assert cases == list(registry.get("fir").bench_cases)
    assert cases == list(jax_registry.get("fir").bench_cases)
    assert cases == [(d, (1048576, 15))
                     for d in ("float32", "int8", "int16", "cfloat")]
    rec = registry.get("fir").builder(*cases[-1][1], "cfloat")
    assert [o.dtype for o in registry.operands(
        registry.get("fir").builder(16, 15, "cfloat"),
        torch.Generator().manual_seed(0))] == [torch.float32] * 2
    assert rec.dtype == "cfloat"


@pytest.mark.parametrize("dtype,args", list(registry.get("fir").bench_cases),
                         ids=lambda v: str(v))
def test_fir_bench_plans_match_the_reference(dtype, args):
    """The single-chip plan the pipeline runs equals the reference's
    ``best_plan``, and the runtime launches it on the 15-tap
    instantiation."""
    spec = registry.get("fir")
    plan = best_plan(spec.builder(*args, dtype), SINGLE_CHIP)
    want = jax_best_plan(jax_registry.get("fir").builder(*args, dtype),
                         JAX_SINGLE_CHIP)
    assert plan.describe() == want.describe()
    assert plan.partition.block == want.partition.block
    assert plan.feasible == want.feasible
    assert plan.backend == want.backend == "pallas"
    tile = runtime.fir_tile(plan, args[0]).tile
    assert tile.taps == 15 and tile.blocks >= runtime.SMS
