"""The port's dry run (``launch/dryrun.py``, ``launch/accounting.py``,
``core/roofline.py``, ``launch/fakecuda.py``) against the JAX package's,
on the CPU: no card, no ``nvcc``.

* ``param_count``, ``active_param_count`` and ``cells_for`` of every
  registered arch, ``batch_specs`` of every arch at every ``SHAPES``
  cell (keys, shapes, dtypes), ``probe_configs``, ``combine_probe`` and
  ``attention_adjustment`` of every arch x cell equal the reference's,
  exactly; the reference's two accounting tests, run on the port;
* ``analyze``, ``row()`` and ``format_table`` equal the reference's for
  the same cost dict, the TPU v5e peaks passed explicitly, and the
  reference's ``collective_bytes`` of its HLO sample as ``coll``;
* a 64 x 512 by 512 x 32 float32 product split over an (8,) mesh and
  ``psum``-med: the all-reduce carries at least the 64 x 32 x 4 result
  bytes, exactly ``parallel/collectives.py``'s model of the copies;
* ``StepCounter`` on qwen1.5-0.5b's SMOKE prefill of 4096 tokens (past
  ``BLOCKWISE_SEQ_THRESHOLD``): the blockwise attention's counted FLOPs
  equal ``attention_adjustment``'s closed form, and the GEMMs' FLOPs
  2·M·N·K summed over the model's products, exactly;
* the L = 1 / L = 2 probes combined equal the whole step's count
  exactly (FLOPs, bytes, kernel launches by variant, collective bytes)
  for dense, MoE and hybrid SMOKE configs at prefill and decode on a
  (2, 4) logical mesh (the MoE on its TP mesh path);
* argument bytes per device equal XLA's
  ``memory_analysis().argument_size_in_bytes`` of the reference's
  ``_lower_one`` (one subprocess over 8 forced host devices on a (2, 4)
  mesh, as ``tests/test_roofline.py`` does) at train, prefill and
  decode for a dense and an MoE SMOKE config, exactly;
* fake operands take the route the same operands take for real
  (``runtime.address``), ``widesa_mm.launch`` records a fake launch,
  which ``launches`` and ``variants`` do not count, and still raises for
  a real operand that is not on a card; the dry run's meshes lie on
  ``cuda`` while the mesh module's default stays the CPU here; the
  indexing of ``fakecuda._GuardFreeBindings`` equals PyTorch's own on
  real tensors;
* the CLI writes one JSON a cell, and a train cell on a build without
  CUDA fails naming its error.

~35-45 s alone; the reference's subprocess runs beside the in-process
cases.
"""

import dataclasses
import json
import math
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import cells_for as ref_cells_for  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.core import roofline as REF_RL  # noqa: E402
from repro.launch import accounting as REF_ACC  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, cells_for,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import roofline as RL  # noqa: E402
from repro_torch.kernels import bmm as bmm_mod  # noqa: E402
from repro_torch.kernels import runtime, widesa_mm  # noqa: E402
from repro_torch.launch import accounting as ACC  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import fakecuda  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import BLOCKWISE_SEQ_THRESHOLD  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel import mesh as pm  # noqa: E402
from repro_torch.parallel.mesh import P  # noqa: E402
from repro_torch.parallel.sharding import mesh_context  # noqa: E402

AXES = ("data", "model")
CELLS = [(a, s) for a in ARCHS for s in SHAPES]

#: the reference's HLO sample (tests/test_roofline.py)
HLO_SAMPLE = """
ENTRY %main {
  %p0 = f32[16,128]{1,0} parameter(0)
  %ag = f32[16,2048]{1,0} all-gather(%p0), dimensions={1}
  %ar = f32[16,128]{1,0} all-reduce(%p0), to_apply=%add
  %rs = bf16[4,128]{1,0} reduce-scatter(%p1), dimensions={0}
  %cp = s8[64]{0} collective-permute(%p2), source_target_pairs={{0,1}}
  %a2a = (f32[2,4]{1,0}, f32[2,4]{1,0}) all-to-all(%x, %y), dimensions={0}
  %ard = f32[9]{0} all-reduce-done(%foo)
}
"""

#: the memory cells held to XLA's argument sizes: SMOKE configs on (2, 4)
MEM_ARCHS = ("qwen1.5-0.5b", "olmoe-1b-7b")
MEM_SHAPES = (ShapeSpec("t", "train", 32, 8), ShapeSpec("p", "prefill", 32, 8),
              ShapeSpec("d", "decode", 64, 8))

REF_MEMORY = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import jax
jax.devices()
from repro.launch.dryrun import _lower_one
from repro.compat import make_mesh
from repro.configs import get_smoke_config
from repro.configs.base import ShapeSpec
from repro.models import build_model
from repro.parallel.sharding import mesh_context
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for arch in ARCHS_:
    cfg = get_smoke_config(arch)
    for name, kind, s, b in SHAPES_:
        with mesh_context(mesh, fsdp=cfg.fsdp) as ctx:
            _, _, mem = _lower_one(cfg, ShapeSpec(name, kind, s, b), mesh,
                                   ctx, build_model(cfg))
        out[f"{arch}/{name}"] = mem["argument_bytes"]
print("MEM " + json.dumps(out))
""".replace("ARCHS_", repr(MEM_ARCHS)).replace(
    "SHAPES_", repr([dataclasses.astuple(s) for s in MEM_SHAPES]))


@pytest.fixture(scope="module", autouse=True)
def reference_memory():
    """The reference's argument bytes, from a subprocess started before
    the first case and read by the last ones."""
    proc = subprocess.Popen([sys.executable, "-c", REF_MEMORY],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=".",
                            env={**__import__("os").environ,
                                 "JAX_PLATFORMS": "cpu"})
    cache = {}

    def result() -> dict:
        if not cache:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-2000:]
            line = next(x for x in out.splitlines() if x.startswith("MEM "))
            cache.update(json.loads(line[4:]))
        return cache

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# configs, batch specs, accounting: equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_cells_equal_reference(arch):
    cfg, ref = get_config(arch), ref_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cells_for(arch) == ref_cells_for(arch)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_specs_equal_reference(arch, shape):
    ours = build_model(get_config(arch), device="cpu").batch_specs(
        SHAPES[shape])
    ref = ref_build(ref_config(arch)).batch_specs(REF_SHAPES[shape])
    assert list(ours) == list(ref)
    for key, spec in ours.items():
        assert spec.shape == tuple(ref[key].shape), key
        assert str(spec.dtype).removeprefix("torch.") \
            == jnp.dtype(ref[key].dtype).name, key
        assert spec.nbytes == ref[key].size * jnp.dtype(
            ref[key].dtype).itemsize


@pytest.mark.parametrize("arch,shape", CELLS)
def test_probes_and_attention_adjustment_equal_reference(arch, shape):
    cfg, ref = get_config(arch), ref_config(arch)
    small, big, l_small, scaling = ACC.probe_configs(cfg)
    r_small, r_big, r_l, r_scaling = REF_ACC.probe_configs(ref)
    assert (l_small, scaling) == (r_l, r_scaling)
    assert dataclasses.asdict(small) == dataclasses.asdict(r_small)
    assert dataclasses.asdict(big) == dataclasses.asdict(r_big)
    spec = SHAPES[shape]
    assert ACC.attention_adjustment(cfg, spec, spec.kind) \
        == REF_ACC.attention_adjustment(ref, REF_SHAPES[shape], spec.kind)
    cost1 = {"flops": 3.0e12, "bytes accessed": 5.0e9}
    cost2 = {"flops": 4.5e12, "bytes accessed": 7.5e9}
    coll1 = {"all-reduce": 1e6, "all-to-all": 2e6}
    coll2 = {"all-reduce": 3e6, "all-to-all": 2e6, "all-gather": 5.0}
    assert ACC.combine_probe(cost1, coll1, cost2, coll2, scaling) \
        == REF_ACC.combine_probe(cost1, coll1, cost2, coll2, scaling)


def test_accounting_probe_combination():
    c1 = {"flops": 100.0, "bytes accessed": 10.0}
    c2 = {"flops": 160.0, "bytes accessed": 14.0}
    coll1 = {"all-reduce": 8.0}
    coll2 = {"all-reduce": 11.0}
    flops, nbytes, coll = ACC.combine_probe(c1, coll1, c2, coll2,
                                            scaling=10)
    assert flops == 100 + 10 * 60
    assert nbytes == 10 + 10 * 4
    assert coll["all-reduce"] == 8 + 10 * 3


def test_probe_configs_layer_counts():
    cfg = get_config("deepseek-v2-236b")
    small, big, lsmall, scaling = ACC.probe_configs(cfg)
    assert small.n_layers == 2 and big.n_layers == 3  # 1 dense + 1/2 moe
    assert scaling == (60 - 1) - 1  # n_moe - 1 = 58
    assert small.scan_unroll and big.scan_unroll

    cfg = get_config("zamba2-1.2b")
    small, big, _, scaling = ACC.probe_configs(cfg)
    assert small.n_layers == 8 and big.n_layers == 14  # seg(6)+rem(2)
    assert scaling == 5


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cost", [
    {"flops": 197e12, "bytes accessed": 819e9 * 2},
    {"flops": 3.2e13, "bytes accessed": 1.0e9},
    {"flops": 0.0, "bytes accessed": 4.0e6},
])
def test_analyze_row_and_table_equal_reference(cost):
    kw = dict(arch="a", shape="s", mesh_name="16x16", chips=256, cost=cost,
              model_flops=197e12 * 256 * 0.5)
    ref = REF_RL.analyze(hlo_text=HLO_SAMPLE, **kw)
    ours = RL.analyze(coll=REF_RL.collective_bytes(HLO_SAMPLE),
                      peak_flops=REF_RL.PEAK_FLOPS_BF16,
                      hbm_bw=REF_RL.HBM_BW, link_bw=REF_RL.ICI_BW, **kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.row() == ref.row()
    assert ours.t_bound == ref.t_bound
    assert RL.format_table([ours, ours]) == REF_RL.format_table([ref, ref])
    assert RL.format_table([]) == REF_RL.format_table([])


def test_roofline_terms_on_the_cards_peaks():
    r = RL.analyze(arch="a", shape="s", mesh_name="1x1", chips=1,
                   cost={"flops": 989e12, "bytes accessed": 3.35e12 * 2},
                   coll={"all-reduce": 450e9 * 3, "_counts": {}},
                   model_flops=989e12 * 0.5)
    assert math.isclose(r.t_compute, 1.0) and math.isclose(r.t_memory, 2.0)
    assert math.isclose(r.t_collective, 3.0)
    assert r.bottleneck == "collective"
    assert math.isclose(r.roofline_fraction(), 1 / 3)
    assert RL.LINK_BYTES_PER_S == 50e9
    assert RL.collective_time_s(100e9) == 2.0


def test_collective_bytes_of_a_psummed_product():
    """The port's counterpart of the reference's
    ``test_collective_bytes_real_program``: x [64, 512] split over its
    columns, w [512, 32] over its rows, each member's partial product
    ``psum``-med over the (8,) mesh."""
    gen = np.random.default_rng(3)
    x = torch.from_numpy(gen.standard_normal((64, 512), dtype=np.float32))
    w = torch.from_numpy(gen.standard_normal((512, 32), dtype=np.float32))
    with pm.logical_devices(8):
        mesh = pm.make_mesh((8,), ("tp",))
        pm.moved_clear()
        xs = pm.shard(mesh, x, P(None, "tp"))
        ws = pm.shard(mesh, w, P("tp", None))
        partial = pm.map_members(mesh, lambda _, a, b: a @ b, xs, ws)
        y = pm.psum(mesh, partial, "tp")
        coll = RL.collective_bytes(pm.moved, pm.calls)
    np.testing.assert_allclose(y[(0,)].numpy(), (x @ w).numpy(), rtol=0,
                               atol=1e-3)
    assert coll["all-reduce"] >= 64 * 32 * 4, coll
    assert coll["all-reduce"] == collectives.ring_allgather_bytes(
        64 * 32 * 4, 8) == pm.moved["psum"]
    assert coll["_counts"]["all-reduce"] == 1
    assert coll["reduce-scatter"] == 0
    pm.moved_clear()
    assert not any(pm.moved.values()) and not any(pm.calls.values())


# ---------------------------------------------------------------------------
# StepCounter and the probes
# ---------------------------------------------------------------------------

def _count(cfg, shape, mesh_shape=(1, 1), accounting="counted"):
    with pm.logical_devices(math.prod(mesh_shape)), fakecuda.fake_cuda():
        mesh = pm.make_mesh(mesh_shape, AXES,
                            DR.fake_devices(math.prod(mesh_shape)))
        return DR.count_cell(cfg, shape, mesh, mesh_name="x",
                             accounting=accounting)


def test_counted_attention_and_gemm_flops():
    cfg = get_smoke_config("qwen1.5-0.5b")
    b, s = 2, 4096
    assert s > BLOCKWISE_SEQ_THRESHOLD
    shape = ShapeSpec("p", "prefill", s, b)
    records = []
    widesa_mm.fake_sinks.append(records.append)
    try:
        with fakecuda.fake_cuda(), torch.no_grad():
            api = build_model(cfg, device="cuda")
            params = api.init(torch.Generator().manual_seed(0))
            tokens = torch.zeros((b, s), dtype=torch.int32, device="cuda")
            with ACC.StepCounter() as counter:
                api.prefill(params, {"tokens": tokens}, s)
    finally:
        widesa_mm.fake_sinks.remove(records.append)
    assert counter.flops["matmul"] == ACC.attention_adjustment(
        cfg, shape, "prefill")
    assert counter.flops["attention"] == 0
    d, hd, ff = cfg.d_model, cfg.hd, cfg.d_ff
    per_layer = 2 * b * s * d * (cfg.n_heads * hd) * 2 \
        + 2 * b * s * d * (cfg.n_kv_heads * hd) * 2 \
        + 2 * b * s * d * ff * 3
    gemm = cfg.n_layers * per_layer + 2 * b * d * cfg.vocab  # + lm_head
    assert counter.flops["kernel"] == gemm
    assert sum(r["flops"] for r in records) == gemm
    assert all(r["flops"] == 2 * r["batch"] * r["m"] * r["n"] * r["k"]
               for r in records)
    assert counter.kernels == {"mm/wgmma": cfg.n_layers * 7,
                               "mm/skinny": 1}
    assert counter.peak > 0 and counter.live <= counter.peak
    assert counter.bytes > 0 and counter.flops["other"] > 0


PROBE_CASES = [
    ("qwen1.5-0.5b", 4), ("olmoe-1b-7b", 4), ("zamba2-1.2b", 7),
]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch,layers", PROBE_CASES)
def test_probe_combination_equals_whole_count(arch, layers, kind):
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=layers)
    shape = ShapeSpec(kind, kind, 16 if kind == "prefill" else 32, 8)
    whole = _count(cfg, shape, (2, 4), "counted")
    probe = _count(cfg, shape, (2, 4), "probe")
    _, _, _, scaling = ACC.probe_configs(cfg)
    assert probe.accounting == f"probe(L1,L2,x{scaling})"
    assert whole.accounting == "counted"
    assert probe.flops_global == whole.flops_global
    assert probe.bytes_global == whole.bytes_global
    assert probe.kernels == whole.kernels
    assert probe.coll == whole.coll
    assert probe.memory["argument_bytes"] == whole.memory["argument_bytes"]
    if arch == "olmoe-1b-7b":  # the TP mesh path's psum and pmean
        assert whole.coll["all-reduce"] > 0
        assert whole.coll["_counts"]["all-reduce"] == 2 * layers


# ---------------------------------------------------------------------------
# argument bytes against XLA's memory analysis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MEM_SHAPES, ids=[s.kind for s in MEM_SHAPES])
@pytest.mark.parametrize("arch", MEM_ARCHS)
def test_argument_bytes_equal_xla_memory_analysis(arch, shape,
                                                  reference_memory):
    cfg = get_smoke_config(arch)
    with pm.logical_devices(8), fakecuda.fake_cuda():
        mesh = pm.make_mesh((2, 4), AXES, DR.fake_devices(8))
        with mesh_context(mesh, fsdp=cfg.fsdp) as ctx:
            params = build_model(cfg, "cuda").init(
                torch.Generator().manual_seed(0))
            ours = DR.argument_bytes(cfg, shape, mesh, ctx, params)
    assert ours["argument_bytes"] == reference_memory()[f"{arch}/{shape.name}"]


# ---------------------------------------------------------------------------
# the launch boundary and the fake bindings
# ---------------------------------------------------------------------------

ROUTE_CASES = [((4, 64), (64, 96), 0), ((40, 64), (64, 96), 0),
               ((40, 64), (64, 96), 2), ((40, 60), (60, 96), 0),
               ((40, 64), (64, 97), 1)]


@pytest.mark.parametrize("a_shape,b_shape,offset", ROUTE_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8])
def test_fake_operands_take_the_real_route(a_shape, b_shape, offset, dtype):
    """``runtime.gemm_tile`` reads B's copy width and TMA's alignment from
    ``runtime.address``: a fake operand, a base 512-byte aligned, routes
    as the same tensor does (the CPU allocator's 64-byte aligned bases)."""
    def operands():
        a = torch.zeros(a_shape, dtype=dtype)
        b = torch.zeros(b_shape[0] * b_shape[1] + offset,
                        dtype=dtype)[offset:].view(b_shape)
        return a, b

    real = runtime.gemm_tile(*operands(), (64, 64, 32))
    assert all(runtime.address(t) % 64 == 0 for t in operands()[:1])
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        a, b = (mode.from_tensor(t) for t in operands())
    assert runtime.is_fake(a) and not runtime.is_fake(operands()[0])
    assert runtime.address(b) == runtime.FAKE_BASE_ALIGN \
        + offset * b.element_size()
    assert runtime.gemm_tile(a, b, (64, 64, 32)) == real


def test_fake_launch_records_and_real_cpu_operand_raises():
    tiles = runtime.SkinnyTile(split=1, kblk=64)
    records = []
    widesa_mm.fake_sinks.append(records.append)
    try:
        with fakecuda.fake_cuda():
            a = torch.zeros((4, 64), dtype=torch.bfloat16, device="cuda")
            b = torch.zeros((64, 32), dtype=torch.bfloat16, device="cuda")
            out = torch.empty((4, 32), dtype=torch.bfloat16, device="cuda")
            name = widesa_mm.launch(a, b, out, tiles, 64, 0, 32, 64 * 32, 16,
                                    batched=False)
            counts = widesa_mm.launches, dict(widesa_mm.variants), \
                bmm_mod.launches, dict(bmm_mod.variants)
            c = widesa_mm.matmul(a, b, tiles=tiles)
            z = bmm_mod.bmm(a[None], b[None], tiles=tiles)
            assert (widesa_mm.launches, widesa_mm.variants, bmm_mod.launches,
                    bmm_mod.variants) == counts
            assert c.shape == (4, 32) and z.shape == (1, 4, 32)
    finally:
        widesa_mm.fake_sinks.remove(records.append)
    assert name is None
    assert [r["kernel"] for r in records] == ["mm", "mm", "bmm"]
    assert records[1] == records[0]
    records = records[:1]
    assert records == [{"kernel": "mm", "variant": "skinny",
                        "tiles": repr(tiles), "batch": 1, "m": 4, "n": 32,
                        "k": 64, "dtype": "bfloat16",
                        "flops": 2 * 4 * 32 * 64,
                        "bytes": (4 * 64 + 64 * 32 + 4 * 32) * 2}]
    a = torch.zeros((4, 64), dtype=torch.bfloat16)
    b = torch.zeros((64, 32), dtype=torch.bfloat16)
    out = torch.empty((4, 32), dtype=torch.bfloat16)
    with pytest.raises((AssertionError, RuntimeError)):
        widesa_mm.launch(a, b, out, tiles, 64, 0, 32, 64 * 32, 16,
                         batched=False)
    assert records == records[:1]


INDICES = [0, -1, slice(1, 3), (slice(None), 2), (Ellipsis, 1), (None, 0),
           (1, None, slice(None, None, 2)), [0, 2], (slice(None), [1, 0]),
           (torch.tensor([0, 2]), torch.tensor([1, 1])),
           (torch.tensor([[0], [2]]), slice(1, 3), torch.tensor([1, 0])),
           (Ellipsis, torch.tensor([3, 0])), (torch.tensor(1),),
           (slice(None), None, torch.tensor([[2, 3]]))]


@pytest.mark.parametrize("idx", INDICES, ids=[str(i) for i in
                                                range(len(INDICES))])
def test_guard_free_indexing_equals_pytorch(idx):
    x = torch.arange(3 * 4 * 5, dtype=torch.float32).reshape(3, 4, 5)
    assert torch.equal(fakecuda._getitem(x, idx), x[idx])
    y, z = x.clone(), x.clone()
    value = -torch.arange(x[idx].numel(), dtype=torch.float32).reshape(
        x[idx].shape)
    fakecuda._setitem(y, idx, value)
    z[idx] = value
    assert torch.equal(y, z)
    fakecuda._setitem(y, idx, 7.0)
    z[idx] = 7.0
    assert torch.equal(y, z)


def test_fake_cuda_runs_bindings_and_refuses_host_syncs():
    with fakecuda.fake_cuda():
        x = torch.zeros((4, 6), device="cuda")
        m = torch.zeros((4, 6), dtype=torch.bool, device="cuda")
        assert x[1:3, ::2].shape == (2, 3) and x.device.type == "cuda"
        x[0] = 1.0
        assert x.t().contiguous().is_contiguous()
        assert (~m).dtype == torch.bool
        assert x.to("cuda", torch.bfloat16).dtype == torch.bfloat16
        mesh = pm.make_mesh((2, 2), ("data", "model"), DR.fake_devices(4))
        assert {d.type for d in mesh.devices.flat} == {"cuda"}
        from torch._subclasses.fake_tensor import \
            DataDependentOutputException
        with pytest.raises(DataDependentOutputException):
            x.sum().item()
    assert pm.default_kind() == ("cuda" if torch.cuda.is_available()
                                 else "cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_writes_one_json_a_cell(tmp_path, capsys):
    rc = DR.main(["--arch", "qwen1.5-0.5b", "--shape",
                  "decode_32k,train_4k,long_500k", "--mesh", "single",
                  "--out", str(tmp_path)])
    out = capsys.readouterr().out
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["qwen1.5-0.5b__decode_32k__16x16.json",
                     "qwen1.5-0.5b__train_4k__16x16.json"]
    assert "SKIP qwen1.5-0.5b x long_500k" in out
    dec = json.loads((tmp_path / files[0]).read_text())
    assert dec["ok"] and dec["partition"] == "ideal"
    assert dec["collectives"] == "mesh programs" and dec["chips"] == 256
    assert dec["memory"]["argument_bytes"] > 0 and dec["flops_global"] > 0
    assert dec["bytes_global"] > 0 and dec["kernels"]
    assert dec["accounting"] == "probe(L1,L2,x23)"
    assert math.isclose(dec["flops"] * 256, dec["flops_global"])
    train = json.loads((tmp_path / files[1]).read_text())
    if torch.version.cuda is None:
        assert rc == 1 and not train["ok"]
        assert "needs PyTorch built with CUDA" in train["error"]
    assert "cells OK" in out and "bound" in out
