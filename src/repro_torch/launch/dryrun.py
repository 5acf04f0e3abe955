"""Dry run: every (arch x shape x mesh) cell's step counted on fake
tensors (the port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
        --shape prefill_32k --mesh both --out results/dryrun_torch

No card, no ``nvcc`` and no memory are needed: parameters, AdamW state,
the batch (``batch_specs``) and the decode cache are fake ``cuda``
tensors at full global width (``launch/fakecuda.py``), drawn with a CPU
generator, and the step (``train/step.py``'s train step, grads plus the
AdamW update; the prefill; one decode step against a full cache) runs
under the production mesh's context (``launch/mesh.py``: 16x16 or
2x16x16 members, every one the fake tensors' device ``FAKE_DEVICE``,
card or no card: ``fake_devices``) through the card's whole path up to
the GEMM wrappers' launch boundary (``kernels/widesa_mm.py``), where no
kernel runs and each launch is recorded.  ``accounting.StepCounter``
counts it.  Cells follow ``configs.cells_for`` (``long_500k`` only for
the sub-quadratic archs).

The port has no compiler and no partitioner, so a row says how each
figure was had:

* **Argument and output bytes per device are exact**: every argument's
  (and output's) shard under its logical spec tree
  (``parallel.sharding.logical_spec_tree`` and ``guard_spec``; the
  cache's axes through ``_adapt_cache_logical``), the counterpart of
  XLA's ``memory_analysis().argument_size_in_bytes``.
* **FLOPs, bytes and the activation peak are counted globally**
  (``flops_global``, ``bytes_global``, ``peak_global``): dense layers
  run whole on the controller (``sharding.constrain`` returns its input),
  so the per-chip figures divide them by the chips (FLOPs, bytes) and by
  the batch axes' width (the peak): ``"partition": "ideal"``.
* **Collective bytes** are those of the mesh programs the port runs
  under the mesh (the MoE TP and EP paths), ``parallel.mesh.moved``
  over the chips: ``"collectives": "mesh programs"``.  The FSDP and
  tensor-parallel collectives GSPMD would insert around the dense
  layers are not counted.

Accounting: encdec is counted whole (``"counted"``, the reference's
``"unrolled"``); the other families run the L = 1 and L = 2 probes of
``accounting.probe_configs`` and take ``combine_probe``'s correction
(``"probe(L1,L2,xN)"``).  Attention FLOPs are always counted.

A train cell needs a build of PyTorch with CUDA (the card's machine),
card or no card: its autograd engine asks the CUDA runtime for the
current stream of a ``cuda`` tensor's device, fake or not, which a
build without CUDA cannot answer (and its autograd nodes abort the
process on a ``cuda`` tensor there).  On such a build a train cell fails
with that error before it runs; prefill and decode cells run.

A cell that fails records its error, as the reference records a failed
lowering; a host sync (``.item()``) on the path fails its cell with
``DataDependentOutputException``.  Results go to ``--out`` as one JSON a
cell, which a later run of the command line reuses when it succeeded.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import signal
import time
import traceback

import torch

from repro_torch.configs import ARCHS, SHAPES, cells_for, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core import roofline as RL
from repro_torch.launch import accounting as ACC
from repro_torch.launch.fakecuda import fake_cuda
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import TensorSpec, build_model
from repro_torch.optim import adamw_init, opt_state_logical
from repro_torch.parallel import mesh as pm
from repro_torch.parallel.sharding import (MeshCtx, guard_spec,
                                           logical_spec_tree, map_spec_tree,
                                           mesh_context)

#: the card's memory, bytes: the H100 SXM data sheet's 80 GB
CARD_MEMORY_BYTES = 80e9
#: the production meshes' logical device count
PRODUCTION_DEVICES = 512
#: the device of every fake tensor, and of every member of a dry-run mesh
FAKE_DEVICE = torch.device("cuda", 0)


def fake_devices(n: int) -> list[torch.device]:
    """``n`` mesh members, all ``FAKE_DEVICE``: the devices the dry run
    computes on, whether or not a card is present."""
    return [FAKE_DEVICE] * n


def _adapt_cache_logical(cfg, logical, mesh):
    """Shard the cache: kv-heads over 'model' when divisible, else the
    sequence axis (GSPMD distributed decode attention)."""
    model = mesh.shape.get("model", 1)

    def adapt(ax):
        ax = list(ax)
        if "kv_heads" in ax:
            if cfg.n_kv_heads % model == 0 and cfg.n_kv_heads > 0:
                return tuple(ax)
            i = ax.index("kv_heads")
            ax[i] = None
            if len(ax) >= 3 and ax[2] is None:
                ax[2] = "seq_sp"  # seq axis of [L,B,S,H,hd]
            return tuple(ax)
        # MLA latent cache [L,B,S,lora]: always shard seq
        if cfg.use_mla and len(ax) == 4 and ax[2] is None and ax[0] == "layers":
            ax[2] = "seq_sp"
        return tuple(ax)

    return map_spec_tree(adapt, logical)


def _shards(mesh, spec, shape) -> int:
    """Devices one array of ``shape`` splits over under ``spec`` (after
    ``guard_spec``)."""
    n = 1
    for entry in guard_spec(mesh, spec, tuple(shape)):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            n *= mesh.shape[name]
    return n


def device_bytes(mesh, ctx: MeshCtx, logical, values) -> int:
    """Bytes one device holds of ``values`` (a tree of tensors or
    ``TensorSpec``) under the logical axes ``logical`` (a tree of the
    same structure)."""
    specs = logical_spec_tree(ctx, logical)

    def walk(spec, value) -> int:
        if isinstance(value, (dict, list)):
            if type(spec) is not type(value) or len(spec) != len(value):
                raise ValueError(f"spec tree {spec!r} does not match a "
                                 f"{type(value).__name__} of {len(value)}")
            keys = value if isinstance(value, dict) else range(len(value))
            return sum(walk(spec[k], value[k]) for k in keys)
        if value is None:
            return 0
        return value.nbytes // _shards(mesh, spec, value.shape)

    return walk(specs, values)


def _fake(spec: TensorSpec) -> torch.Tensor:
    return torch.zeros(spec.shape, dtype=spec.dtype, device="cuda")


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds: float
    error: str = ""
    flops: float = 0.0            # per chip (corrected, ideal partition)
    bytes_accessed: float = 0.0   # per chip (corrected, ideal partition)
    flops_raw: float = 0.0        # per chip, the first program counted
    coll: dict | None = None      # collective bytes per chip, + _counts
    memory: dict | None = None    # per device
    model_flops: float = 0.0
    accounting: str = ""
    chips: int = 0
    partition: str = "ideal"
    collectives: str = "mesh programs"
    flops_global: float = 0.0
    bytes_global: float = 0.0
    peak_global: float = 0.0
    kernels: dict | None = None   # launches by kernel/variant
    fits: bool = False


def _model_flops(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("true", "True"):
        return k, True
    if v in ("false", "False"):
        return k, False
    return k, v


@dataclasses.dataclass
class StepCount:
    """One program's counts (``StepCounter``'s) and its outputs."""

    flops: int
    bytes: int
    peak: int
    kernels: dict
    moved: dict
    calls: dict
    out: object


def _step_inputs(api, cfg, shape: ShapeSpec, params):
    batch = {k: _fake(v) for k, v in api.batch_specs(shape).items()}
    if shape.kind == "train":
        return (params, adamw_init(params), batch, 0)
    if shape.kind == "prefill":
        batch.pop("labels")
        return (params, batch)
    cache = api.init_cache(shape.global_batch, shape.seq_len)
    return (params, cache, torch.zeros((shape.global_batch, 1),
                                       dtype=torch.int32, device="cuda"))


def _run_step(api, cfg, shape: ShapeSpec, inputs):
    if shape.kind == "train":
        from repro_torch.train.step import make_train_step
        return make_train_step(api, cfg)(*inputs)
    with torch.no_grad():
        if shape.kind == "prefill":
            return api.prefill(inputs[0], inputs[1], shape.seq_len)
        return api.decode(*inputs)


def count_step(cfg: ModelConfig, shape: ShapeSpec, generator) -> StepCount:
    """Build ``cfg``'s fake parameters and the step's inputs (arguments,
    not counted), then run the step under ``StepCounter``.  Call under
    ``fake_cuda()`` and the mesh context."""
    api = build_model(cfg, device="cuda")
    inputs = _step_inputs(api, cfg, shape, api.init(generator))
    with ACC.StepCounter() as counter:
        out = _run_step(api, cfg, shape, inputs)
    return StepCount(counter.total_flops, counter.bytes, counter.peak,
                     dict(counter.kernels), counter.moved, counter.calls,
                     out)


def argument_bytes(cfg, shape: ShapeSpec, mesh, ctx: MeshCtx,
                   params) -> dict:
    """Bytes one device holds of the step's arguments (module docstring),
    and of its parameters alone: the parameters, AdamW's ``m``, ``v`` and
    ``count``, the batch and the step (train); the parameters and the
    batch without labels (prefill); the parameters, the cache and the
    tokens (decode)."""
    api = build_model(cfg, device="cuda")
    p_log = api.param_logical()
    param_b = device_bytes(mesh, ctx, p_log, params)
    specs = api.batch_specs(shape)
    b_log = api.batch_logical()
    if shape.kind == "train":
        o_log = opt_state_logical(p_log)
        opt = adamw_init(params)
        args = (param_b + device_bytes(mesh, ctx, o_log.m, opt.m)
                + device_bytes(mesh, ctx, o_log.v, opt.v) + 4
                + device_bytes(mesh, ctx, b_log, specs) + 4)
    elif shape.kind == "prefill":
        specs = {k: v for k, v in specs.items() if k != "labels"}
        args = param_b + device_bytes(
            mesh, ctx, {k: b_log[k] for k in specs}, specs)
    else:
        tokens = TensorSpec((shape.global_batch, 1), torch.int32)
        args = param_b + _cache_bytes(cfg, shape, mesh, ctx, api) \
            + device_bytes(mesh, ctx, ("batch", None), tokens)
    return {"argument_bytes": args, "parameter_bytes": param_b}


def _cache_bytes(cfg, shape, mesh, ctx, api) -> int:
    cache = api.init_cache(shape.global_batch, shape.seq_len)
    c_log = _adapt_cache_logical(cfg, api.cache_logical(), mesh)
    return device_bytes(mesh, ctx, c_log, cache)


def output_bytes(cfg, shape: ShapeSpec, mesh, ctx: MeshCtx, mem: dict,
                 count: StepCount) -> int:
    """Bytes one device holds of the step's outputs, placed as its
    arguments are: the new parameters and AdamW state and the loss
    (train); the logits, sharded ("batch", "vocab"), and the cache
    (prefill, decode)."""
    api = build_model(cfg, device="cuda")
    if shape.kind == "train":  # the batch out, the loss for the step
        return mem["argument_bytes"] - device_bytes(
            mesh, ctx, api.batch_logical(), api.batch_specs(shape))
    logits = count.out[0]
    return device_bytes(mesh, ctx, ("batch", "vocab"), logits) \
        + _cache_bytes(cfg, shape, mesh, ctx, api)


def count_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               mesh_name: str, multi_pod: bool = False,
               accounting: str | None = None) -> CellResult:
    """One cell on ``mesh`` (module docstring).  ``accounting``
    ``"counted"`` runs the whole step; ``"probe"`` the L = 1 / L = 2
    probes; the default is the reference's choice by family.  Call under
    ``fake_cuda()`` with enough logical devices for ``mesh``."""
    if shape.kind == "train" and torch.version.cuda is None:
        raise RuntimeError(
            "a train cell needs PyTorch built with CUDA: the autograd "
            "engine asks the CUDA runtime for the current stream of a "
            "cuda tensor's device, fake or not (a build without CUDA "
            f"has none; this torch is {torch.__version__})")
    t0 = time.time()
    accounting = accounting or (
        "counted" if cfg.family == "encdec" else "probe")
    chips = mesh.devices.size
    batch_width = 1
    for axis in (("pod", "data") if multi_pod else ("data",)):
        batch_width *= mesh.shape.get(axis, 1)
    generator = torch.Generator().manual_seed(0)
    with mesh_context(mesh, multi_pod=multi_pod, fsdp=cfg.fsdp) as ctx:
        if accounting == "counted":
            whole = count_step(cfg, shape, generator)
            flops, nbytes = float(whole.flops), float(whole.bytes)
            peak, kernels = float(whole.peak), whole.kernels
            coll = RL.collective_bytes(whole.moved, whole.calls)
            counts = coll.pop("_counts")
            flops_raw, label, first = flops, "counted", whole
        else:
            small, big, _, scaling = ACC.probe_configs(cfg)
            c1 = count_step(small, shape, generator)
            c2 = count_step(big, shape, generator)
            coll1 = RL.collective_bytes(c1.moved, c1.calls)
            coll2 = RL.collective_bytes(c2.moved, c2.calls)
            flops, nbytes, coll = ACC.combine_probe(
                {"flops": c1.flops, "bytes accessed": c1.bytes}, coll1,
                {"flops": c2.flops, "bytes accessed": c2.bytes}, coll2,
                scaling)
            counts = ACC.combine_linear(coll1["_counts"], coll2["_counts"],
                                        scaling)
            peak = ACC.combine_linear({"p": c1.peak}, {"p": c2.peak},
                                      scaling)["p"]
            kernels = ACC.combine_linear(c1.kernels, c2.kernels, scaling)
            flops_raw, label, first = float(c1.flops), \
                f"probe(L1,L2,x{scaling})", c1
        params = build_model(cfg, device="cuda").init(generator)
        mem = argument_bytes(cfg, shape, mesh, ctx, params)
        mem["output_bytes"] = output_bytes(cfg, shape, mesh, ctx, mem,
                                           first)
    coll = {k: v / chips for k, v in coll.items()}
    coll["_counts"] = counts
    mem["temp_bytes"] = peak / batch_width
    mem["generated_code_bytes"] = 0
    fits = (mem["argument_bytes"] + mem["output_bytes"]
            + mem["temp_bytes"]) <= CARD_MEMORY_BYTES
    return CellResult(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, ok=True,
        seconds=time.time() - t0, flops=flops / chips,
        bytes_accessed=nbytes / chips, flops_raw=flops_raw / chips,
        coll=coll, memory=mem, model_flops=_model_flops(cfg, shape),
        accounting=label, chips=chips, flops_global=flops,
        bytes_global=nbytes, peak_global=peak, kernels=kernels, fits=fits)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: dict | None = None) -> CellResult:
    """One cell of the production grid (module docstring)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    with pm.logical_devices(PRODUCTION_DEVICES), fake_cuda():
        mesh = make_production_mesh(
            multi_pod=multi_pod,
            devices_list=fake_devices(PRODUCTION_DEVICES))
        return count_cell(cfg, SHAPES[shape_name], mesh,
                          mesh_name="2x16x16" if multi_pod else "16x16",
                          multi_pod=multi_pod)


def roofline_of(res: dict) -> RL.Roofline:
    """The three-term roofline of a succeeded cell's JSON."""
    return RL.analyze(
        arch=res["arch"], shape=res["shape"], mesh_name=res["mesh"],
        chips=res["chips"],
        cost={"flops": res["flops"], "bytes accessed": res["bytes_accessed"]},
        coll=res["coll"], model_flops=res["model_flops"])


class CellTimeout(Exception):
    """A cell ran past ``run_cells``' ``cell_timeout``."""


def _alarm(signum, frame):
    raise CellTimeout("the cell ran past its time limit")


def _cell_job(arch: str, shape_name: str, multi_pod: bool,
              overrides: dict | None, timeout: int = 0) -> dict:
    """One cell as a JSON-ready dict: its result, or its error (a
    ``CellTimeout`` past ``timeout`` seconds, when given)."""
    if timeout:
        signal.signal(signal.SIGALRM, _alarm)
        signal.alarm(timeout)
    try:
        res = lower_cell(arch, shape_name, multi_pod, overrides=overrides)
    except Exception as e:  # noqa: BLE001
        res = CellResult(
            arch=arch, shape=shape_name,
            mesh="2x16x16" if multi_pod else "16x16", ok=False, seconds=0.0,
            error=f"{type(e).__name__}: {e}\n"
                  f"{traceback.format_exc()[-2000:]}")
    finally:
        if timeout:
            signal.alarm(0)
    return dataclasses.asdict(res)


def run_cells(archs, shapes, meshes, out_dir, overrides=None, tag="",
              jobs: int = 1, cell_timeout: int = 0, reuse: bool = True):
    """Every allowed cell of ``archs`` x ``shapes`` x ``meshes``, ``jobs``
    at a time (each in a process of its own when ``jobs`` > 1), each cut
    at ``cell_timeout`` seconds (0: no limit) with a ``CellTimeout``; with
    ``reuse``, a cell whose JSON in ``out_dir`` succeeded is read back, not
    run again (without it every cell is counted afresh and its JSON
    rewritten)."""
    os.makedirs(out_dir, exist_ok=True)
    results: dict[str, dict] = {}
    todo = []
    for arch in archs:
        allowed = cells_for(arch)
        for shape_name in shapes:
            if shape_name not in allowed:
                print(f"SKIP {arch} x {shape_name} (long-context rule)")
                continue
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                cell_tag = f"{arch}__{shape_name}__{mesh_name}" + (
                    f"__{tag}" if tag else "")
                path = os.path.join(out_dir, cell_tag + ".json")
                results[cell_tag] = None
                if reuse and os.path.exists(path):
                    with open(path) as f:
                        cached = json.load(f)
                    if cached.get("ok"):
                        print(f"CACHED {cell_tag}")
                        results[cell_tag] = cached
                        continue
                    os.remove(path)  # retry failures
                todo.append((cell_tag, path, (arch, shape_name, mp,
                                              overrides, cell_timeout)))

    def done(cell_tag, path, d):
        with open(path, "w") as f:
            json.dump(d, f, indent=1)
        results[cell_tag] = d
        print(f"  -> {cell_line(d)}", flush=True)

    if jobs > 1 and len(todo) > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                jobs, mp_context=ctx) as pool:
            futures = {pool.submit(_cell_job, *job): (cell_tag, path)
                       for cell_tag, path, job in todo}
            print(f"COUNT {len(todo)} cells, {jobs} at a time ...",
                  flush=True)
            for fut in concurrent.futures.as_completed(futures):
                done(*futures[fut], fut.result())
    else:
        for cell_tag, path, job in todo:
            print(f"COUNT {cell_tag} ...", flush=True)
            done(cell_tag, path, _cell_job(*job))
    return list(results.values())


def cell_line(d: dict) -> str:
    """One line of a cell's result."""
    if not d["ok"]:
        return (f"FAIL {d['arch']} x {d['shape']} x {d['mesh']}: "
                f"{d['error'].splitlines()[0]}")
    mem = d["memory"]
    return (f"OK {d['arch']} x {d['shape']} x {d['mesh']} "
            f"({d['seconds']:.1f}s) {d['accounting']}: "
            f"args/dev {mem['argument_bytes'] / 2**30:.3f} GiB, "
            f"flops_global {d['flops_global']:.4e}, "
            f"bytes_global {d['bytes_global']:.4e}, "
            f"peak_global {d['peak_global'] / 2**30:.3f} GiB, "
            f"fits {d['fits']}, kernels {d['kernels']}, "
            f"partition {d['partition']}, collectives {d['collectives']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override, e.g. --override moe_ep=true")
    ap.add_argument("--tag", default="",
                    help="suffix for result files (variant runs)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells counted at a time, each in a process")
    args = ap.parse_args(argv)
    overrides = dict(_parse_override(kv) for kv in args.override) or None

    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = run_cells(archs, shapes, meshes, args.out,
                        overrides=overrides, tag=args.tag, jobs=args.jobs)
    n_ok = sum(r["ok"] for r in results)
    rows = [roofline_of(r) for r in results if r["ok"]]
    print("\n" + RL.format_table(rows))
    print(f"\n==== dry-run: {n_ok}/{len(results)} cells OK ====")
    for r in results:
        if not r["ok"]:
            print(f"FAILED: {r['arch']} x {r['shape']} x {r['mesh']}: "
                  f"{r['error'].splitlines()[0]}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
