"""What every cell shares: where the benchmark's files are, finding a
cell's configuration, traffic, driver, limits and metric readers by name,
the run's caches, the card's description and the guard against the JAX
package.

A cell is one ``workloads`` entry of ``BENCHMARK.json``.  Its
configuration is ``configs/<config>.json``, its traffic
``traffic/<traffic>.json`` (whose ``kind`` names ``drivers/<kind>.py``),
its correctness limits ``limits/<cell>.json``, and each metric it reports
``metrics/<metric>.py`` (or, for a name with a suffix such as
``mfu.chat``, ``metrics/<mfu>.py`` when no file of the whole name
exists).  A new configuration, traffic mix, cell or metric is a new file
and a new entry; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level module names that may not be loaded: JAX, its libraries and
#: the JAX package this port was made from (compared whole: ``repro_torch``
#: is the port, ``repro`` is not)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_cache_dirs() -> None:
    """Every build and kernel cache in fixed directories inside the
    checkout (the port's own nvcc outputs already go to
    ``build/repro_torch_kernels``), set before torch is imported."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    # one process with few threads: the host loop is single-threaded, and
    # idle worker pools on a shared host only add jitter
    os.environ["OMP_NUM_THREADS"] = "1"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, spec: dict | None = None) -> dict:
    """The ``workloads`` entry named ``name`` with its configuration,
    traffic, limits and metric lists resolved from their files."""
    spec = spec or benchmark()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def reported(metrics):
        return [m for m in metrics
                if name in m.get("workloads", [name])]

    return {
        "name": name, "chips": w["chips"], "entry": w,
        "config": load_json(ROOT / conf["file"]),
        "config_name": w["config"],
        "traffic": load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(BENCH / "limits" / f"{name}.json"),
        "end_to_end": reported(spec["end_to_end"]),
        "per_layer": reported(spec["per_layer"]),
    }


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """``drivers/<kind>.py``: its ``run(ctx)`` runs a cell's traffic."""
    path = BENCH / "drivers" / f"{kind}.py"
    if not path.exists():
        raise KeyError(f"no driver {path.relative_to(ROOT)} for traffic "
                       f"kind {kind!r}")
    return _load_file(path, f"bench_driver_{kind}")


def reader(metric: str):
    """The reader of ``metric``: ``metrics/<metric>.py``, else the file of
    the name's part before its first dot.  Its ``read(rec)`` returns the
    value, or None where the run holds nothing to read."""
    for stem in (metric, metric.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            return _load_file(path, "bench_metric_" + stem.replace(".", "_")
                              .replace("-", "_"))
    raise KeyError(f"no reader metrics/{metric}.py for metric {metric!r}")


def port_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file: its ``port``
    fields, nothing taken from the port's own registry."""
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(**config["port"])


def device_info(torch) -> dict:
    """The card as the result line names it, and its power limit."""
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"kind": name, "power_limit": out[0] if out else "not read"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, whole names
    compared."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})
