"""The port and its chip smoke never load JAX or the JAX package.

Every ``repro_torch`` module, and ``chip_smoke.py``, is imported in a
fresh interpreter, which must end with neither ``jax`` nor ``repro`` in
``sys.modules``; every import statement in their sources (including the
ones inside functions, which run only on the card) is checked too.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"

_PROBE = """
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_and_chip_smoke_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(SMOKE)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["leaked"] == []
    assert {"repro_torch.kernels.planned", "repro_torch.serve.engine",
            "repro_torch.launch.serve", "repro_torch.convert",
            "repro_torch.kernels.fir", "repro_torch.kernels.conv2d",
            "repro_torch.kernels.fft2d", "repro_torch.core.fusion",
            "repro_torch.models.encdec", "repro_torch.serve.frontend",
            "repro_torch.configs.whisper_base", "repro_torch.core.codegen",
            "repro_torch.kernels.jacobi2d", "repro_torch.kernels.mttkrp",
            "repro_torch.launch.recurrences"} <= set(result["modules"])


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", [*sorted(PORT.rglob("*.py")), SMOKE],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}
