"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names compared whole (``repro_torch`` is the port, ``repro`` is
not)."""

import ast
import subprocess
import sys

import tiny
import harness


def test_sources_import_no_jax_and_no_reference_package():
    for path in harness.BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_a_run_loads_no_forbidden_module():
    """A whole tiny run on the CPU (drivers, readers, reference, trace
    reader) in a fresh interpreter, then ``sys.modules`` checked."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import tiny, harness, run, trace, sweep, control\n"
        "for name in ('olmoe-chat', 'stablelm-batch', 'olmoe-train'):\n"
        "    tiny.run_tiny(name, seconds=0.3)\n"
        "for m in harness.benchmark()['end_to_end'] + "
        "harness.benchmark()['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "print(harness.forbidden_modules())\n"
    ) % str(tiny.BENCH / "tests")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_names():
    mods = dict(sys.modules)
    try:
        sys.modules["repro_torch_fake"] = sys
        sys.modules["jaxfake.x"] = sys
        assert "repro_torch_fake" not in harness.forbidden_modules()
        assert "jaxfake.x" not in harness.forbidden_modules()
        sys.modules["repro.core"] = sys
        assert "repro.core" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def test_no_card_exits_nonzero_without_a_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "olmoe-chat", "--seed", str(2**31 + 5),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(harness.ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
