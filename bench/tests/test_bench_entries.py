"""Every BENCHMARK.json entry loads by name, the configuration files agree
with their published keys, and a new configuration, traffic mix, cell and
per-layer metric are taken from new files and entries alone."""

import json
import shutil

import pytest

import tiny
import harness

SPEC = harness.benchmark()


def test_every_cell_resolves():
    for w in SPEC["workloads"]:
        c = harness.cell(w["name"])
        assert harness.driver(c["traffic"]["kind"]).run
        assert c["end_to_end"] and c["per_layer"]
        assert "setup_s" in [m["name"] for m in c["end_to_end"]]
        for m in c["end_to_end"] + c["per_layer"]:
            assert harness.reader(m["name"]).read
        for lim in c["limits"].values():
            assert lim["limit"] > 0


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])


def test_configs_keep_their_published_keys():
    for c in SPEC["configs"]:
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        for key, field in conf["port_keys"].items():
            assert conf["port"][field] == conf[key], (c["name"], key)
        assert harness.port_config(conf).n_layers == conf["num_hidden_layers"]


def test_names_and_units_are_plain():
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
    for x in SPEC["workloads"] + SPEC["configs"]:
        assert name.match(x["name"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_new_cell_is_new_files_and_entries(tmp_path, monkeypatch):
    """Copy the benchmark, add a configuration, a traffic mix, a cell and
    a per-layer metric as files and entries only, and run the new cell at
    a toy size: no file that was there is edited."""
    root = tmp_path / "repo"
    shutil.copytree(harness.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    conf = json.loads((harness.BENCH / "configs" / "olmoe-1b-7b.json").read_text())
    conf["port"]["name"] = "olmoe-1b-7b-copy"
    (root / "bench/configs/olmoe-copy.json").write_text(json.dumps(conf))
    tr = json.loads((harness.BENCH / "traffic" / "chat-batch.json").read_text())
    (root / "bench/traffic/chat-batch-copy.json").write_text(json.dumps(tr))
    (root / "bench/limits/olmoe-batch.json").write_text(
        json.dumps({"widest_gap": {"limit": 1.0}}))
    (root / "bench/metrics/requests_done.py").write_text(
        "def read(rec):\n    return sum(r['done'] is not None "
        "for r in rec['requests'])\n")
    spec["configs"].append({"name": "olmoe-copy", "source": conf["source"],
                            "file": "bench/configs/olmoe-copy.json",
                            "reduced": [], "why": "a copy"})
    spec["workloads"].append({"name": "olmoe-batch", "config": "olmoe-copy",
                              "traffic": "chat-batch-copy", "chips": 1,
                              "why": "a copy"})
    for m in spec["end_to_end"]:
        if m["name"] in ("tpot_p95_ms", "tok_s"):
            m["workloads"].append("olmoe-batch")
    spec["per_layer"].append({"name": "requests_done.batch", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "engine and scheduler",
                              "moves": "tok_s",
                              "workloads": ["olmoe-batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "BENCH", root / "bench")
    monkeypatch.setattr(harness, "ROOT", root)
    cell = harness.cell("olmoe-batch")
    assert [m["name"] for m in cell["per_layer"]] == ["requests_done.batch"]
    assert harness.reader("requests_done.batch").read(
        {"requests": [{"done": 1.0}, {"done": None}]}) == 1
    for p, data in before.items():
        assert p.read_bytes() == data
    monkeypatch.setattr(tiny.harness, "cell", lambda name: cell)
    rec, out = tiny.run_tiny("olmoe-batch")
    assert set(out["metrics"]) == {"tpot_p95_ms", "tok_s", "setup_s"}


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        harness.cell("no-such-cell")
    with pytest.raises(KeyError):
        harness.reader("no_such_metric.chat")
    with pytest.raises(KeyError):
        harness.driver("closed")
