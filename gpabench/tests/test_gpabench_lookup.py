"""Cells, configurations, traffic, limits and metrics found by name, a
cell and a metric added by new files alone, and BENCHMARK.json against
the benchmark's contract."""
import hashlib
import json
import os
import re
import shutil
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from gpabench.harness import bench  # noqa: E402

ROOT = bench.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load():
    return bench.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("cell", [w["name"] for w in load()["workloads"]])
def test_cell_found_by_name(cell):
    c = bench.find_cell(cell)
    assert c.config["name"] == c.config_name
    assert c.traffic["source"] in ("pool", "mosaic")
    assert c.limits
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(bench.metric_reader(m["name"]))


def test_unknown_cell():
    with pytest.raises(KeyError):
        bench.find_cell("no_such.cell")


def test_contract_of_benchmark_json():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "gpabench/run.py"]
    assert b["paths"] == ["gpabench"]
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("gpabench/")
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(cells)
        assert os.path.isfile(os.path.join(ROOT, "gpabench", "metrics",
                                           m["name"] + ".py"))
    allnames = list(e2e) + [m["name"] for m in b["per_layer"]] \
        + list(cells) + list(configs)
    assert len(allnames) == len(set(allnames))
    for n in allnames:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    for w in cells:
        assert any(w in m["workloads"] for m in b["per_layer"])


def _digest(root):
    h = {}
    for d, _, files in os.walk(os.path.join(root, "gpabench")):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                h[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return h


def test_a_cell_and_a_metric_added_by_files_alone(tmp_path):
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "gpabench"),
                    os.path.join(root, "gpabench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digest(root)
    gp = os.path.join(root, "gpabench")
    with open(os.path.join(gp, "traffic", "stack16.json"), "w") as f:
        json.dump({"source": "pool", "pool": 16, "batch": 16, "noise": 0.5,
                   "field": {"amplitude": [0.02, 0.03], "centre_frac": 0.1,
                             "width_frac": [0.2, 0.33]},
                   "check": {"samples": 1, "within": 10}}, f)
    with open(os.path.join(gp, "limits", "tblg4096_series.stack16.json"),
              "w") as f:
        json.dump({"u_p99_px": {"limit": 0.01}}, f)
    with open(os.path.join(gp, "metrics", "calls_seen.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.calls_ms))\n")
    b = bench.load_json(os.path.join(root, "BENCHMARK.json"))
    b["workloads"].append({"name": "tblg4096_series.stack16",
                           "config": "tblg4096_series", "traffic": "stack16",
                           "chips": 1, "why": "a test cell"})
    b["per_layer"].append({"name": "calls_seen", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "Device", "moves": "mpix_s",
                           "workloads": ["tblg4096_series.stack16"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    c = bench.find_cell("tblg4096_series.stack16", root)
    assert c.traffic["batch"] == 16
    assert [m["name"] for m in c.per_layer] == ["idle_pct", "calls_seen"] \
        or "calls_seen" in [m["name"] for m in c.per_layer]
    read = bench.metric_reader("calls_seen", root)
    assert read(type("R", (), {"calls_ms": [1.0, 2.0]})()) == 2.0
    after = _digest(root)
    assert all(after[k] == v for k, v in before.items())
