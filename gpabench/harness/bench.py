"""Everything a cell is made of, found by name: the cell in
BENCHMARK.json, its configuration's file, its traffic mix
(gpabench/traffic/<traffic>.json), its limits
(gpabench/limits/<cell>.json) and its per-layer metrics' readers
(gpabench/metrics/<metric>.py). A cell or a metric is added by adding
files and entries, never by editing a file that is there."""
import importlib.util
import json
import os
from dataclasses import dataclass, field

GPABENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(GPABENCH)


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def find_cell(name, root=ROOT):
    """The cell `name` with its configuration, traffic, limits and the
    metrics that it reports; KeyError when BENCHMARK.json has no such
    cell."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    gp = os.path.join(root, "gpabench")
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=load_json(os.path.join(root, cfg["file"])),
        traffic=load_json(os.path.join(gp, "traffic", w["traffic"] + ".json")),
        limits=load_json(os.path.join(gp, "limits", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def metric_reader(name, root=ROOT):
    """The `read` function of gpabench/metrics/<name>.py."""
    path = os.path.join(root, "gpabench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpabench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
