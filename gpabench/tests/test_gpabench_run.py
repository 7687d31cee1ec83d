"""Whole runs of each cell on the CPU at a size it holds (tiny.py): the
last line's keys, `correct` true on the program as it is; the control
(the reference with bfloat16 storage in the program's place) judged not
correct; and runs with the timed path broken underneath judged not
correct, once for each fault a cell can have:

- a step that returns its state unchanged (the extractor hands back its
  previous call's field);
- half of a stack left out, the rest's mean in its place (stack4);
- an answer altered where it is produced (a field, a refined k, a tile).

No cell spans several cards, so the exchange between cards has no fault
to plant. The look for a card is skipped: run_cell takes the device."""
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from gpabench import readings  # noqa: E402
from gpabench.harness import bench, entries, main as hm, sources  # noqa
from gpabench.tests import tiny  # noqa: E402

CELLS = ["tblg4096_series.frame", "tblg4096_series.stack4",
         "tblg4096_series.mosaic16k", "tblg4096_quickstart.image"]
SEED = 2 ** 31 + 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    pytest.importorskip("pygpa_tpu_torch")
    return tiny.make_root(tmp_path_factory.mktemp("gpabench"))


def run(root, cell, seconds=0.5):
    return hm.run_cell(bench.find_cell(cell, root), SEED, seconds, False,
                       "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_last_line(root, cell):
    res = run(root, cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    json.dumps(res)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"mpix_s", "call_p90_ms", "peak_mem_gib",
                                   "setup_s"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == set(bench.find_cell(cell, root).limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    c = bench.find_cell(cell, root)
    src = sources.make(c.config, c.traffic, SEED, "cpu")
    entry = entries.make(c.config, c.traffic, "cpu")
    item, x = src.next(keep=True)
    if c.traffic["source"] == "mosaic":
        entry(x)
    numbers = readings.control_numbers(c, src, entry, item, "cpu")
    src.close()
    ok, lines = __import__("gpabench.harness.check",
                           fromlist=["verdict"]).verdict(numbers, c.limits)
    assert not ok, lines


def faulty_factory(monkeypatch, fault):
    import pygpa_tpu_torch as gt
    real = gt.gpa.pipeline.make_displacement_extractor

    def make(*a, **k):
        run = real(*a, **k)
        state = {}

        def broken(x, events=None):
            u = run(x, events=events)
            if fault == "unchanged":
                prev = state.get("u")
                state["u"] = u
                return u if prev is None else prev
            if fault == "half":
                keep = u[: u.shape[0] // 2]
                return torch.cat([keep, keep.mean(0, keepdim=True).expand(
                    u.shape[0] - keep.shape[0], *u.shape[1:])])
            u = u.clone()
            u[..., 100:140, 100:140] += 0.05
            return u
        broken.plan, broken.sigma = run.plan, run.sigma
        return broken
    monkeypatch.setattr(gt.gpa.pipeline, "make_displacement_extractor", make)


@pytest.mark.parametrize("cell,fault", [
    ("tblg4096_series.frame", "unchanged"),
    ("tblg4096_series.frame", "altered"),
    ("tblg4096_series.stack4", "half"),
    ("tblg4096_series.stack4", "altered"),
    ("tblg4096_series.mosaic16k", "altered")])
def test_broken_factory_is_not_correct(root, monkeypatch, cell, fault):
    faulty_factory(monkeypatch, fault)
    assert run(root, cell)["correct"] is False


def test_altered_tiles_are_not_correct(root, monkeypatch):
    from pygpa_tpu_torch import data
    real = data.MosaicTiles.read_tiles

    def read(self, origins, tile, normalize=True):
        t = real(self, origins, tile, normalize)
        t[0, 5, 5] += 50.0
        return t
    monkeypatch.setattr(data.MosaicTiles, "read_tiles", read)
    assert run(root, "tblg4096_series.mosaic16k")["correct"] is False


@pytest.mark.parametrize("fault", ["ks", "u", "flat", "cell"])
def test_broken_quickstart_is_not_correct(root, monkeypatch, fault):
    import pygpa_tpu_torch as gt
    if fault == "ks":
        real = gt.gpa.refine_ks
        monkeypatch.setattr(gt.gpa, "refine_ks", lambda *a, **k: real(
            *a, **k) + np.array([1e-5, 0.0]))
    else:
        name = {"u": (gt.gpa, "extract_displacement_field"),
                "flat": (gt.gpa, "undistort_image"),
                "cell": (gt.ucell, "unit_cell_average")}[fault]
        real = getattr(*name)

        # a 3 x 3 block of u or the image; a twentieth of the cell's
        # bins, which its 99th percentile compares
        size = 8 if fault == "cell" else 3

        def altered(*a, **k):
            out = real(*a, **k).clone()
            h, w = out.shape[-2] // 2, out.shape[-1] // 2
            out[..., h:h + size, w:w + size] += 0.05 * float(out.abs().max())
            return out
        monkeypatch.setattr(*name, altered)
    assert run(root, "tblg4096_quickstart.image")["correct"] is False
