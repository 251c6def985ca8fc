"""Every cell, configuration, traffic mix, metric and kernel count that
BENCHMARK.json names is found by name under portbench/."""

import json
from pathlib import Path

import pytest

from portbench import harness
from portbench.trace import MetricInput

ROOT = Path(harness.ROOT)
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    cell = harness.load_cell(w["name"])
    assert cell.workload["config"] == w["config"]
    assert cell.workload["traffic"] == w["traffic"]
    assert cell.chips == w["chips"]
    assert (ROOT / "loops" / f"{cell.traffic['loop']}.py").is_file()
    assert set(cell.limits) >= {"level_db"}
    for m in cell.config["meters"].values():
        assert (ROOT / "reference" / f"{m['kind']}.py").is_file()


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = harness.load_json("configs", c["name"])
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers(m):
    mod = harness.load_module("metrics", m["name"])
    assert mod.UNIT == m["unit"]
    empty = MetricInput("batch", {"meters": {}, "nchan": 2, "fs": 48000},
                        {"batch": 1, "block": 128}, None, {}, None)
    assert mod.read(empty) is None  # nothing to read: no value, never 0
    names = {e["name"] for e in BENCH["end_to_end"]}
    assert m["moves"] in names


def test_every_metric_file_is_listed():
    listed = {m["name"] for m in BENCH["per_layer"]}
    assert {p.stem for p in (ROOT / "metrics").glob("*.py")} == listed


@pytest.mark.parametrize("kernel", ["r128_fused", "spectrum_fused", "truepeak_fused",
                                    "ballistics_env"])
def test_cost_files(kernel):
    assert callable(harness.load_module("costs", kernel).count)
