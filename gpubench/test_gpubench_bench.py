"""BENCHMARK.json and the files it names, held to the benchmark's
contract: names and units of the allowed letters, every cell reporting
set-up, another end-to-end metric and a per-layer one, every metric with
a reader, every cell with its traffic, configuration and limits, and the
configurations equal to their published sizes but for what they list as
reduced."""
from __future__ import annotations

import dataclasses
import json
import re

import pytest

from gpubench import generator, harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"proj|head|expand|d_model|d_ff|top_k")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells, runs = 24, 2 + 14 * 24           # the full check at 24 cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_keys(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower",
                                                                 "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for cell in entry.get("workloads", []):
            assert cell in CELLS
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metrics_move_a_reported_metric(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", CELLS)
    if metric["name"].split(".")[0].endswith("roofline") or \
            "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    assert callable(harness.reader(metric["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in harness.metrics_for(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(BENCH, cell, "per_layer")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files(cell):
    entry, config, traffic, cellfile = harness.resolve(BENCH, cell)
    assert entry["chips"] == 1
    numbers = set(generator.entry(traffic["entry"]).NUMBERS)
    assert cellfile["limits"] and set(cellfile["limits"]) <= numbers
    assert all(v > 0 for v in cellfile["limits"].values())
    assert config["name"] == entry["config"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_is_the_published_one_but_for_reduced(conf):
    from repro_torch.configs.base import ModelConfig
    data = harness.load_json(harness.ROOT / conf["file"])
    assert data["reduced"] == conf["reduced"]
    assert data["source"] == conf["source"]
    assert not any(WIDTH.search(k) for k in conf["reduced"])
    run = dataclasses.asdict(ModelConfig(**data["model"]))
    published = data["published"]
    changed = {k for k, v in published.items() if run[k] != v}
    assert changed == set(conf["reduced"])
