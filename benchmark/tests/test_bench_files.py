"""BENCHMARK.json and every configuration, traffic and workload file parse
and fit together; the stored counts are what the counters count."""

import json
import os

import pytest

from benchmark import check, recipe
from benchmark.counts import flops
from benchmark.named import NAME
from benchmark.reference import models

MANIFEST = recipe.manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MANIFEST[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in MANIFEST["end_to_end"] + MANIFEST["per_layer"]}) == \
        len(MANIFEST["end_to_end"]) + len(MANIFEST["per_layer"])
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        reader = m["name"].replace(".", "_").replace("-", "_") + ".py"
        assert os.path.exists(os.path.join(recipe.HERE, "metrics", reader))


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports_what_its_metrics_move(name):
    """Every cell reports setup_s, another end-to-end metric and a per-layer
    metric; a metric that lists its cells moves what each of them reports."""
    cell = recipe.load_cell(name)
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and cell["per_layer"]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", [])) <= set(CELLS)
    for m in MANIFEST["per_layer"]:
        if name in m.get("workloads", []):
            assert m["moves"] in reported


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_per_layer_metric_lists_its_cells(metric):
    """Every per-layer metric lists the cells it is read in, so that a cell
    a later configuration adds takes no metric it was not given; each
    listed cell reports the end-to-end metric the metric moves."""
    m = next(x for x in MANIFEST["per_layer"] if x["name"] == metric)
    assert m.get("workloads")
    for name in m["workloads"]:
        assert name in CELLS
        assert m["moves"] in {x["name"] for x in recipe.load_cell(name)["end_to_end"]}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_parse(name):
    cell = recipe.load_cell(name)
    hp = recipe.hyperparameters(cell)
    geom = recipe.geometry(hp)
    assert geom.crop == tuple(int(x) for x in hp["crop_size"].split(","))
    assert cell["workload"]["data_on_device"] in ("resident", "streamed")
    assert cell["workload"]["limits"] and set(cell["workload"]["limits"]) <= set(check.NUMBERS)
    leaves = models.leaves_of(cell["config"]["model"])
    n_params = sum(int(__import__("math").prod(lf.shape)) for lf in leaves
                   if lf.group != "buffer")
    assert n_params == cell["config"]["model"]["parameters"]
    assert cell["config"]["reduced"] == next(
        c["reduced"] for c in MANIFEST["configs"] if c["name"] == cell["entry"]["config"])
    for key in cell["config"]["reduced"]:
        assert cell["config"][key] != cell["config"]["published"][key]


@pytest.mark.parametrize("name", CELLS)
def test_counts_are_the_counters(name):
    cell = recipe.load_cell(name)
    assert flops.cell_counts(cell) == cell["workload"]["counts"]


def test_every_traffic_and_config_is_used():
    used_t = {w["traffic"] for w in MANIFEST["workloads"]}
    used_c = {w["config"] for w in MANIFEST["workloads"]}
    assert used_c == {c["name"] for c in MANIFEST["configs"]}
    for t in used_t:
        with open(os.path.join(recipe.HERE, "traffic", f"{t}.json")) as f:
            assert json.load(f)["algorithm"] == "mask_mt"
