"""A configuration of a new model family on new data enters the benchmark as
new files and new entries in BENCHMARK.json alone: a throwaway family, its
tiny cut and a data kind (modules put in ``sys.modules``), and its
configuration, traffic and workload files (under ``tmp_path``), go through
the harness's lookups unchanged. A name with no module fails with an error
naming the file to add; no shared file names a family, a data kind, a
configuration or a cell."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from benchmark import datagen, named, recipe, weights
from benchmark.counts import flops
from benchmark.reference import models, pipeline
from benchmark.tests import tiny

FAMILY, KIND, TRAFFIC, CONFIG, CELL = "toyfam", "toykind", "toymix", "toy-config", "toy-cell"
WIDTH, CLASSES, BATCH, CROP = 8, 3, 4, (32, 48)


def _family_module(seen):
    fam = types.ModuleType(FAMILY)

    def leaves(cfg):
        w = cfg["width"]
        return (models.conv_leaf("conv", 3, w, 3, "pretrained") + models.bn_leaves("bn", w, "new")
                + models.conv_leaf("clf", w, cfg["num_classes"], 1, "new", "classifier",
                                   bias=True))

    def forward(cfg, P, B, x, mode):
        seen.append(mode.train_bn)
        y = models.conv(x.permute(0, 3, 1, 2), P, "conv", mode, padding=1)
        y = F.relu(models.batch_norm(y, P, B, "bn", mode))
        return models.conv(y, P, "clf", mode, bias=True).permute(0, 2, 3, 1)

    fam.leaves, fam.forward = leaves, forward
    return fam


def _tiny_module(registered):
    mod = types.ModuleType(FAMILY)
    mod.ARCH, mod.FLAGS = "bench_tiny_toyfam", {"crop_size": "16,16"}
    mod.LIMITS, mod.CARD_LIMITS = {"sup_loss_gap": 0.5}, {"sup_loss_gap_step1": 0.5}
    mod.F32_TOLERANCE = 1e-4
    mod.f32_patches = lambda patcher: None
    mod.register = lambda: registered.append(mod.ARCH)

    def cut(cfg):
        cfg["model"]["width"] = 2
        cfg["data"]["n"] = 3

    mod.cut = cut
    return mod


def _kind_module():
    mod = types.ModuleType(KIND)

    def write(data, root, seed):
        path = os.path.join(root, "toy.npy")
        np.save(path, np.random.RandomState(seed).randint(0, 256, (data["n"], 20, 20)))
        return {"kind": KIND, "path": path, "config_name": "toy"}

    class Reader:
        def __init__(self, path):
            self.images = np.load(path).astype(np.uint8)

        def split(self, n_sup, split_path, split_seed):
            names = [str(i) for i in range(len(self.images))]
            order = np.random.RandomState(split_seed).permutation(len(names))
            return names, order[:n_sup], order

        def image(self, name):
            return self.images[int(name)]

        def labels(self, name):
            return (self.images[int(name)] > 127).astype(np.int64)

    mod.write, mod.Reader = write, Reader
    return mod


@pytest.fixture
def new_family(monkeypatch, tmp_path):
    """The throwaway family's modules in ``sys.modules``, its files under
    ``tmp_path`` and BENCHMARK.json with its entries added."""
    seen, registered = [], []
    for package, mod in (("benchmark.reference.families", _family_module(seen)),
                         ("benchmark.tests.tiny_families", _tiny_module(registered)),
                         ("benchmark.kinds", _kind_module())):
        monkeypatch.setitem(sys.modules, f"{package}.{mod.__name__}", mod)

    def put(rel, data):
        path = tmp_path / "benchmark" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(data))

    config = {"name": CONFIG,
              "flags": ["--dataset=toy", "--arch=toy", f"--batch_size={BATCH}",
                        f"--crop_size={CROP[0]},{CROP[1]}", "--aug_hflip", "--aug_max_scale=1.1",
                        "--aug_strong_colour", "--n_sup=2"],
              "model": {"family": FAMILY, "width": WIDTH, "num_classes": CLASSES},
              "mean": [0.5, 0.5, 0.5], "std": [0.25, 0.25, 0.25], "data": {"kind": KIND, "n": 5},
              "init": {"classifier_gain": 1.0, "residual_gain": 1.0}, "reduced": []}
    put(f"configs/{CONFIG}.json", config)
    put(f"traffic/{TRAFFIC}.json", {"algorithm": "mask_mt", "flags": ["--conf_thresh=0.97"],
                                    "model_passes": [{"batches": 2, "grad": "none"},
                                                     {"batches": 2, "grad": "params"}],
                                    "cutmix_blends": 1})
    put(f"workloads/{CELL}.json", {"data_on_device": "resident", "warmup_iterations": 2,
                                   "trace_seconds": 10, "counts": {},
                                   "limits": {"sup_loss_gap": 0.1}})
    manifest = recipe.manifest()
    manifest["configs"].append({"name": CONFIG, "source": "https://example.org/toy",
                                "file": f"benchmark/configs/{CONFIG}.json", "reduced": [],
                                "why": "a throwaway family"})
    manifest["workloads"].append({"name": CELL, "config": CONFIG, "traffic": TRAFFIC,
                                  "chips": 1, "why": "a throwaway cell"})
    return types.SimpleNamespace(manifest=manifest, root=str(tmp_path), seen=seen,
                                 registered=registered)


def _cell(new_family, *extra_flags):
    cell = recipe.load_cell(CELL, new_family.manifest, new_family.root)
    cell["config"]["flags"] += list(extra_flags)
    return cell


def test_the_cell_loads_with_only_the_metrics_it_is_given(new_family):
    cell = _cell(new_family)
    assert cell["config"]["model"]["family"] == FAMILY
    assert cell["traffic"]["model_passes"] and cell["workload"]["limits"]
    # every per-layer metric lists its cells: a new cell takes none unasked
    assert cell["per_layer"] == []
    assert {m["name"] for m in cell["end_to_end"]} == {
        m["name"] for m in new_family.manifest["end_to_end"] if "workloads" not in m}


def test_leaves_and_forward(new_family):
    leaves = models.leaves_of(_cell(new_family)["config"]["model"])
    assert [lf.name for lf in leaves] == [
        "conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var",
        "clf.weight", "clf.bias"]
    assert leaves[0].shape == (WIDTH, 3, 3, 3)
    W = weights.make(leaves, 2**31 + 17, _cell(new_family)["config"]["init"], "cpu")
    P = {lf.name: W[lf.name] for lf in leaves if lf.group != "buffer"}
    B = {lf.name: W[lf.name] for lf in leaves if lf.group == "buffer"}
    logits = models.forward(_cell(new_family)["config"]["model"], P, B,
                            torch.zeros(2, 8, 8, 3), models.Mode())
    assert logits.shape == (2, 8, 8, CLASSES)


@pytest.mark.parametrize("freeze_bn", [False, True])
def test_hyperparameters_and_counts(new_family, freeze_bn):
    """The FLOP count runs the family's forward with BN as the recipe's
    ``--freeze_bn`` says, and counts its convolutions: the forward, and of
    the backward the weights' gradients and the classifier's input's."""
    cell = _cell(new_family, *(["--freeze_bn"] if freeze_bn else []))
    hp = recipe.hyperparameters(cell)
    assert hp["batch_size"] == BATCH and hp["freeze_bn"] is freeze_bn
    assert recipe.geometry(hp).crop == CROP
    counts = flops.cell_counts(cell)
    assert new_family.seen and set(new_family.seen) == {not freeze_bn}
    n = 2 * BATCH * CROP[0] * CROP[1]
    conv, clf = 2 * n * WIDTH * 3 * 9, 2 * n * CLASSES * WIDTH
    assert counts["model_flops_per_iter"] == counts["conv_flops_per_iter"] == \
        (conv + clf) + (conv + clf) + (conv + 2 * clf)
    assert counts["cutmix_bytes"] > 0


def test_tiny_cell(new_family):
    cell = tiny.tiny_cell(CELL, new_family.manifest, new_family.root)
    fam = tiny.family(cell)
    assert fam.ARCH == "bench_tiny_toyfam"
    assert {"--arch=bench_tiny_toyfam", "--batch_size=2", "--crop_size=16,16"} <= set(
        cell["config"]["flags"])
    assert cell["config"]["model"]["width"] == 2 and cell["config"]["data"]["n"] == 3
    assert cell["workload"]["limits"] == fam.LIMITS
    fam.register()
    assert new_family.registered == [fam.ARCH]


def test_data_kind_writes_and_reads(new_family, tmp_path):
    cell = _cell(new_family)
    w = datagen.write(cell["config"]["data"], str(tmp_path), 2**31 + 17)
    assert w["kind"] == KIND and os.path.exists(w["path"])
    ds = pipeline.Dataset(w["kind"], w["path"], 2)
    assert len(ds.names) == 5 and len(ds.sup) == 2 and len(ds.unsup) == 5
    assert ds.image(0).shape == (20, 20, 3) and ds.labels(0).shape == (20, 20)


@pytest.mark.parametrize("lookup,added", [
    (lambda tmp: models.leaves_of({"family": "no_such_family"}),
     "benchmark/reference/families/no_such_family.py"),
    (lambda tmp: datagen.write({"kind": "no_such_kind"}, tmp, 1),
     "benchmark/kinds/no_such_kind.py"),
    (lambda tmp: pipeline.Dataset("no_such_kind", tmp, 1),
     "benchmark/kinds/no_such_kind.py"),
    (lambda tmp: tiny.family({"config": {"model": {"family": "no_such_family"}}}),
     "benchmark/tests/tiny_families/no_such_family.py"),
], ids=["family", "data_kind", "reader", "tiny_cut"])
def test_unknown_name_names_the_file_to_add(tmp_path, lookup, added):
    with pytest.raises(LookupError, match=added):
        lookup(str(tmp_path))


@pytest.mark.parametrize("name", ["../models", "a/b", "", "x" * 65, None])
def test_a_name_outside_the_pattern_is_refused(name):
    with pytest.raises(ValueError, match="not a benchmark name"):
        named.module_of("benchmark.reference.families", name)


def test_a_module_that_fails_to_import_is_not_taken_for_a_missing_one(monkeypatch):
    """A family module that exists but imports what is not there raises
    that import's error, not one about the family."""
    real = named.importlib.import_module

    def fake(full):
        if full.endswith(".broken"):
            raise ModuleNotFoundError("No module named 'absent_dependency'",
                                      name="absent_dependency")
        return real(full)

    monkeypatch.setattr(named.importlib, "import_module", fake)
    with pytest.raises(ModuleNotFoundError, match="absent_dependency"):
        named.module_of("benchmark.reference.families", "broken")


def _manifest_names():
    """(the families and data kinds of the manifest's configurations, the
    names of its configurations and cells)."""
    m = recipe.manifest()
    configs = [recipe.load_json(os.path.join(recipe.ROOT, c["file"])) for c in m["configs"]]
    per_name = {c["model"]["family"] for c in configs} | {c["data"]["kind"] for c in configs}
    return per_name, {c["name"] for c in m["configs"]} | {w["name"] for w in m["workloads"]}


def _shared_files():
    """Every Python file of the benchmark outside the per-name packages,
    but for a test named after one family or kind."""
    per_name, _ = _manifest_names()
    own = {"families", "kinds", "tiny_families"}
    for root, dirs, files in os.walk(recipe.HERE):
        dirs[:] = sorted(d for d in dirs if d not in own and d != "__pycache__")
        for f in sorted(files):
            stem = f[:-3]
            if f.endswith(".py") and stem.replace("test_bench_", "", 1) not in per_name:
                yield os.path.relpath(os.path.join(root, f), recipe.HERE)


@pytest.mark.parametrize("path", list(_shared_files()))
def test_shared_file_names_no_family_kind_or_cell(path):
    per_name, cells = _manifest_names()
    with open(os.path.join(recipe.HERE, path)) as f:
        text = f.read()
    assert not [n for n in per_name | cells if n in text]
