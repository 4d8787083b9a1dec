"""The reference against the port at tiny widths on the CPU: with the
program in float32 both follow the same three iterations (the reference
worked out from the seed and the raw files alone), and with the program in
its configured bfloat16 a run comes out correct."""

import json
import os

import pytest
import torch

from benchmark import datagen, recipe, run
from benchmark.program import Program
from benchmark.reference import pipeline, steps
from benchmark.tests.tiny import cells, family, tiny_cell

SEED = 2147483901  # over 31 bits, as the benchmark's seeds may be


def _f32(cell):
    cell["config"]["flags"].append("--compute_dtype=float32")
    return cell


@pytest.mark.parametrize("name", cells())
def test_float32_program_follows_the_reference(tiny_archs, monkeypatch, name):
    """With the program in float32, every reading lies under the family's
    ``F32_TOLERANCE`` once its ``f32_patches`` are in place
    (``tiny_families/<family>.py`` says what each covers)."""
    cell = _f32(tiny_cell(name))
    fam = family(cell)
    fam.f32_patches(monkeypatch)
    res = run.run_cell(cell, SEED, 0.5, False, "cpu")
    assert res["correct"]
    for key, r in res["readings"].items():
        assert r["value"] < fam.F32_TOLERANCE, (key, r)


@pytest.mark.parametrize("name", cells())
def test_float32_batches_follow_the_reference(tiny_archs, tmp_path, name):
    """The first batch of the float32 program against the reference's: the
    crops (the scale-crop, or the rotate-scale crop with its reflecting
    border, nearest for labelled images and for half the unlabelled ones),
    the loader or resident store and the colour draws agree to float32
    rounding, but for nearest taps whose source coordinate lies within
    1.2e-4 px below a half pixel: the program biases ties up by 4 ulps at
    the canvas size."""
    cell = _f32(tiny_cell(name))
    hp, tmp = recipe.hyperparameters(cell), str(tmp_path)
    w = datagen.write(cell["config"]["data"], tmp, SEED)
    prog = Program(cell, SEED, datagen.write_paths_config(os.path.join(tmp, "p.cfg"), w),
                   os.path.join(tmp, "run"), "cpu")
    assert prog.resident == (cell["workload"]["data_on_device"] == "resident")
    prog.open_streams()
    got = prog.engine.make_batch(prog.engine.make_raw_batch())
    prog.close()
    ds = pipeline.Dataset(w["kind"], w["path"], hp["n_sup"], hp["split_path"], hp["split_seed"])
    gen = torch.Generator().manual_seed((SEED + 40) * 100003 + 1)
    ref = next(steps.make_batches(ds, recipe.geometry(hp), hp, SEED, "cpu", gen))
    assert (got["sup_y"] != ref["sup_y"]).float().mean() < 2e-3
    for k in ("sup_x", "ux0_tea", "ux0_stu", "um0", "ux1_tea", "ux1_stu", "um1"):
        differ = ((got[k].float() - ref[k]).abs() > 1e-4).float().mean()
        assert differ < 2e-3, (k, float(differ))


@pytest.mark.parametrize("name", cells())
def test_bf16_run_is_correct(tiny_archs, name):
    res = run.run_cell(tiny_cell(name), SEED, 0.5, False, "cpu")
    assert res["correct"], json.dumps(res["checks"])
    assert res["attempted"] >= 1 and res["failed"] == 0
    cell = recipe.load_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert res["window"]["img_per_s"] > 0
    assert list(res)[-2:] == ["checks", "loaded_forbidden"]


@pytest.mark.parametrize("name", cells())
def test_traced_run_reports_per_layer_metrics(tiny_archs, name):
    cell = tiny_cell(name)
    res = run.run_cell(cell, SEED, 0.5, True, "cpu")
    assert res["correct"]
    # on the CPU there are no device events or memory: the readers of
    # device metrics find nothing and the host's readings are read
    host_read = {m["name"] for m in cell["per_layer"]
                 if m["source"] in ("program_span", "host_clock")}
    assert host_read and host_read <= set(res["metrics"])
    assert set(res["metrics"]) <= {m["name"] for m in cell["per_layer"]}
