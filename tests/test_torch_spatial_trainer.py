"""The mask_mt trainer with ``--spatial_train 2`` and ``--eval_spatial`` at
world 2 (two gloo rank processes on the CPU, each a process as torchrun
would start it), on a synthetic Cityscapes zip through the converter: the
Cityscapes CutMix line (run_cityscapes_experiments.sh: batch 4, a crop of
half the canvas) at a tiny size, with the tiny DeepLab v2 (crops of 16 rows:
8 per rank, feature maps of 8, 5 and 3 rows).

One spawn runs four trainer runs in turn (2 epochs with --save_preds; 1
epoch then --resume to 2; --n_val 2 for a test split), then the eval pass
over the ranks (plain, and --eval_spatial, each with and without hole
filling). Held: at N = S = 2 the run is the world-1 run of the same seed
split by rows (one data index: the same host streams, draws and global
batch), so its epoch losses are within 1e-5 relative and its parameters
within Adam's 2 * lr * steps of a world-1 run in this process; the ranks
end bit-identical; --resume continues exactly; only rank 0 writes; the eval
passes' IoU, spatial or not, with hole filling too, equal the world-1
pass's; the final test eval scores the predictions gathered by rows and
ranks as one process does.

A second spawn runs the recipe's other lines the same way, 1 epoch each
with --spatial_train 2 --eval_spatial: ICT and aug_mt on the tiny DeepLab
v2 (aug_mt's warp gathers the teacher's rows), and CutMix on a tiny DeepLab
v3+ (its dropout masks drawn for the full maps from the state's generator,
as at world 1); each is held to a world-1 run of the same seed in this
process as above, and its ranks end bit-identical.
"""

import importlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from cutmix_seg_tpu_torch.data import datasets, settings, sources, synthetic
from cutmix_seg_tpu_torch.models import registry
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2
from cutmix_seg_tpu_torch.tools import convert_cityscapes
from cutmix_seg_tpu_torch.train import common
from tests import _torch_ranks as ranks
from tests import test_torch_trainer as ttr

torch.set_num_threads(1)

WORLD = 2
CANVAS = (32, 64)
N_IMAGES = 8  # 5 train + 3 val frames
RUNS = [  # (desc, overrides) in turn
    ("straight", dict(save_preds=True)),
    ("split", dict(num_epochs=1, save_model=False)),
    ("split", dict(resume=True, save_model=False)),
    ("holdout", dict(n_val=2, num_epochs=1, save_model=False, save_preds=True)),
]


def _params(**overrides):
    return ttr._params(dataset="cityscapes", n_sup=2, batch_size=4, crop_size="16,32",
                       aug_scale_hung=False, num_epochs=2, iters_per_epoch=2,
                       data_on_device="off", **overrides)


TINY_V3PLUS = "tiny_deeplabv3plus_spatial_test"
registry.register(TINY_V3PLUS)(ranks.tiny_v3plus)
LINES = {  # desc: (trainer, overrides): the recipe's lines, 1 epoch each
    "ict": ("ict", dict(ict_alpha=0.1)),
    "aug_mt": ("aug_mt", {}),
    "v3plus_cutmix": ("mask_mt", dict(arch=TINY_V3PLUS)),
}


def _line_params(trainer, **overrides):
    """``trainer``'s CLI defaults, with the spatial line's flags that its
    CLI has, for 1 epoch."""
    p = dict(importlib.import_module(f"cutmix_seg_tpu_torch.train.{trainer}")
             .experiment.make_context("experiment", []).params)
    del p["job_desc"]
    p.update({k: v for k, v in _params(save_model=False).items() if k in p})
    p.update(num_epochs=1, device="cpu", **overrides)
    return p


@pytest.fixture(scope="module")
def city(tmp_path_factory):
    """A converted synthetic Cityscapes zip named by a temporary cfg, the
    source's canvas fitting it."""
    d = tmp_path_factory.mktemp("spatial_city")
    x_zip, y_zip = synthetic.write_cityscapes_zips(str(d), 5, 3, size=(64, 128), seed=1)
    zip_path = str(d / "cityscapes.zip")
    convert_cityscapes.convert_cityscapes(x_zip, y_zip, zip_path, 2, progress=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUTMIX_SEG_CONFIG", synthetic.write_config(str(d / "seg.cfg"),
                                                              cityscapes_zip=zip_path))
        mp.setattr(settings, "_config", None)
        mp.setattr(sources.CityscapesDataSource, "canvas_hw", CANVAS)
        yield d


@pytest.fixture(scope="module")
def runs(city):
    """(each rank's results, the world-1 run's engine, results root)."""
    root = str(city / "results")
    task = {"kind": "trainer", "n_model": 2, "arch": ttr.TINY_ARCH, "root": root,
            "params": _params(spatial_train=2, eval_spatial=True), "runs": RUNS,
            "eval_spatial": True, "eval_n": N_IMAGES, "city_canvas": CANVAS,
            "keep_student": ("straight",)}
    spawn = ranks.RankProcesses(city, task, WORLD, timeout=300)
    try:
        world1 = ttr.job.submit("test_torch_world1", "straight", ttr.mask_mt.train_seg_semisup_mask_mt,
                                _params(save_model=False), results_root=str(city / "world1"))
    except BaseException:
        spawn.kill()
        raise
    yield spawn.wait(), world1, root
    # the runs' checkpoints: ~130 MB each
    shutil.rmtree(root)
    shutil.rmtree(city / "world1")


@pytest.fixture(scope="module")
def line_runs(city):
    """(each rank's results, {desc: the world-1 run's engine}) of LINES."""
    root = str(city / "results_lines")
    trainers = sorted({t for t, _ in LINES.values() if t != "mask_mt"})
    task = {"kind": "trainer", "n_model": 2, "arch": ttr.TINY_ARCH, "arch_v3plus": TINY_V3PLUS,
            "root": root, "params": _line_params("mask_mt", spatial_train=2, eval_spatial=True),
            "params_of": {t: _line_params(t, spatial_train=2, eval_spatial=True)
                          for t in trainers},
            "runs": [(d, dict(kw, trainer=t)) for d, (t, kw) in LINES.items()],
            "city_canvas": CANVAS, "keep_student": tuple(LINES), "eval": False}
    spawn = ranks.RankProcesses(city, task, WORLD, timeout=300)
    try:
        world1 = {d: ttr.job.submit("test_torch_world1", d, ranks.trainer_fn(t),
                                    _line_params(t, **kw), results_root=str(city / "world1_lines"))
                  for d, (t, kw) in LINES.items()}
    except BaseException:
        spawn.kill()
        raise
    yield spawn.wait(), world1, root
    shutil.rmtree(root)
    shutil.rmtree(city / "world1_lines")


@pytest.mark.parametrize("desc", sorted(LINES))
def test_line_matches_world1_of_the_same_seed(line_runs, desc):
    (r0, r1), world1, root = line_runs
    assert r0["runs"][desc]["digest"] == r1["runs"][desc]["digest"]
    got = _records(os.path.join(_run_dir(root, desc), f"metrics_{desc}.jsonl"))
    want = _records(os.path.join(world1[desc].ctx.run_dir, f"metrics_{desc}.jsonl"))
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1]
    for g, w in zip(got, want):
        for k in ("sup_loss", "cons_loss", "conf_rate"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7, err_msg=k)
        assert g["val_miou"] == w["val_miou"]
    eng = world1[desc]
    bound = 2 * eng.p["learning_rate"] * eng.state.step + 1e-6  # Adam's 2 * lr * steps
    for k, w in eng.state.student.state_dict().items():
        d = (r0["runs"][desc]["student"][k] - w).abs().max().item()
        assert d <= bound, (k, d)


def _run_dir(root, desc):
    return os.path.join(root, "test_torch_ddp", desc)


def _records(path):
    return [json.loads(ln) for ln in open(path)]


def test_matches_world1_of_the_same_seed(runs, city):
    (r0, _), world1, root = runs
    got = _records(os.path.join(_run_dir(root, "straight"), "metrics_straight.jsonl"))
    want = _records(str(city / "world1" / "test_torch_world1" / "straight"
                        / "metrics_straight.jsonl"))
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        for k in ("sup_loss", "cons_loss", "conf_rate"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7, err_msg=k)
    bound = 2 * 3e-5 * world1.state.step + 1e-6  # Adam's 2 * lr * steps
    for k, w in world1.state.student.state_dict().items():
        d = (r0["runs"]["straight"]["student"][k] - w).abs().max().item()
        assert d <= bound, (k, d)


def test_only_rank0_writes_artifacts(runs):
    (r0, r1), _, root = runs
    assert set(r1["writes"].values()) == {0}, r1["writes"]
    w = r0["writes"]
    assert w["export_params"] == 1 and w["save_checkpoint_async"] == 2 + 1 + 1 + 1
    assert w["log_metrics"] == 2 + 1 + 1 + 1
    log = open(os.path.join(_run_dir(root, "straight"), "log_straight.txt")).read()
    assert log.count("Epoch 1:") == log.count("Epoch 2:") == 1
    assert "spatial_train=2" in log
    # the global batch is one data index's 4 images
    recs = _records(os.path.join(_run_dir(root, "straight"), "metrics_straight.jsonl"))
    assert all(r["images_per_sec"] * r["epoch_time"] == pytest.approx(8.0) for r in recs)


@pytest.mark.parametrize("desc", ["straight", "split", "holdout"])
def test_ranks_end_bit_identical(runs, desc):
    (r0, r1), _, _ = runs
    assert r0["runs"][desc]["step"] > 0
    assert r0["runs"][desc]["digest"] == r1["runs"][desc]["digest"]


def test_resume_is_exact(runs):
    (r0, r1), _, root = runs
    for r in (r0, r1):
        assert r["runs"]["split"]["start_epoch"] == 1
        assert r["runs"]["split"]["digest"] == r0["runs"]["straight"]["digest"]
    log = open(os.path.join(_run_dir(root, "split"), "log_split.txt")).read()
    assert "at epoch 1" in log and log.count("Epoch 1:") == 1 and "Epoch 2:" in log


def _city():
    return datasets.load_dataset("cityscapes", 2, 131, 2, -1, 12345, None)


def _teacher(r0):
    net = DeepLab2(19, layers=(1, 1, 1, 1))
    net.load_state_dict(r0["teacher"])
    return net.eval()


@pytest.mark.parametrize("key", ["iou", "iou_spatial"])
def test_eval_matches_world1(runs, key):
    (r0, r1), _, _ = runs
    ds = _city()["ds_src"]
    want = ranks.eval_world(_teacher(r0), ds, None, ds.num_classes, False, n=N_IMAGES)
    np.testing.assert_array_equal(r0[key], want)
    np.testing.assert_array_equal(r1[key], want)
    assert want.max() > 0


@pytest.mark.parametrize("key", ["iou_holes", "iou_holes_spatial"])
def test_fill_holes_eval_matches_world1(runs, key):
    (r0, r1), _, _ = runs
    want = ranks.eval_world(ranks.holes_net(), _city()["ds_src"], None, 2, True, n=N_IMAGES)
    np.testing.assert_array_equal(r0[key], want)
    np.testing.assert_array_equal(r1[key], want)


def test_final_test_eval_and_preds(runs):
    """--n_val 2 with --eval_spatial: the test split is scored on the
    predictions gathered by rows from both ranks, as one process scores
    it."""
    (r0, _), _, root = runs
    run_dir = _run_dir(root, "holdout")
    log = open(os.path.join(run_dir, "log_holdout.txt")).read()
    assert "len(val_ndx)=2" in log and "len(test_ndx)=" in log
    d = _city()
    iou = common.evaluate(_teacher(r0), d["ds_src"], d["test_ndx_tgt"], 4,
                          d["ds_src"].num_classes, np.zeros(3), np.ones(3), (1, 1),
                          torch.device("cpu"))
    assert "FINAL TEST: mIoU={:.3%}".format(iou.mean()) in log
    assert len(os.listdir(os.path.join(run_dir, "preds"))) == 2
