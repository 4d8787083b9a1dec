"""The mask_mt trainer at world 2: two gloo ranks on the CPU, each a process
as torchrun would start it, on test_torch_trainer.py's tiny VOC tree (the
Pascal recipe's flags at a tiny size, batch 2 per rank).

One spawn runs four trainer runs in turn (2 epochs with --save_preds; 1
epoch then --resume to 2; --n_val 2 for a test split), then the eval pass
over the ranks' slices; another spawn builds each rank's first host
batches. Held: only rank 0 writes the log, metrics, checkpoints, model.pt
and predictions; the ranks end bit-identical; --resume continues exactly;
the eval's confusion matrix (with and without hole filling) equals the
world-1 pass's; rank r's host streams are bit-equal to the JAX loader's
with seed + r * 7919. In this process: --data_on_device on is refused at
world 2 (world mocked) as the JAX trainer refuses it, and --eval_spatial at
world 1 equals JAX's ``common.evaluate(..., spatial=True)`` on a one-device
mesh.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from cutmix_seg_tpu.aug.params import GeomConfig as JGeomConfig
from cutmix_seg_tpu.core.train_state import ModelState
from cutmix_seg_tpu.data import datasets as jdatasets
from cutmix_seg_tpu.data import loader as jloader
from cutmix_seg_tpu.data import settings as jsettings
from cutmix_seg_tpu.data import sources as jsources
from cutmix_seg_tpu.models.common import SegModel as JSegModel
from cutmix_seg_tpu.models.deeplab2 import DeepLab2 as JDeepLab2
from cutmix_seg_tpu.models.deeplab2 import _param_label as j_param_label
from cutmix_seg_tpu.parallel.mesh import make_mesh
from cutmix_seg_tpu.train import common as jcommon
from cutmix_seg_tpu_torch.data import datasets, settings, sources
from cutmix_seg_tpu_torch.data.synthetic import write_config, write_voc_tree
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.parallel import mesh
from cutmix_seg_tpu_torch.train import common, engine
from cutmix_seg_tpu_torch.train import mask_mt
from tests import _torch_ranks as ranks
from tests import test_torch_trainer as ttr
from tests.test_torch_eval import MEAN, STD, MemorySource
from tests.test_torch_models import random_variables

torch.set_num_threads(1)

WORLD = 2
RUNS = [  # (desc, overrides) in turn
    ("straight", dict(save_preds=True)),
    ("split", dict(num_epochs=1, save_model=False)),
    ("split", dict(resume=True, save_model=False)),
    ("holdout", dict(n_val=2, num_epochs=1, save_model=False, save_preds=True)),
]


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """test_torch_trainer's ``voc`` tree, for the module: both packages'
    'pascal' sources on its 48x48 canvas."""
    tmp = tmp_path_factory.mktemp("ddp_voc")
    root = write_voc_tree(str(tmp / "VOC2012"), 10, 2, size_range=(36, 48), seed=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUTMIX_SEG_CONFIG", write_config(str(tmp / "seg.cfg"), root))
        for mod in (settings, jsettings):
            mp.setattr(mod, "_config", None)
        for src in (sources.PascalVOCDataSource, jsources.PascalVOCDataSource):
            mp.setattr(src, "canvas_hw", (48, 48))
        yield tmp


@pytest.fixture(scope="module")
def world2(voc_tree):
    """(trainer spawn's per-rank results, streams spawn's, results root)."""
    root = str(voc_tree / "results")
    params = ttr._params(num_epochs=2, iters_per_epoch=2)
    common_task = {"arch": ttr.TINY_ARCH, "params": params, "root": root}
    trainer = ranks.RankProcesses(voc_tree, dict(common_task, kind="trainer", runs=RUNS), WORLD)
    try:
        streams = ranks.run_ranks(voc_tree, dict(common_task, kind="streams"), WORLD)
    except BaseException:
        trainer.kill()
        raise
    yield trainer.wait(), streams, root
    shutil.rmtree(root)  # the runs' checkpoints: 146 MB each


def _run_dir(root, desc):
    return os.path.join(root, "test_torch_ddp", desc)


def state_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(state_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def test_only_rank0_writes_artifacts(world2):
    (r0, r1), _, root = world2
    assert set(r1["writes"].values()) == {0}, r1["writes"]
    w = r0["writes"]
    assert w["export_params"] == 1 and w["save_checkpoint_async"] == 2 + 1 + 1 + 1
    assert w["log_metrics"] == 2 + 1 + 1 + 1 and w["save_prediction_by_index"] == 2 + 4
    log = open(os.path.join(_run_dir(root, "straight"), "log_straight.txt")).read()
    assert log.count("Epoch 1:") == log.count("Epoch 2:") == 1
    assert "batch_size=2" in log and "len(sup_ndx)=4" in log
    recs = [json.loads(ln) for ln in open(os.path.join(_run_dir(root, "straight"),
                                                       "metrics_straight.jsonl"))]
    assert [r["epoch"] for r in recs] == [1, 2]
    # the global batch: 2 iterations of 2 + 2 images per epoch
    assert all(r["images_per_sec"] * r["epoch_time"] == pytest.approx(8.0) for r in recs)
    assert sorted(os.listdir(os.path.join(_run_dir(root, "straight"), "checkpoints"))) == \
        ["ckpt_000000002.pt", "ckpt_000000004.pt"]
    assert len(os.listdir(os.path.join(_run_dir(root, "straight"), "preds"))) == 2


@pytest.mark.parametrize("desc", ["straight", "split", "holdout"])
def test_ranks_end_bit_identical(world2, desc):
    (r0, r1), _, _ = world2
    assert r0["runs"][desc]["step"] > 0
    assert r0["runs"][desc]["digest"] == r1["runs"][desc]["digest"]


def test_resume_is_exact_at_world2(world2):
    """One epoch and --resume to two end where two epochs straight do, bit
    for bit, on both ranks: each rank restored the step rank 0 saved."""
    (r0, r1), _, root = world2
    for r in (r0, r1):
        assert r["runs"]["split"]["start_epoch"] == 1
        assert r["runs"]["split"]["digest"] == r0["runs"]["straight"]["digest"]
    log = open(os.path.join(_run_dir(root, "split"), "log_split.txt")).read()
    assert "at epoch 1" in log and log.count("Epoch 1:") == 1 and "Epoch 2:" in log


def _teacher(world2):
    """The last run's (holdout's) teacher."""
    (r0, _), _, _ = world2
    net = DeepLab2(21, layers=(1, 1, 1, 1))  # the VOC classes
    net.load_state_dict(r0["teacher"])
    return net.eval()


def _pascal():
    return datasets.load_dataset("pascal", 2, 131, 4, -1, 12345, None)


def test_eval_confusion_matrix_matches_world1(world2):
    (r0, r1), _, _ = world2
    ds = _pascal()["ds_src"]
    want = ranks.eval_world(_teacher(world2), ds, None, ds.num_classes, False)
    np.testing.assert_array_equal(r0["iou"], want)
    np.testing.assert_array_equal(r1["iou"], want)
    assert want.max() > 0


def test_fill_holes_eval_matches_world1(world2):
    """Each rank fills the holes of its own slice's predictions (trimmed to
    the batch's real images) before the matrices are summed."""
    (r0, r1), _, _ = world2
    want = ranks.eval_world(ranks.holes_net(), _pascal()["ds_src"], None, 2, True)
    np.testing.assert_array_equal(r0["iou_holes"], want)
    np.testing.assert_array_equal(r1["iou_holes"], want)


def test_final_test_eval_and_preds_at_world2(world2):
    """--n_val 2: the test split is scored on the predictions gathered from
    both ranks, as one process scores it."""
    _, _, root = world2
    run_dir = _run_dir(root, "holdout")
    log = open(os.path.join(run_dir, "log_holdout.txt")).read()
    assert "len(val_ndx)=2" in log and "len(test_ndx)=2" in log
    d = _pascal()
    iou = common.evaluate(_teacher(world2), d["ds_src"], d["test_ndx_tgt"], 2,
                          d["ds_src"].num_classes, np.zeros(3), np.ones(3), (1, 1),
                          torch.device("cpu"))
    assert "FINAL TEST: mIoU={:.3%}".format(iou.mean()) in log
    assert sorted(p.endswith(".png") for p in os.listdir(os.path.join(run_dir, "preds"))) \
        == [True] * 4


@pytest.mark.parametrize("rank", range(WORLD))
def test_host_streams_match_jax_loader(world2, rank):
    """Rank r's first sup and unsup batches of epoch 0: the JAX loader's
    with the multi-host trainer's stream seed, seed + r * 7919."""
    _, streams, _ = world2
    got = streams[rank]
    p = ttr._params()
    j = jdatasets.load_dataset("pascal", -1, 131, 4, -1, 12345, None)
    geom = JGeomConfig.from_cli((32, 32), p["aug_scale_hung"], p["aug_max_scale"],
                                p["aug_rot_mag"], p["aug_scale_non_uniform"], p["aug_hflip"],
                                p["aug_vflip"], p["aug_hvflip"])
    ep = jcommon.epoch_stream_seed(p["seed"] + rank * 7919, 0)
    want = {}
    built = [(jloader.HostBatchBuilder(j["ds_src"], geom, with_labels=True, n_threads=2),
              j["sup_ndx"], ep + 10, "sup")]
    for si in range(2):
        built.append((jloader.HostBatchBuilder(j["ds_src"], geom, with_labels=False,
                                               n_threads=2), j["unsup_ndx"], ep + 20 + si * 10,
                      f"u{si}"))
    for builder, ndx, seed, key in built:
        stream = jloader.train_stream(builder, ndx, p["batch_size"], seed=seed)
        try:
            want[key] = next(stream)
        finally:
            stream.close()
    assert sorted(got) == sorted(want)
    for key, batch in want.items():
        assert sorted(got[key]) == sorted(batch), key
        for k, v in batch.items():
            np.testing.assert_array_equal(got[key][k], v, err_msg=f"{key} {k}")


def test_data_on_device_on_refused_at_world2(voc_tree, monkeypatch):
    """As the JAX trainer: the store is one process's; 'on' raises at
    world 2, after the data loads ('auto' streams)."""
    monkeypatch.setattr(mesh, "world", lambda: 2)
    spec, cfg = mask_mt.build_spec(ttr._params())
    eng = engine.TrainEngine(None, spec, cfg, ttr._params(data_on_device="on"), "cpu")
    with pytest.raises(ValueError, match="single-process only"):
        eng.setup()
    eng = engine.TrainEngine(None, spec, cfg, ttr._params(data_on_device="auto"), "cpu")
    assert eng.setup() and eng.resident is None


def test_n_devices_and_eval_spatial_run_at_world1(voc_tree, tmp_path):
    """With one process, --n_devices 1 and --eval_spatial run the plain
    path: the same epoch record and checkpoint as a run without them."""
    root = tmp_path / "results"
    for desc, kw in (("plain", {}), ("flags", dict(n_devices=1, eval_spatial=True))):
        ttr._submit(root, desc, num_epochs=1, iters_per_epoch=2, save_model=False, **kw)
    run = {d: root / "test_torch_mask_mt" / d for d in ("plain", "flags")}
    recs = {d: json.loads((r / f"metrics_{d}.jsonl").read_text()) for d, r in run.items()}
    for k in ("sup_loss", "cons_loss", "conf_rate", "val_miou"):
        assert recs["flags"][k] == recs["plain"][k], k
    ckpt = {d: torch.load(r / "checkpoints" / "ckpt_000000002.pt", weights_only=True)
            for d, r in run.items()}
    assert state_equal(ckpt["flags"], ckpt["plain"])
    assert "n_devices=1" in (run["flags"] / "log_flags.txt").read_text()
    shutil.rmtree(root)


@pytest.mark.parametrize("fill_holes", [False, True])
def test_eval_spatial_at_world1_matches_jax(fill_holes):
    """--eval_spatial with one process: the port's pass against JAX's
    H-sharded eval on a one-device mesh, with a block size of 8 (the
    batches' H padded to lcm(1, 8))."""
    c = 2 if fill_holes else 4
    hw = (40, 44)
    jmodel = JSegModel(name="tiny", module=JDeepLab2(num_classes=c, layers=(1, 1, 1, 1)),
                       mean=MEAN, std=STD, block_size=(8, 8), param_label=j_param_label)
    variables = random_variables(jmodel.module, hw, 9)
    jstate = ModelState(params=variables["params"], batch_stats=variables["batch_stats"])
    net = DeepLab2(c, layers=(1, 1, 1, 1))
    net.load_state_dict(from_jax_variables(variables))
    src, indices = MemorySource(5, seed=8), np.arange(5)
    want = jcommon.evaluate(jmodel, jstate, src, indices, 2, make_mesh(1), c, MEAN, STD,
                            (8, 8), fill_holes, spatial=True)
    got = common.evaluate(net, src, indices, 2, c, MEAN, STD, (8, 8), torch.device("cpu"),
                          fill_holes, None, spatial=True)
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0
