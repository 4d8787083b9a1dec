"""The port's ICT, VAT and aug_mt trainers (train/{ict,vat_mt,aug_mt}.py on
train/engine.py) on the CPU: their click commands against the JAX commands,
an end-to-end run of each on the tiny synthetic VOC tree of
test_torch_trainer.py (2 epochs x 3 iterations of a tiny DeepLab v2 with the
Pascal recipe's lines), --resume as a bit-exact continuation, the aug_mt
host batch against the JAX engine's, and the refusal of every option the
port does not run yet."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from cutmix_seg_tpu.aug.params import GeomConfig as JGeomConfig
from cutmix_seg_tpu.data import datasets as jdatasets
from cutmix_seg_tpu.data import loader as jloader
from cutmix_seg_tpu.data import settings as jsettings
from cutmix_seg_tpu.data import sources as jsources
from cutmix_seg_tpu.train import aug_mt as jaug_mt
from cutmix_seg_tpu.train import engine as jengine
from cutmix_seg_tpu.train import ict as jict
from cutmix_seg_tpu.train import vat_mt as jvat_mt
from cutmix_seg_tpu_torch.aug.params import GeomConfig
from cutmix_seg_tpu_torch.core import job
from cutmix_seg_tpu_torch.data import datasets, loader
from cutmix_seg_tpu_torch.train import aug_mt, engine, ict, vat_mt
from tests.test_cli_parity import _AUG_MT, _ICT, _VAT_MT
from tests.test_torch_trainer import REFUSED, TINY_ARCH, _options, voc  # noqa: F401

torch.set_num_threads(1)

# name: (port module, JAX module, trainer function name, reference flags,
#        the recipe's lines at a tiny size: run_pascal_aug_experiments.sh:22-24)
TRAINERS = {
    "ict": (ict, jict, "train_seg_semisup_ict", _ICT,
            dict(cons_weight=1.0, ict_alpha=0.1, conf_thresh=0.0)),
    "vat_mt": (vat_mt, jvat_mt, "train_seg_semisup_vat_mt", _VAT_MT,
               dict(adaptive_vat_radius=True, vat_radius=1.0, cons_weight=0.1,
                    conf_thresh=0.0)),
    "aug_mt": (aug_mt, jaug_mt, "train_seg_semisup_aug_mt", _AUG_MT,
               dict(cons_weight=1.0, conf_thresh=0.0)),
}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_cli_has_the_jax_options_and_defaults(name):
    port, jax_mod, _, ref_flags, _ = TRAINERS[name]
    assert _options(port.experiment) == _options(jax_mod.experiment)
    assert set(ref_flags) <= {p.name for p in port.experiment.params}


def _params(name, **overrides):
    """The Pascal recipe's flags for ``name`` at a tiny size, every other
    option at the CLI's default. The gate is off (conf_thresh 0), so the
    consistency loss of the random net counts."""
    port, _, _, _, reg = TRAINERS[name]
    p = dict(port.experiment.make_context("experiment", []).params)
    del p["job_desc"]
    p.update(dataset="pascal", arch=TINY_ARCH, freeze_bn=True, batch_size=2,
             learning_rate=3e-5, crop_size="32,32", aug_hflip=True, aug_scale_hung=True,
             aug_strong_colour=True, n_sup=4, num_epochs=2, iters_per_epoch=3,
             num_workers=2, no_pretrained=True, save_model=True,
             compute_dtype="float32", nan_check_interval=1, device="cpu", **reg)
    p.update(overrides)
    return p


def _submit(name, root, desc, **overrides):
    port, _, fn_name, _, _ = TRAINERS[name]
    return job.submit(f"test_torch_{name}", desc, getattr(port, fn_name),
                      _params(name, **overrides), results_root=str(root))


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_end_to_end(name, voc, tmp_path):
    eng = _submit(name, tmp_path / "results", "run1")
    run_dir = tmp_path / "results" / f"test_torch_{name}" / "run1"
    log = (run_dir / "log_run1.txt").read_text()
    assert "Epoch 1:" in log and "Epoch 2:" in log and "VAL mIoU=" in log
    records = [json.loads(ln) for ln in (run_dir / "metrics_run1.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2]
    assert all(np.isfinite(r["sup_loss"]) and np.isfinite(r["cons_loss"])
               and r["cons_loss"] > 0 for r in records)
    assert sorted(os.listdir(run_dir / "checkpoints")) == ["ckpt_000000003.pt",
                                                           "ckpt_000000006.pt"]
    assert eng.state.step == 6 and eng.spec.pair_geom == (name == "aug_mt")
    model = torch.load(run_dir / "model.pt", weights_only=True)
    assert all(torch.equal(model[k], v) for k, v in eng.eval_net().state_dict().items())


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_resume_is_bit_exact_continuation(name, voc, tmp_path):
    """Two epochs straight and one epoch + --resume to two end in the same
    checkpoint, bit for bit: ICT's lambda and VAT's noise come from the
    state's generator, which the checkpoint carries."""
    root = tmp_path / "results"
    _submit(name, root, "straight", save_model=False)
    _submit(name, root, "split", num_epochs=1, save_model=False)
    _submit(name, root, "split", resume=True, save_model=False)
    base = root / f"test_torch_{name}"
    log = (base / "split" / "log_split.txt").read_text()
    assert "at epoch 1" in log and log.count("Epoch 1:") == 1 and "Epoch 2:" in log
    a = torch.load(base / "straight" / "checkpoints" / "ckpt_000000006.pt", weights_only=True)
    b = torch.load(base / "split" / "checkpoints" / "ckpt_000000006.pt", weights_only=True)
    assert a["step"] == b["step"] == 6
    assert torch.equal(a["generator"], b["generator"])
    for part in ("student", "teacher"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for ga, gb in zip(a["optimizer"]["groups"], b["optimizer"]["groups"]):
        for k in ga:
            assert all(torch.equal(x, y) for x, y in zip(ga[k], gb[k])), k


@pytest.fixture
def both_sources(voc, monkeypatch):  # noqa: F811
    """The 'pascal' dataset through each package's load_dataset on a 48x48
    canvas (the port's canvas is set by the ``voc`` fixture)."""
    monkeypatch.setattr(jsettings, "_config", None)
    monkeypatch.setattr(jsources.PascalVOCDataSource, "canvas_hw", (48, 48))
    args = ("pascal", -1, 131, 4, -1, 12345, None)
    return jdatasets.load_dataset(*args), datasets.load_dataset(*args)


@pytest.mark.parametrize("mode, free", [("crop_scale_hung", False), ("crop_rotate_scale", True)])
def test_aug_pair_host_batch_bit_equal_to_jax(both_sources, mode, free):
    """The pair-geometry batch (canvases, m0/m1, interp0/1) and the relative
    transform xf_grid, from the port's fetch_aug_pair and the JAX engine's,
    for the geometry the engines build from the aug_mt flags."""
    j, t = both_sources
    flags = dict(crop_size=(32, 32), aug_scale_hung=mode == "crop_scale_hung",
                 aug_max_scale=1.3 if free else 1.0, aug_rot_mag=15.0 if free else 0.0,
                 aug_scale_non_uniform=False, aug_hflip=True, aug_vflip=False,
                 aug_hvflip=False)
    # as the engines replace it for --aug_offset_range 16 (--aug_free_scale_rot)
    geoms = [dataclasses.replace(cls.from_cli(**flags), crop_offset=(16.0, 16.0),
                                 constrain_rot_scale=not free)
             for cls in (GeomConfig, JGeomConfig)]
    assert geoms[0].mode == mode
    tb = loader.HostBatchBuilder(t["ds_src"], geoms[0], with_labels=False, pair_geom=True,
                                 n_threads=2)
    jb = jloader.HostBatchBuilder(j["ds_src"], geoms[1], with_labels=False, pair_geom=True,
                                  n_threads=2)
    ts = loader.train_stream(tb, t["unsup_ndx"], 3, seed=20)
    js = jloader.train_stream(jb, j["unsup_ndx"], 3, seed=20)
    fake = types.SimpleNamespace(crop_hw=(32, 32))
    try:
        for _ in range(4):
            got = engine.fetch_aug_pair(fake, [ts])["pair"]
            want = jengine.fetch_aug_pair(fake, [js])
            assert sorted(got) == sorted(list(want["pair"]) + ["xf_grid"])
            for k, v in dict(want["pair"], xf_grid=want["xf_grid"]).items():
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    finally:
        ts.close()
        js.close()


@pytest.mark.parametrize("case", sorted(REFUSED))
@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_left_out_options_raise_before_data_loads(name, case, tmp_path, monkeypatch):
    def no_data(*a, **k):
        raise AssertionError("data loaded before the option was refused")

    monkeypatch.setattr(engine.datasets, "load_dataset", no_data)
    overrides, exc, match = REFUSED[case]
    with pytest.raises(exc, match=match):
        _submit(name, tmp_path / "results", case, **overrides)


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_runs_on_cuda_unless_asked(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine.datasets, "load_dataset", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _submit(name, tmp_path / "results", "gpu", device=None)
