"""The ISIC-2017 recipe (run_isic2017_experiments.sh: DenseUNet, training BN,
dropout, SGD 0.1 poly with weight decay 5e-4, rotation/flip augmentation,
fill-holes eval) and the Pascal DeepLab v3+ recipe
(run_pascal_aug_deeplab3plus_experiments.sh) through the port's trainers on
the CPU: every line's flags parse and pass the trainer's setup checks, and
each ISIC line runs end to end on a synthetic ISIC zip
(``data.synthetic.write_isic_zip``) with a tiny DenseUNet (block config
(1, 1, 1, 1)) at 32x32 crops; the CutMix line resumes bit for bit,
running statistics and generator included."""

import json
import os
import shlex

import numpy as np
import pytest
import torch

from cutmix_seg_tpu_torch.core import checkpoint, job
from cutmix_seg_tpu_torch.data import settings, sources
from cutmix_seg_tpu_torch.data.synthetic import write_config, write_isic_zip
from cutmix_seg_tpu_torch.models import registry
from cutmix_seg_tpu_torch.models.common import SegModel
from cutmix_seg_tpu_torch.models.denseunet import DenseUNet, _param_label_pretrained
from cutmix_seg_tpu_torch.train import aug_mt, engine, ict, mask_mt, vat_mt
from tests._torch_tmp import drop_tmp_path_if_passed  # noqa: F401

torch.set_num_threads(1)

TINY_DENSEUNET = "tiny_denseunet_torch_test"


@registry.register(TINY_DENSEUNET)
def _tiny(num_classes, dtype=None, pretrained=True):
    return SegModel(TINY_DENSEUNET, DenseUNet(num_classes, block_config=(1, 1, 1, 1),
                                              dtype=dtype),
                    None, None, (32, 32), _param_label_pretrained)


TRAINERS = {"mask_mt": (mask_mt, "train_seg_semisup_mask_mt"),
            "aug_mt": (aug_mt, "train_seg_semisup_aug_mt"),
            "ict": (ict, "train_seg_semisup_ict"),
            "vat_mt": (vat_mt, "train_seg_semisup_vat_mt")}

# run_isic2017_experiments.sh, its seven lines (trainer, flags)
ISIC = ("--dataset=isic2017 --arch=densenet161unet_imagenet --batch_size=10 "
        "--iters_per_epoch=400 --num_epochs=100 --opt_type=sgd --learning_rate=0.1 "
        "--sgd_weight_decay=5e-4 --lr_sched=poly --bin_fill_holes --crop_size=224,224 "
        "--aug_hflip --aug_vflip --aug_hvflip --aug_max_scale=1.1 --aug_rot_mag=45.0 "
        "--aug_strong_colour")
ISIC_LINES = {
    "sup_50": ("aug_mt", "--n_sup=50 --cons_weight=0.0"),
    "sup_all": ("aug_mt", "--n_sup=-1 --cons_weight=0.0"),
    "cutmix": ("mask_mt", "--n_sup=50 --cons_weight=1.0 --mask_mode=mix "
                          "--mask_prop_range=0.5 --conf_thresh=0.97"),
    "cutout": ("mask_mt", "--n_sup=50 --cons_weight=1.0 --mask_mode=zero "
                          "--mask_prop_range=0.0:1.0 --conf_thresh=0.97"),
    "aug": ("aug_mt", "--n_sup=50 --cons_weight=0.1 --conf_thresh=0.97"),
    "ict": ("ict", "--n_sup=50 --cons_weight=0.0003 --ict_alpha=0.1 --conf_thresh=0.97"),
    "vat": ("vat_mt", "--n_sup=50 --adaptive_vat_radius --vat_radius=1.0 "
                      "--cons_weight=0.001 --conf_thresh=0.97"),
}
# run_pascal_aug_deeplab3plus_experiments.sh, its two lines
V3PLUS = ("--dataset=pascal_aug --arch=resnet101_deeplabv3plus_imagenet --freeze_bn "
          "--batch_size=10 --learning_rate=1e-5 --iters_per_epoch=1000 --num_epochs=40 "
          "--split_path=./data/splits/pascal_aug/split_0.pkl --crop_size=321,321 "
          "--aug_hflip --aug_scale_hung --aug_strong_colour --n_sup=100")
V3PLUS_LINES = {"v3plus_sup": ("mask_mt", "--cons_weight=0.0"),
                "v3plus_cutmix": ("mask_mt", "--cons_weight=1.0 --mask_mode=mix "
                                             "--mask_prop_range=0.5 --conf_thresh=0.97")}
LINES = {**{k: (t, ISIC + " " + f) for k, (t, f) in ISIC_LINES.items()},
         **{k: (t, V3PLUS + " " + f) for k, (t, f) in V3PLUS_LINES.items()}}


def _parse(trainer, flags):
    module = TRAINERS[trainer][0]
    p = dict(module.experiment.make_context("experiment", shlex.split(flags)).params)
    del p["job_desc"]
    return p


@pytest.mark.parametrize("line", sorted(LINES))
def test_recipe_line_parses_and_passes_setup_checks(line):
    trainer, flags = LINES[line]
    p = _parse(trainer, flags)
    TRAINERS[trainer][0].build_spec(p)
    engine.check_ported(p)  # raises for what the port refuses
    assert p["freeze_bn"] == line.startswith("v3plus")


@pytest.fixture
def isic(tmp_path, monkeypatch):
    """A synthetic ISIC zip (8 train + 2 val images, 40x40) named by a
    temporary cfg, on a 48x48 canvas."""
    path = write_isic_zip(str(tmp_path / "isic2017.zip"), 8, 2, size=40, seed=3)
    monkeypatch.setenv("CUTMIX_SEG_CONFIG", write_config(str(tmp_path / "seg.cfg"),
                                                         isic_zip=path))
    monkeypatch.setattr(settings, "_config", None)
    monkeypatch.setattr(sources.ISIC2017DataSource, "canvas_hw", (48, 48))
    return path


def _submit(line, root, desc, **overrides):
    trainer, flags = LINES[line]
    p = _parse(trainer, flags)
    p.update(arch=TINY_DENSEUNET, batch_size=2, crop_size="32,32", iters_per_epoch=2,
             num_epochs=1, num_workers=1, no_pretrained=True, compute_dtype="float32",
             conf_thresh=0.0, nan_check_interval=1, device="cpu")
    if p["n_sup"] != -1:
        p["n_sup"] = 4
    p.update(overrides)
    module, fn_name = TRAINERS[trainer]
    return job.submit(f"isic_{line}", desc, getattr(module, fn_name), p,
                      results_root=str(root))


@pytest.mark.parametrize("line", sorted(ISIC_LINES))
def test_isic_line_runs(line, isic, tmp_path):
    """One epoch of each line: an epoch line with finite losses and a VAL
    mIoU from the fill-holes evaluation, a checkpoint, and running
    statistics that moved in student and teacher (training BN)."""
    eng = _submit(line, tmp_path / "results", "run")
    run_dir = tmp_path / "results" / f"isic_{line}" / "run"
    log = (run_dir / "log_run.txt").read_text()
    assert "Epoch 1:" in log and "VAL mIoU=" in log and "freeze_bn=False" in log
    rec = json.loads((run_dir / "metrics_run.jsonl").read_text().splitlines()[0])
    assert np.isfinite(rec["sup_loss"]) and np.isfinite(rec["cons_loss"])
    # the training-BN kernels' counter: no launch without a card
    assert rec["bn_launches"] == 0 and "bn_plain_cuda_calls" not in rec
    assert os.listdir(run_dir / "checkpoints") == ["ckpt_000000002.pt"]
    assert eng.p["bin_fill_holes"] and eng.n_classes == 2 and eng.state.step == 2
    assert eng.p["opt_type"] == "sgd" and eng.p["lr_sched"] == "poly"
    fresh = registry.get(TINY_DENSEUNET)(2).module.state_dict()
    for net in (eng.state.student, eng.state.teacher):
        moved = [k for k, v in net.state_dict().items()
                 if "running" in k and not torch.equal(v, fresh[k])]
        assert len(moved) == len([k for k in fresh if "running" in k])


def test_isic_cutmix_resume_is_bit_exact(isic, tmp_path):
    """Two epochs straight, and the same run resumed from its epoch-1
    checkpoint (the poly schedule depends on the run's length, so both runs
    are two epochs long), end in the same checkpoint, bit for bit:
    parameters, BN running statistics, SGD traces and the generator that
    draws the boxes and the dropout masks."""
    root = tmp_path / "results"
    _submit("cutmix", root, "straight", num_epochs=2)
    _submit("cutmix", root, "split", num_epochs=2)
    os.remove(root / "isic_cutmix" / "split" / "checkpoints" / "ckpt_000000004.pt")
    eng = _submit("cutmix", root, "split", num_epochs=2, resume=True)
    assert eng.start_epoch == 1
    ckpts = [torch.load(root / "isic_cutmix" / d / "checkpoints" / "ckpt_000000004.pt",
                        weights_only=True) for d in ("straight", "split")]
    a, b = ckpts
    assert a["step"] == b["step"] == 4 and torch.equal(a["generator"], b["generator"])
    for part in ("student", "teacher"):
        assert any("running_var" in k for k in a[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for ga, gb in zip(a["optimizer"]["groups"], b["optimizer"]["groups"]):
        for name in ga:
            assert all(torch.equal(x, y) for x, y in zip(ga[name], gb[name])), name
    restored = checkpoint.state_to_host(eng.state)
    assert torch.equal(restored["generator"], a["generator"])
