"""The port's mask_mt trainer (train/{mask_mt,engine,common}.py,
core/{checkpoint,job}.py) on the CPU: its click command against the JAX
command, an end-to-end run on a tiny synthetic VOC tree (2 epochs x 3
iterations of a tiny DeepLab v2), --resume as a bit-exact continuation, and
the refusal, before data loads, of every option the port does not run yet
and of what the JAX trainer refuses at the world size."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from cutmix_seg_tpu.train import mask_mt as jmask_mt
from cutmix_seg_tpu_torch.core import checkpoint, job
from cutmix_seg_tpu_torch.data import settings
from cutmix_seg_tpu_torch.data import sources
from cutmix_seg_tpu_torch.data.synthetic import write_config, write_voc_tree
from cutmix_seg_tpu_torch.models import registry
from cutmix_seg_tpu_torch.models.common import SegModel
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label
from cutmix_seg_tpu_torch.parallel import mesh
from cutmix_seg_tpu_torch.train import engine
from cutmix_seg_tpu_torch.train import mask_mt
from tests._torch_tmp import drop_tmp_path_if_passed  # noqa: F401

torch.set_num_threads(1)

TINY_ARCH = "tiny_deeplab_torch_test"


@registry.register(TINY_ARCH)
def _tiny(num_classes, dtype=None, pretrained=True):
    return SegModel(TINY_ARCH, DeepLab2(num_classes, layers=(1, 1, 1, 1), dtype=dtype),
                    np.zeros(3), np.ones(3), (1, 1), _param_label)


def _options(cmd):
    return {p.name: (p.default, getattr(p, "is_flag", False), type(p.type).__name__,
                     tuple(getattr(p.type, "choices", ()) or ()))
            for p in cmd.params}


def test_cli_has_the_jax_options_and_defaults():
    assert _options(mask_mt.experiment) == _options(jmask_mt.experiment)


@pytest.fixture
def voc(tmp_path, monkeypatch):
    """A tiny VOC tree (10 train + 2 val images, 36-48 px) named by a
    temporary cfg through $CUTMIX_SEG_CONFIG, on a 48x48 canvas."""
    root = write_voc_tree(str(tmp_path / "VOC2012"), 10, 2, size_range=(36, 48), seed=4)
    monkeypatch.setenv("CUTMIX_SEG_CONFIG", write_config(str(tmp_path / "seg.cfg"), root))
    monkeypatch.setattr(settings, "_config", None)
    monkeypatch.setattr(sources.PascalVOCDataSource, "canvas_hw", (48, 48))
    return root


def _params(**overrides):
    """The Pascal recipe's flags (run_pascal_aug_experiments.sh) at a tiny
    size, with every other option at the CLI's default. The gate is off
    (conf_thresh 0), so the consistency loss of the random net counts."""
    p = dict(mask_mt.experiment.make_context("experiment", []).params)
    del p["job_desc"]
    p.update(dataset="pascal", arch=TINY_ARCH, freeze_bn=True, batch_size=2,
             learning_rate=3e-5, crop_size="32,32", aug_hflip=True, aug_scale_hung=True,
             aug_strong_colour=True, cons_weight=1.0, mask_mode="mix",
             mask_prop_range="0.5", conf_thresh=0.0, n_sup=4, num_epochs=2,
             iters_per_epoch=3, num_workers=2, no_pretrained=True, save_model=True,
             compute_dtype="float32", nan_check_interval=1, device="cpu")
    p.update(overrides)
    return p


def _submit(root, desc, **overrides):
    return job.submit("test_torch_mask_mt", desc, mask_mt.train_seg_semisup_mask_mt,
                      _params(**overrides), results_root=str(root))


def test_trainer_end_to_end(voc, tmp_path):
    eng = _submit(tmp_path / "results", "run1")
    run_dir = tmp_path / "results" / "test_torch_mask_mt" / "run1"
    log = (run_dir / "log_run1.txt").read_text()
    assert "Epoch 1:" in log and "Epoch 2:" in log and "VAL mIoU=" in log
    assert log.count("\n-- ") == 2  # the per-class line of each epoch
    assert "len(sup_ndx)=4" in log
    records = [json.loads(ln) for ln in (run_dir / "metrics_run1.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [1, 2]
    assert all(np.isfinite(r["sup_loss"]) and r["cons_loss"] > 0 for r in records)
    # one checkpoint per epoch, the newest two kept
    assert sorted(os.listdir(run_dir / "checkpoints")) == ["ckpt_000000003.pt",
                                                           "ckpt_000000006.pt"]
    assert eng.state.step == 6
    model = torch.load(run_dir / "model.pt", weights_only=True)
    assert all(torch.equal(model[k], v) for k, v in eng.eval_net().state_dict().items())
    # duplicate-job skip (reference: job_helper.py:55-56,131-132)
    assert _submit(tmp_path / "results", "run1") is None


def test_cutmix_without_colour_jitter(voc, tmp_path):
    """Without --aug_strong_colour the augmented pair is a channels-first
    buffer seen as NHWC; the CutMix blend still takes it."""
    eng = _submit(tmp_path / "results", "nocolour", aug_strong_colour=False, num_epochs=1,
                  iters_per_epoch=2, save_model=False)
    assert eng.state.step == 2
    log = (tmp_path / "results" / "test_torch_mask_mt" / "nocolour" / "log_nocolour.txt")
    assert "Epoch 1:" in log.read_text()


def test_resume_is_bit_exact_continuation(voc, tmp_path):
    """Two epochs straight and one epoch + --resume to two end in the same
    checkpoint, bit for bit (CPU ops are deterministic)."""
    root = tmp_path / "results"
    _submit(root, "straight", save_model=False)
    _submit(root, "split", num_epochs=1, save_model=False)
    _submit(root, "split", resume=True, save_model=False)
    log = (root / "test_torch_mask_mt" / "split" / "log_split.txt").read_text()
    assert "at epoch 1" in log and log.count("Epoch 1:") == 1 and "Epoch 2:" in log
    a = torch.load(root / "test_torch_mask_mt" / "straight" / "checkpoints" / "ckpt_000000006.pt",
                   weights_only=True)
    b = torch.load(root / "test_torch_mask_mt" / "split" / "checkpoints" / "ckpt_000000006.pt",
                   weights_only=True)
    assert a["step"] == b["step"] == 6 and a["optimizer"]["count"] == 6
    assert torch.equal(a["generator"], b["generator"])
    for part in ("student", "teacher"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    for ga, gb in zip(a["optimizer"]["groups"], b["optimizer"]["groups"]):
        for name in ga:
            assert all(torch.equal(x, y) for x, y in zip(ga[name], gb[name])), name


def test_checkpoint_restores_the_saved_state(voc, tmp_path):
    eng = _submit(tmp_path / "results", "run1", num_epochs=1, save_model=False)
    path = checkpoint.latest_checkpoint(eng.ctx.checkpoint_dir)
    saved = checkpoint.state_to_host(eng.state)
    fresh = engine.TrainEngine(eng.ctx, eng.spec, eng.algo_cfg, _params(num_epochs=1), "cpu")
    fresh.setup()
    assert fresh.state.step == 0
    restored = checkpoint.state_to_host(checkpoint.restore_checkpoint(path, fresh.state))
    assert restored["step"] == saved["step"] == 3
    assert torch.equal(restored["generator"], saved["generator"])
    for part in ("student", "teacher"):
        for k, v in saved[part].items():
            assert torch.equal(restored[part][k], v), (part, k)


# case: (overrides, world size, the exception, its message); exception None:
# the option is accepted, so the run gets as far as loading its data (which
# every refusal precedes) and raises the test's sentinel there (NO_DATA)
REFUSED = {
    # --n_devices must be the world size (one GPU per process)
    "n_devices": (dict(n_devices=2), 1, ValueError, "--n_devices 2 does not match"),
    # spatial eval over several ranks runs on every JAX arch (a ResUNet here)
    "eval_spatial": (dict(eval_spatial=True, arch="resnet50unet_imagenet"), 2, None, None),
    # the world must split into S-rank groups (JAX make_mesh's message)
    "spatial_train": (dict(spatial_train=2), 1, ValueError,
                      "n_model=2 does not divide the device count"),
    # and so does --spatial_train (PSPNet here)
    "spatial_train_arch": (dict(spatial_train=2, arch="resnet101_pspnet_imagenet"), 2,
                           None, None),
    # the crop height must split S ways (the JAX trainer's message)
    "spatial_train_crop": (dict(spatial_train=2, crop_size="33,32"), 2, ValueError,
                           "requires the crop height"),
    # every JAX --arch is in the port: a name in neither registry
    "arch_not_ported": (dict(arch="resnet18_fcn"), 1, KeyError, "unknown architecture"),
}


NO_DATA = "data loaded before the option was refused"


def refusal_of(case):
    """REFUSED[case]'s (overrides, world, exception, message); an accepted
    option's exception is the data load's sentinel."""
    overrides, world, exc, match = REFUSED[case]
    return (overrides, world) + ((exc, match) if exc is not None else (AssertionError, NO_DATA))


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_left_out_options_raise_before_data_loads(case, tmp_path, monkeypatch):
    """Each refused option raises before any data loads; each accepted one
    (exception None) reaches the data."""
    def no_data(*a, **k):
        raise AssertionError(NO_DATA)

    monkeypatch.setattr(engine.datasets, "load_dataset", no_data)
    overrides, world, exc, match = refusal_of(case)
    monkeypatch.setattr(mesh, "world", lambda: world)
    with pytest.raises(exc, match=match):
        _submit(tmp_path / "results", case, **overrides)


def test_trainer_runs_on_cuda_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine.datasets, "load_dataset", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _submit(tmp_path / "results", "gpu", device=None)


def test_save_preds_and_test_split(voc, tmp_path):
    """--n_val holds out train images for validation and makes the official
    val set the test set: the final stage scores the test set and writes
    the predictions of both (as the JAX trainer does)."""
    _submit(tmp_path / "results", "holdout", n_val=2, num_epochs=1, save_preds=True,
            save_model=False)
    run_dir = tmp_path / "results" / "test_torch_mask_mt" / "holdout"
    log = (run_dir / "log_holdout.txt").read_text()
    assert "len(val_ndx)=2" in log and "len(test_ndx)=2" in log
    assert "FINAL TEST: mIoU=" in log and "-- TEST " in log
    preds = sorted(os.listdir(run_dir / "preds"))
    assert len(preds) == 4 and all(p.endswith(".png") for p in preds)


def test_nan_bails_out(voc, tmp_path):
    _submit(tmp_path / "results", "nan", learning_rate=float("nan"), save_model=False)
    log = (tmp_path / "results" / "test_torch_mask_mt" / "nan" / "log_nan.txt").read_text()
    assert "NaN detected; network dead, bailing." in log
    assert "Epoch 1:" not in log


def test_sigterm_stops_before_the_next_iteration(voc, tmp_path, monkeypatch):
    """A SIGTERM during epoch 2 stops the run before its next iteration; the
    epoch-1 checkpoint is the resume point, and --resume finishes the run."""
    make_step = mask_mt.make_mask_mt_step
    calls = []

    def signalling_make_step(*args):
        step = make_step(*args)

        def wrapped(state, batch, ramp):
            calls.append(state.step)
            if state.step == 4:
                signal.raise_signal(signal.SIGTERM)
            return step(state, batch, ramp)
        return wrapped

    monkeypatch.setattr(mask_mt, "make_mask_mt_step", signalling_make_step)
    root = tmp_path / "results"
    _submit(root, "term", save_model=False)
    run_dir = root / "test_torch_mask_mt" / "term"
    log = (run_dir / "log_term.txt").read_text()
    assert "PREEMPTED: stopped at epoch 2 before iter 3" in log and "Epoch 2:" not in log
    assert calls == [0, 1, 2, 3, 4]
    assert os.listdir(run_dir / "checkpoints") == ["ckpt_000000003.pt"]
    monkeypatch.setattr(mask_mt, "make_mask_mt_step", make_step)
    eng = _submit(root, "term", resume=True, save_model=False)
    assert eng.start_epoch == 1 and eng.state.step == 6
