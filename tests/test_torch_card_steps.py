"""The port's steps on the card (``-m cuda``; without a GPU every test
skips). Float32 convolutions and matrix products without TF32.

The tiny models against the port on the CPU, two steps with the same
injected rects, lambdas, noise and dropout masks, within
``_torch_card.check_small_run``'s bounds: each algorithm's step on a tiny
DeepLab v2; the other families at tiny depth with training BN and dropout;
each algorithm at grad_accum 2 with frozen BN and with training BN and
dropout.

The recipes' steps at full width, 13 steps on random batches made on the
card: DeepLab v2 R101 on the bench.py recipe for each algorithm, and the
recipes' CutMix lines through the trainer's step factory (DenseUNet-161
ISIC, DeepLab v3+ Pascal, DeepLab v2 Pascal), also at grad_accum 2:
finite metrics, one CutMix kernel launch per step and none off CutMix, the
training-BN kernels on every call with training BN (2,988 launches a
DenseUNet-161 ISIC step) and on none with frozen BN, the running statistics
moved with training BN only, and one capture of the step's CUDA graph.
Imports no JAX."""

import dataclasses
import math
import warnings

import numpy as np
import pytest
import torch

from cutmix_seg_tpu_torch.models.common import Dropout, eval_mode
from cutmix_seg_tpu_torch.models.deeplab3 import DeepLabV3, DeepLabV3Plus
from cutmix_seg_tpu_torch.models.denseunet import DenseUNet
from cutmix_seg_tpu_torch.models.pspnet import PSPNet
from cutmix_seg_tpu_torch.models.resunet import ResUNet
from cutmix_seg_tpu_torch.ops import batchnorm
from cutmix_seg_tpu_torch.ops.cutmix import KERNEL
from cutmix_seg_tpu_torch.semisup.aug_cons import AugConsConfig, make_aug_cons_step
from cutmix_seg_tpu_torch.semisup.ict import ICTConfig, make_ict_step
from cutmix_seg_tpu_torch.semisup.mask_mt import MaskConsistencyConfig, make_mask_mt_step
from cutmix_seg_tpu_torch.semisup.step_graph import GraphedStep
from cutmix_seg_tpu_torch.semisup.vat import VATConfig, make_vat_step
from tests import _torch_card as card

STEPS, LR = 2, 3e-4
# the other families: name -> (module, (n, h, w), draws of TINY_ALGOS'
# algorithm, config, step factory); every batch-statistics BN sees 4 or more
# values per channel
TINY_FAMILIES = {
    "denseunet_cutmix": (lambda: DenseUNet(4, block_config=(2, 2, 2, 2)), (2, 64, 64),
                         "mask_mt", MaskConsistencyConfig(conf_thresh=0.34, freeze_bn=False),
                         make_mask_mt_step),
    "resunet_ict": (lambda: ResUNet(4, layers=card.TINY), (2, 64, 64), "ict",
                    ICTConfig(ict_alpha=0.5, conf_thresh=0.34, freeze_bn=False), make_ict_step),
    "deeplabv3_vat": (lambda: DeepLabV3(4, layers=card.TINY), (4, 33, 33), "vat_fixed",
                      VATConfig(vat_radius=0.5, conf_thresh=0.34, freeze_bn=False),
                      make_vat_step),
    "deeplabv3plus_aug_mt": (lambda: DeepLabV3Plus(4, layers=card.TINY), (4, 41, 41), "aug_mt",
                             AugConsConfig(conf_thresh=0.34, freeze_bn=False),
                             make_aug_cons_step),
    "pspnet_cutmix_pi": (lambda: PSPNet(4, layers=card.TINY), (4, 50, 50), "mask_mt",
                         MaskConsistencyConfig(conf_thresh=0.34, freeze_bn=False,
                                               mean_teacher=False), make_mask_mt_step),
}
# grad_accum 2, per BN mode: (module, (n, h, w)); chunks of two images, so
# every batch-statistics BN of the ResUNet sees 8 values per channel
ACCUM_MODELS = {"frozen_bn": (card.tiny_deeplab2, (4, 33, 33)),
                "training_bn_dropout": (lambda: ResUNet(4, layers=card.TINY), (4, 64, 64))}
# the recipes' CutMix lines as bare steps: (name, grad_accum, steps); the
# DenseUNet at grad_accum 2 takes ~0.6 s a step
RECIPE_CASES = [("densenet161unet ISIC", 1, 13), ("deeplabv3plus Pascal", 1, 13),
                ("deeplab2 Pascal", 1, 13), ("deeplab2 Pascal", 2, 13),
                ("densenet161unet ISIC", 2, 7)]


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the card)")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    torch.cuda.empty_cache()


@pytest.fixture
def host_masks(monkeypatch):
    masks = card.HostMasks()
    monkeypatch.setattr(Dropout, "draw_keep", lambda self, x: masks.draw(self, x))
    return masks


def _runs(sd, make_module, cfg, make_step, algo, n, h, w, masks=None) -> dict:
    """Two steps on the CPU and on the card from the same weights, batch,
    draws and dropout masks."""
    rng = np.random.RandomState(0)
    nb = card.tiny_batch(algo, n, h, w, rng)
    draws = [card.tiny_draws(algo, n, h, w, rng) for _ in range(STEPS)]
    return {d: card.run_tiny(d, sd, make_module, cfg, make_step, nb, draws, masks)
            for d in ("cpu", "cuda")}


def _moved(run, sd) -> list:
    """The student's running statistics that the card's last step left
    other than the initial weights."""
    return [k for k, v in run[1][-1].items() if k.startswith("student.") and "running" in k
            and not torch.equal(v, sd[k[len("student."):]])]


@pytest.mark.cuda
@pytest.mark.parametrize("algo", list(card.TINY_ALGOS))
def test_tiny_steps_match_the_cpu(gpu, algo):
    cfg, make_step = card.TINY_ALGOS[algo]
    n, h, w = 2, 33, 33
    runs = _runs(card.tiny_weights(3), card.tiny_deeplab2, cfg, make_step, algo, n, h, w)
    card.check_small_run(algo, runs, n * h * w, STEPS, LR)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TINY_FAMILIES))
def test_tiny_families_match_the_cpu(gpu, host_masks, name):
    make_module, (n, h, w), algo, cfg, make_step = TINY_FAMILIES[name]
    sd = card.tiny_weights(4, make_module())
    runs = _runs(sd, make_module, cfg, make_step, algo, n, h, w, host_masks)
    assert host_masks.k > 0, "no dropout mask was drawn"
    card.check_small_run(name, runs, n * h * w, STEPS, LR)
    assert _moved(runs["cuda"], sd), "training BN left the running statistics as they were"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(ACCUM_MODELS))
@pytest.mark.parametrize("algo", list(card.TINY_ALGOS))
def test_tiny_accumulating_steps_match_the_cpu(gpu, host_masks, algo, mode):
    cfg1, make_step = card.TINY_ALGOS[algo]
    make_module, (n, h, w) = ACCUM_MODELS[mode]
    training = mode != "frozen_bn"
    cfg = dataclasses.replace(cfg1, grad_accum=card.ACCUM_K, freeze_bn=not training)
    sd = card.tiny_weights(5, make_module())
    with warnings.catch_warnings():
        # the batch-mean gate's per-chunk warning (the recipes' gate)
        warnings.simplefilter("ignore", UserWarning)
        runs = _runs(sd, make_module, cfg, make_step, algo, n, h, w, host_masks)
        card.check_small_run(f"{algo} K={card.ACCUM_K} {mode}", runs, n * h * w, STEPS, LR)
    if training:
        assert _moved(runs["cuda"], sd) and host_masks.k > 0


def _assert_finite_metrics(metrics) -> None:
    for m in metrics:
        assert sorted(m) == ["conf_rate", "cons_loss", "sup_loss"], m
        assert all(math.isfinite(v.item()) for v in m.values()), m


def _assert_one_capture(step, n: int) -> None:
    """A graphed step warms up eagerly, then captures once and replays."""
    if isinstance(step, GraphedStep):
        assert step.counters() == {"captures": 1, "replays": n - 1, "eager_steps": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ("mask_mt",) + card.FULL_ALGOS)
def test_full_width_steps(gpu, algorithm):
    """The bench.py recipe's step (DeepLab v2 R101, bf16, 10 + 10 + 10 at
    321^2) of each algorithm."""
    state, step, batch = card.make_full_step(algorithm)
    n = card.WARMUP + card.ITERS
    w0 = state.student.layer5.conv2d_list[0].weight.detach().clone()
    state, metrics, launches, _, _ = card.run_steps(state, step, batch, 0, n)
    _assert_finite_metrics(metrics)
    # CutMix mask_mt blends with the kernel once per step; the other
    # algorithms never call it
    assert launches[KERNEL] == (n if algorithm == "mask_mt" else 0)
    assert state.step == n
    assert not torch.equal(w0, state.student.layer5.conv2d_list[0].weight)
    with torch.no_grad():
        logits = state.teacher(batch["sup_x"][:2])
    assert logits.shape == (2, card.CROP, card.CROP, card.NUM_CLASSES)
    assert bool(torch.isfinite(logits).all())
    _assert_one_capture(step, n)


@pytest.mark.cuda
@pytest.mark.parametrize("name,accum,n", RECIPE_CASES,
                         ids=[f"{c[0].replace(' ', '_')}-K{c[1]}" for c in RECIPE_CASES])
def test_recipe_steps(gpu, name, accum, n):
    state, step, batch, _, cfg = card.make_recipe_step(name, [f"--grad_accum={accum}"])
    classes = {**card.RECIPE_STEPS, **card.ACCUM_STEPS}[name][1]
    stats0 = card.running_stats(state.student)
    state, metrics, launches, _, _ = card.run_steps(state, step, batch, 0, n)
    _assert_finite_metrics(metrics)
    # one launch per step, over the whole batch, whatever grad_accum is
    assert launches[KERNEL] == n
    stats = card.running_stats(state.student)
    assert all(bool(torch.isfinite(v).all()) for v in stats.values())
    moved = sum(not torch.equal(v, stats0[k]) for k, v in stats.items())
    assert moved == (0 if cfg.freeze_bn else len(stats))
    # training BN goes through the kernels on every call, frozen BN never
    bn_launches = sum(launches[k] for k in batchnorm.KERNELS)
    if cfg.freeze_bn:
        assert bn_launches == 0
    elif name == "densenet161unet ISIC" and accum == 1:
        assert bn_launches == card.DENSENET_BN_LAUNCHES * n
    else:
        assert bn_launches > 0
    crop = tuple(batch["sup_x"].shape[1:3])
    with torch.no_grad(), eval_mode(state.teacher):
        logits = state.teacher(batch["sup_x"][:2])
    assert logits.shape == (2, *crop, classes) and bool(torch.isfinite(logits).all())
    _assert_one_capture(step, n)
