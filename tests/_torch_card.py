"""What the card tests (``-m cuda``), chip_smoke.py and
scripts/torch_step_profile.py build on the card: the recipes' full-width
steps and their random batches, the tiny models' steps with the draws and
dropout masks injected on both devices, the CPU-against-card comparison of
a tiny run, and the inputs of the kernels' checks.

Imports torch and the port only (no JAX: the card's machine has none) and
builds nothing when it is imported.
"""

from __future__ import annotations

import collections
import math
import time

import numpy as np
import torch

from cutmix_seg_tpu_torch.core.train_state import OptimizerConfig, create_train_state
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig, sample_box_rects_np
from cutmix_seg_tpu_torch.models.common import (
    BatchNorm2d,
    Dropout,
    SegModel,
    label_params_by_path,
)
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label, resnet101_deeplab_imagenet
from cutmix_seg_tpu_torch.models.denseunet import DenseUNet
from cutmix_seg_tpu_torch.ops import batchnorm, build
from cutmix_seg_tpu_torch.semisup.aug_cons import AugConsConfig, make_aug_cons_step
from cutmix_seg_tpu_torch.semisup.ict import ICTConfig, make_ict_step, sample_beta
from cutmix_seg_tpu_torch.semisup.mask_mt import MaskConsistencyConfig, make_mask_mt_step
from cutmix_seg_tpu_torch.semisup.step_graph import GraphedStep
from cutmix_seg_tpu_torch.semisup.stepcore import step_scalars
from cutmix_seg_tpu_torch.semisup.vat import VATConfig, _normalize_per_sample, make_vat_step
from cutmix_seg_tpu_torch.train import common
from cutmix_seg_tpu_torch.train.mask_mt import build_spec, experiment

MAIN_SHAPE = (10, 321, 321, 3)  # bench.py: 10 unsupervised images per batch, 321^2
ISIC_SHAPE = (10, 224, 224, 3)  # the ISIC recipe's CutMix blend: 10 images, 224^2
CITY_SHAPE = (4, 256, 512, 3)  # the Cityscapes recipe's: 4 images, 256x512 crops
SWEEP_SHAPE = (8, 64, 64, 3)  # the convergence sweep's CutMix arm: batch 8, 64^2 RGB
BATCH, CROP, NUM_CLASSES = 10, 321, 21
WARMUP, ITERS = 3, 10
TRAIN_ITERS = 10  # the Pascal recipe's iterations an epoch on the synthetic VOC tree


# ---- the CutMix kernel's inputs ----


def case_inputs(n, h, w, c, box_kw, dtype, seed, offset=0):
    """x0, x1 (contiguous; at a storage offset of `offset` elements, so not
    16-byte aligned when it is odd) and rects, made on the card from a seed."""
    rects = sample_box_rects_np(BoxMaskConfig(**box_kw), n, (h, w),
                                np.random.RandomState(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def image():
        buf = torch.empty(offset + n * h * w * c, dtype=dtype, device="cuda")
        buf[offset:] = torch.randn(n * h * w * c, generator=gen, device="cuda").to(dtype)
        return buf[offset:].view(n, h, w, c)

    return image(), image(), torch.from_numpy(rects).cuda()


# ---- the training-BN kernels' inputs ----

BN_MOMENTUM, BN_EPS = 0.9, 1e-5
# the training-BN kernels' launches a DenseUNet-161 ISIC step: 166 BN calls
# a forward, 4 forwards and 2 backwards, 3 kernels each way
DENSENET_BN_LAUNCHES = 166 * (4 * 3 + 2 * 3)


def densenet_bn_calls(device: str, batch: int = 10, hw: int = 224) -> list:
    """Every BN call of one DenseUNet-161 forward at (batch, hw, hw, 3) in
    bf16 (the ISIC recipe's step): (module name, NCHW shape, relu, input
    channels-last)."""
    model = DenseUNet(2, dtype=torch.bfloat16).to(device).eval()
    calls = []

    def spy(name):
        def hook(module, args, kwargs):
            x = args[0]
            calls.append((name, tuple(x.shape), bool(kwargs.get("relu", False)),
                          x.is_contiguous(memory_format=torch.channels_last)))
        return hook

    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(spy(name), with_kwargs=True)
    with torch.no_grad():
        model(torch.zeros(batch, hw, hw, 3, device=device))
    return calls


def bn_inputs(n, c, h, w, dtype, layout, seed):
    """x, dy and the module's vectors on the card from a seed; ``layout``
    channels_last, nchw, offset (channels-last, one element past a 16-byte
    boundary) or grad_nchw (x channels-last, dy NCHW)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = torch.rand(1, c, 1, 1, generator=gen, device="cuda") * 2.8 + 0.2
    x = torch.randn(n, c, h, w, generator=gen, device="cuda") * scale + 0.5
    dy = torch.randn(n, c, h, w, generator=gen, device="cuda")
    x, dy = x.to(dtype), dy.to(dtype)
    if layout in ("channels_last", "grad_nchw"):
        x = x.contiguous(memory_format=torch.channels_last)
    if layout == "channels_last":
        dy = dy.contiguous(memory_format=torch.channels_last)
    if layout == "offset":
        buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        buf[1:] = x.permute(0, 2, 3, 1).reshape(-1)
        x = buf[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    vectors = {"weight": torch.rand(c, generator=gen, device="cuda") + 0.5,
               "bias": torch.rand(c, generator=gen, device="cuda") - 0.5,
               "running_mean": torch.rand(c, generator=gen, device="cuda") - 0.5,
               "running_var": torch.rand(c, generator=gen, device="cuda") + 0.5}
    return x, dy, vectors


def off_the_kink(x, dy, vectors):
    """dy zeroed where the output before the ReLU lies within 1e-3 of 0:
    there the ReLU's gate follows the statistics' last bits, which two
    summation orders round apart."""
    with torch.no_grad():
        y = batchnorm.batch_norm_train_plain(x.float(), vectors["weight"], vectors["bias"], None,
                                             BN_MOMENTUM, BN_EPS)
    return dy.masked_fill(y.abs() < 1e-3, 0)


def bn_gap(a: torch.Tensor, b: torch.Tensor, rtol: float, floor: float,
           cap: float = math.inf) -> float:
    """max |a - b| / min(rtol * |b| + floor * max |b|, cap * max(|b|, 1)):
    at most 1 where a is within rtol of b, or within floor of b's scale
    near 0, and within cap of max(|b|, 1)."""
    a, b = a.float(), b.float()
    scale = rtol * b.abs() + floor * b.abs().max().clamp_min(1e-30)
    if cap < math.inf:
        scale = torch.minimum(scale, cap * b.abs().clamp_min(1.0))
    return ((a - b).abs() / scale).max().item()


# the kernels against their plain version: name -> (n, c, h, w, layout), ReLU
# on and off: DenseUNet-161 block shapes at 10x224^2, and the layouts the
# vector variant does not take (12 and 6 channels, NCHW, an offset view, a
# gradient in NCHW)
BN_CASES = {
    "block1_56": (10, 336, 56, 56, "channels_last"),
    "block4_7": (10, 2160, 7, 7, "channels_last"),
    "head_224": (10, 64, 224, 224, "channels_last"),
    "c12_scalar": (4, 12, 9, 11, "channels_last"),
    "c6_channels_last": (3, 6, 7, 5, "channels_last"),
    "nchw": (4, 96, 14, 14, "nchw"),
    "nchw_96": (10, 96, 56, 56, "nchw"),
    "offset_view_64": (2, 64, 28, 28, "offset"),
    "grad_in_nchw_192": (10, 192, 28, 28, "grad_nchw"),
}
BN_SEED = 99
BN_LEAVES = ("y", "x_grad", "weight_grad", "bias_grad", "running_mean", "running_var")
# (rtol, floor, cap) of ``bn_gap`` by dtype and leaf: the output within one
# ulp of its dtype (2^-8 to 2^-7 relative in bf16) beside float32's rounding
# of the statistics' summation order near 0, and never more than one ulp of
# max(|y|, 1); the input gradient within 2^-6 (bf16) or 8e-5; the weight
# and bias gradients and the running statistics within 1e-4. Each limit is
# the tighter of the two rules that held these cases before they met here.
BN_TOL = {torch.bfloat16: {"y": (2 ** -7, 1e-4, 2 ** -7), "x_grad": (2 ** -6, 2 ** -5 * 1e-2)},
          torch.float32: {"y": (1e-5, 1e-4, 2e-5), "x_grad": (8e-5, 8e-7)}}
BN_TOL_REST = (1e-4, 1e-6)


def bn_run(fn, x, vectors, dy, relu, track=True) -> tuple:
    """``fn`` (``batch_norm_train``'s arguments) forward and backward on x
    itself (an offset view keeps its offset), the gradient of y ``dy``:
    (y, x.grad, weight.grad, bias.grad, running mean, running var), the
    running statistics ``vectors``' own where ``track`` is off."""
    x = x.detach().requires_grad_(True)
    weight = vectors["weight"].clone().requires_grad_(True)
    bias = vectors["bias"].clone().requires_grad_(True)
    running = (vectors["running_mean"].clone(), vectors["running_var"].clone())
    y = fn(x, weight, bias, running if track else None, BN_MOMENTUM, BN_EPS, None, relu)
    y.backward(dy)
    return (y.detach(), x.grad, weight.grad, bias.grad) + running


def bn_check(shape, layout, relu, dtype, seed) -> dict:
    """The training-BN kernels on the card against their plain version on
    ``bn_inputs``: two runs bit for bit, one launch of each kernel (3
    forward, 3 backward), every leaf within ``BN_TOL``. Each leaf's gap (1
    = at its tolerance); raises AssertionError."""
    x, dy, vectors = bn_inputs(*shape, dtype, layout, seed)
    if relu:
        dy = off_the_kink(x, dy, vectors)
    before = collections.Counter(build.launch_counts)
    got = bn_run(batchnorm.batch_norm_train, x, vectors, dy, relu)
    launches = collections.Counter(build.launch_counts) - before
    again = bn_run(batchnorm.batch_norm_train, x, vectors, dy, relu)
    want = bn_run(batchnorm.batch_norm_train_plain, x, vectors, dy, relu)
    torch.cuda.synchronize()
    case = (shape, layout, relu, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), (case, "two runs differ")
    assert launches == collections.Counter(batchnorm.KERNELS), (case, dict(launches))
    gaps = {leaf: bn_gap(a, b, *BN_TOL[dtype].get(leaf, BN_TOL_REST))
            for leaf, a, b in zip(BN_LEAVES, got, want)}
    assert all(v <= 1.0 for v in gaps.values()), (case, gaps)
    return gaps


# ---- the full-width steps ----

# the Pascal recipe (run_pascal_aug_experiments.sh: PARAMS_PASCALAUG_DEEPLAB2I
# and AUG_PASCAL, at the synthetic tree's size)
RECIPE_COMMON = [
    "--dataset=pascal", "--arch=resnet101_deeplab_imagenet", "--freeze_bn",
    "--batch_size=10", "--learning_rate=3e-5", "--crop_size=321,321", "--aug_hflip",
    "--aug_scale_hung", "--aug_strong_colour", "--n_sup=20", "--no_pretrained",
    f"--iters_per_epoch={TRAIN_ITERS}",
]
# its CutMix line (REG_MASK_CUTMIX)
RECIPE_FLAGS = RECIPE_COMMON + ["--cons_weight=1.0", "--mask_mode=mix",
                                "--mask_prop_range=0.5", "--conf_thresh=0.97", "--save_model"]
# the ISIC-2017 recipe (run_isic2017_experiments.sh): DenseUNet-161, training
# BN and dropout, SGD 0.1 poly with weight decay 5e-4, 224^2 crops, fill-holes
# eval; its seven lines: name -> (algorithm, the line's flags)
ISIC_COMMON = [
    "--dataset=isic2017", "--arch=densenet161unet_imagenet", "--batch_size=10",
    "--iters_per_epoch=400", "--num_epochs=100", "--opt_type=sgd", "--learning_rate=0.1",
    "--sgd_weight_decay=5e-4", "--lr_sched=poly", "--bin_fill_holes", "--crop_size=224,224",
    "--aug_hflip", "--aug_vflip", "--aug_hvflip", "--aug_max_scale=1.1", "--aug_rot_mag=45.0",
    "--aug_strong_colour",
]
ISIC_LINES = {
    "sup_50": ("aug_mt", ["--n_sup=50", "--cons_weight=0.0"]),
    "sup_all": ("aug_mt", ["--n_sup=-1", "--cons_weight=0.0"]),
    "cutmix": ("mask_mt", ["--n_sup=50", "--cons_weight=1.0", "--mask_mode=mix",
                           "--mask_prop_range=0.5", "--conf_thresh=0.97"]),
    "cutout": ("mask_mt", ["--n_sup=50", "--cons_weight=1.0", "--mask_mode=zero",
                           "--mask_prop_range=0.0:1.0", "--conf_thresh=0.97"]),
    "aug": ("aug_mt", ["--n_sup=50", "--cons_weight=0.1", "--conf_thresh=0.97"]),
    "ict": ("ict", ["--n_sup=50", "--cons_weight=0.0003", "--ict_alpha=0.1",
                    "--conf_thresh=0.97"]),
    "vat": ("vat_mt", ["--n_sup=50", "--adaptive_vat_radius", "--vat_radius=1.0",
                       "--cons_weight=0.001", "--conf_thresh=0.97"]),
}
# the Pascal DeepLab v3+ recipe's CutMix line
# (run_pascal_aug_deeplab3plus_experiments.sh), but for --dataset=pascal_aug
# and its --split_path: the synthetic tree is a plain VOC tree
V3PLUS_CUTMIX = [
    "--dataset=pascal", "--arch=resnet101_deeplabv3plus_imagenet", "--freeze_bn",
    "--batch_size=10", "--learning_rate=1e-5", "--iters_per_epoch=1000", "--num_epochs=40",
    "--crop_size=321,321", "--aug_hflip", "--aug_scale_hung", "--aug_strong_colour",
    "--n_sup=100", "--cons_weight=1.0", "--mask_mode=mix", "--mask_prop_range=0.5",
    "--conf_thresh=0.97",
]
# the recipes' CutMix lines as bare steps: name -> (flags, classes)
RECIPE_STEPS = {
    "densenet161unet ISIC": (ISIC_COMMON + ISIC_LINES["cutmix"][1], 2),
    "deeplabv3plus Pascal": (V3PLUS_CUTMIX, NUM_CLASSES),
}
# the steps run at grad_accum 1 and 2 (name -> (flags, classes))
ACCUM_STEPS = {
    "deeplab2 Pascal": (RECIPE_FLAGS, NUM_CLASSES),
    "densenet161unet ISIC": RECIPE_STEPS["densenet161unet ISIC"],
}
ACCUM_K = 2
# the Pascal recipe's lines of the other algorithms
# (run_pascal_aug_experiments.sh:22-24)
FULL_ALGOS = ("ict", "vat_mt", "aug_mt")


def parse_flags(flags, command=experiment) -> dict:
    """``flags`` parsed by a trainer's click command (mask_mt's by default)."""
    params = dict(command.make_context("experiment", list(flags)).params)
    del params["job_desc"]
    return params


def make_full_step(algorithm: str = "mask_mt"):
    """The bench.py recipe on the port for ``algorithm`` (mask_mt: CutMix;
    ict, vat_mt, aug_mt: the recipe's lines): (state, step, batch) on the
    card. The unsupervised images are 10 + 10 for mask_mt and ICT, 10 for
    VAT and aug_mt (one crop pair per image)."""
    torch.backends.cudnn.benchmark = True
    model = resnet101_deeplab_imagenet(NUM_CLASSES, dtype=torch.bfloat16, pretrained=False)
    state, opt = create_train_state(
        model, OptimizerConfig(opt_type="adam", learning_rate=3e-5), 0, pretrained=False)
    common_kw = dict(cons_weight=1.0, conf_thresh=0.97, conf_per_pixel=False,
                     freeze_bn=True, mean_teacher=True, teacher_alpha=0.99)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (BATCH, CROP, CROP, 3)
    ones = torch.ones(shape[:3] + (1,), device="cuda")
    batch = {"sup_x": torch.randn(shape, generator=gen, device="cuda"),
             "sup_y": torch.randint(0, NUM_CLASSES, shape[:3], generator=gen, device="cuda")}
    if algorithm in ("mask_mt", "ict"):
        for k in ("ux0", "ux1"):
            batch[f"{k}_tea"] = batch[f"{k}_stu"] = torch.randn(shape, generator=gen,
                                                                device="cuda")
        batch["um0"], batch["um1"] = ones, ones
    if algorithm == "mask_mt":
        step = make_mask_mt_step(model, opt, MaskConsistencyConfig(
            mask_mode="mix", box=BoxMaskConfig((0.5, 0.5)), remat_loss_chain=True,
            loss_softmax_dtype="bfloat16", **common_kw))
    elif algorithm == "ict":
        step = make_ict_step(model, opt, ICTConfig(ict_alpha=0.1, **common_kw))
    elif algorithm == "vat_mt":
        batch["ux_tea"] = batch["ux_stu"] = torch.randn(shape, generator=gen, device="cuda")
        batch["um"] = ones
        step = make_vat_step(model, opt, VATConfig(
            vat_radius=1.0, adaptive_vat_radius=True, **dict(common_kw, cons_weight=0.1)))
    elif algorithm == "aug_mt":
        batch["ux0"] = torch.randn(shape, generator=gen, device="cuda")
        batch["ux1"] = torch.randn(shape, generator=gen, device="cuda")
        batch["um0"], batch["um1"] = ones, ones
        # crop 1 is crop 0 shifted by up to 16 px (the --aug_offset_range
        # default) in grid units
        xf = torch.eye(2, 3, device="cuda").repeat(BATCH, 1, 1)
        xf[:, :, 2] = (torch.rand((BATCH, 2), generator=gen, device="cuda") * 2 - 1) \
            * (16.0 * 2 / (CROP - 1))
        batch["xf0_to_1"] = xf
        step = make_aug_cons_step(model, opt, AugConsConfig(**common_kw))
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return state, step, batch


def make_recipe_step(name: str, extra=()):
    """A recipe's CutMix line (``RECIPE_STEPS``, ``ACCUM_STEPS``) and
    ``extra`` flags as a bare step at full width, built as the trainer
    builds it (its flags, ``build_spec``, ``build_model``, the optimiser of
    its schedule), on random batches made on the card: (state, step, batch,
    parsed flags, step config)."""
    flags, classes = {**RECIPE_STEPS, **ACCUM_STEPS}[name]
    p = parse_flags(list(flags) + list(extra))
    spec, cfg = build_spec(p)
    model = common.build_model(p["arch"], classes, p["compute_dtype"])
    total = p["iters_per_epoch"] * p["num_epochs"]
    opt_cfg = common.build_optimizer_config(
        p["opt_type"], p["learning_rate"], p["lr_sched"], p["lr_step_epochs"],
        p["lr_step_gamma"], p["lr_poly_power"], total, p["iters_per_epoch"],
        p["sgd_momentum"], p["sgd_nesterov"], p["sgd_weight_decay"])
    torch.backends.cudnn.benchmark = True
    state, opt = create_train_state(model, opt_cfg, 0, mean_teacher=cfg.mean_teacher,
                                    pretrained=False)
    step = spec.make_step(model, opt)
    crop = common.parse_crop_size(p["crop_size"])
    shape = (BATCH, *crop, 3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ones = torch.ones(shape[:3] + (1,), device="cuda")
    batch = {"sup_x": torch.randn(shape, generator=gen, device="cuda"),
             "sup_y": torch.randint(0, classes, shape[:3], generator=gen, device="cuda"),
             "um0": ones, "um1": ones}
    for k in ("ux0", "ux1"):
        batch[f"{k}_tea"] = batch[f"{k}_stu"] = torch.randn(shape, generator=gen, device="cuda")
    return state, step, batch, p, cfg


def run_steps(state, step, batch, warmup: int = WARMUP, iters: int = ITERS) -> tuple:
    """``warmup`` steps, then ``iters`` more on the same batch: (state, the
    last ``iters`` steps' metrics, the kernel launches of all of them by
    name, the seconds of the warm-up, the seconds of the last ``iters``
    synchronised)."""
    build.launch_counts.clear()
    t0 = time.perf_counter()
    for _ in range(warmup):
        state, _ = step(state, dict(batch), 1.0)  # a graphed step consumes its batch
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    metrics = []
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, dict(batch), 1.0)
        metrics.append(m)
    torch.cuda.synchronize()
    return state, metrics, collections.Counter(build.launch_counts), warm_s, \
        time.perf_counter() - t0


def running_stats(net: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in net.named_buffers() if "running" in k}


# ---- the tiny models' steps, card against CPU ----

TINY = (1, 1, 1, 1)


def tiny_deeplab2():
    return DeepLab2(4, layers=TINY)


def _tiny_label(module):
    return label_params_by_path(module, [("backbone", "pretrained"), ("features", "pretrained")])


def tiny_state(device, sd, make_module=tiny_deeplab2, mean_teacher=True):
    label = _param_label if make_module is tiny_deeplab2 else _tiny_label
    model = SegModel("tiny", make_module(), np.zeros(3), np.ones(3), (1, 1), label)
    state, opt = create_train_state(model, OptimizerConfig(learning_rate=3e-4), 0,
                                    device=device, mean_teacher=mean_teacher, pretrained=False)
    for net in (state.student, state.teacher):
        if net is not None:
            net.load_state_dict(sd)
    return model, state, opt


def tiny_weights(seed, module=None):
    """He-scaled convs (classifier x0.1) and random BN statistics, so the
    random model has O(1) logits and its confidence gate is exercised."""
    rng = np.random.RandomState(seed)
    sd = (module or tiny_deeplab2()).state_dict()
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        if v.dim() == 4:
            gain = 0.1 if k.startswith("layer5") or "classifier" in k or "final_clf" in k \
                else 1.0
            val = rng.randn(*shape) * gain * math.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("running_var"):
            val = rng.uniform(0.5, 2.0, shape)
        elif k.endswith("running_mean"):
            val = rng.uniform(-0.5, 0.5, shape)
        elif k.endswith("weight"):
            val = rng.uniform(0.5, 1.5, shape)
        else:
            val = rng.uniform(-0.2, 0.2, shape)
        out[k] = torch.from_numpy(val.astype(np.float32))
    return out


def tiny_batch(algo: str, n: int, h: int, w: int, rng) -> dict:
    """numpy batch of the tiny model's steps. ICT's and VAT's student images
    differ from the teacher's, as colour jitter makes them."""
    nb = {"sup_x": rng.randn(n, h, w, 3).astype(np.float32),
          "sup_y": rng.randint(0, 4, size=(n, h, w)).astype(np.int64)}

    def img():
        return rng.randn(n, h, w, 3).astype(np.float32)

    def mask():
        return (rng.rand(n, h, w, 1) > 0.2).astype(np.float32)

    if algo in ("mask_mt", "ict"):
        for k in ("ux0", "ux1"):
            nb[f"{k}_tea"] = img()
            nb[f"{k}_stu"] = nb[f"{k}_tea"] + (0.3 * img() if algo == "ict" else 0.0)
        nb["um0"], nb["um1"] = mask(), mask()
    elif algo.startswith("vat"):
        nb["ux_tea"] = img()
        nb["ux_stu"] = nb["ux_tea"] + 0.3 * img()
        nb["um"] = mask()
    else:
        nb["ux0"], nb["ux1"], nb["um0"], nb["um1"] = img(), img(), mask(), mask()
        # the pair transform: rotation up to 0.3 rad, shifts up to 0.4, so
        # some taps leave the image
        ang, t = rng.uniform(-0.3, 0.3, n), rng.uniform(-0.4, 0.4, (n, 2))
        xf = np.zeros((n, 2, 3), np.float32)
        xf[:, 0, 0], xf[:, 0, 1], xf[:, 1, 0], xf[:, 1, 1] = (np.cos(ang), -np.sin(ang),
                                                              np.sin(ang), np.cos(ang))
        xf[:, :, 2] = t
        nb["xf0_to_1"] = xf
    return nb


def tiny_draws(algo: str, n: int, h: int, w: int, rng) -> dict:
    """One step's injected draws, the same on both devices (the JAX steps
    draw them from their key, the port's from the state's generator)."""
    if algo == "mask_mt":
        return {"rects": sample_box_rects_np(BoxMaskConfig((0.5, 0.5)), n, (h, w), rng)}
    if algo == "ict":
        g = torch.Generator().manual_seed(int(rng.randint(1 << 30)))
        return {"lam": sample_beta(0.5, (n, 1, 1, 1), g).numpy()}
    if algo.startswith("vat"):
        eps = _normalize_per_sample(torch.from_numpy(rng.randn(n, h, w, 3).astype(np.float32)))
        return {"eps0": (eps * (1.0e-6 * h * w / 1000.0)).numpy()}
    return {}  # aug_mt draws nothing


# name -> (config, step factory); the gate threshold is one the tiny model's
# confidences cross
TINY_ALGOS = {
    "mask_mt": (MaskConsistencyConfig(conf_thresh=0.34), make_mask_mt_step),
    "ict": (ICTConfig(ict_alpha=0.5, conf_thresh=0.34), make_ict_step),
    "vat_fixed": (VATConfig(vat_radius=0.5, conf_thresh=0.34), make_vat_step),
    "vat_adaptive": (VATConfig(vat_radius=1.0, adaptive_vat_radius=True, cons_weight=0.1,
                               conf_thresh=0.34), make_vat_step),
    "aug_mt": (AugConsConfig(conf_thresh=0.34), make_aug_cons_step),
}


class HostMasks:
    """Dropout keep masks by call order, drawn on the host (call k of a
    step from seed 500 + k) and copied to the forward's device, so both
    devices' runs drop the same activations."""

    def __init__(self):
        self.k = 0

    def draw(self, drop: Dropout, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        keep = np.random.RandomState(500 + self.k).rand(n, h, w, c) < 1.0 - drop.rate
        self.k += 1
        return torch.from_numpy(keep).to(x.device).permute(0, 3, 1, 2)


# BN running statistics after the first step (its forwards ran on equal
# weights on both devices), relative to max(1, |value|)
STATS_RTOL = 1e-4


def check_small_run(name: str, runs: dict, n_px: int, steps: int, lr: float,
                    labels=("cpu", "cuda")) -> None:
    """Hold a tiny model's CUDA run against its CPU run: conv sums run in
    another order on the card, so rtol 1e-4 on the CE; the gate is a mean of
    0/1 values, so a pixel whose confidence lies within rounding of the
    threshold may flip: allow two flips; Adam moves a noise-level gradient's
    element by up to 2 lr per step, so every parameter (student and teacher)
    is held within that after the last step. The running statistics of a
    later step come from those diverged weights (several percent apart in a
    random tiny ResUNet's decoder after two steps), so they are held after
    the first step, within STATS_RTOL."""
    one_gate = 1.0 / n_px
    for i, (mc, mg) in enumerate(zip(runs["cpu"][0], runs["cuda"][0])):
        print(f"[small] {name} step {i}: {labels[0]} {mc} {labels[1]} {mg}", flush=True)
        ok = (math.isclose(mc["sup_loss"], mg["sup_loss"], rel_tol=1e-4)
              and abs(mc["conf_rate"] - mg["conf_rate"]) <= 2 * one_gate + 1e-7
              and math.isclose(mc["cons_loss"], mg["cons_loss"],
                               rel_tol=1e-4 + 4 * one_gate))
        if not ok:
            raise RuntimeError(f"small-model {name} step {i}: {labels[1]} and {labels[0]} "
                               "disagree")
    first, last = ({k: (runs["cpu"][1][i][k], runs["cuda"][1][i][k]) for k in runs["cpu"][1][i]}
                   for i in (0, -1))
    worst = max((a - b).abs().max().item() for k, (a, b) in last.items() if "running" not in k)
    stats = [((a - b).abs() / a.abs().clamp_min(1.0)).max().item()
             for k, (a, b) in first.items() if "running" in k]
    worst_stats = max(stats, default=0.0)
    print(f"[small] {name}: max |param {labels[0]} - {labels[1]}| after {steps} steps: "
          f"{worst:.3g} (bound 2*lr*steps = {2 * lr * steps:.3g}); running statistics after "
          f"step 1: max relative difference {worst_stats:.3g} over {len(stats)} (bound "
          f"{STATS_RTOL})", flush=True)
    if worst > 2 * lr * steps + 1e-6 or worst_stats > STATS_RTOL:
        raise RuntimeError(f"small-model {name} states diverge between {labels[1]} and "
                           f"{labels[0]}")


def run_tiny(device, sd, make_module, cfg, make_step, nb, draws, masks=None) -> tuple:
    """Steps of a tiny model on ``device``: (metrics per step, every tensor
    of the student's and the teacher's state dicts on the host after each
    step)."""
    model, state, opt = tiny_state(device, sd, make_module, cfg.mean_teacher)
    step = make_step(model, opt, cfg)
    if isinstance(step, GraphedStep):
        # the eager body on both devices: host-drawn dropout masks are copied
        # to the device inside the step, which a CUDA graph cannot hold
        body = step.body

        def step(state, batch, ramp, rects=None):
            return body(state, batch, step_scalars(opt, ramp, state.generator.device), rects)
    batch = {k: torch.from_numpy(v).to(device) for k, v in nb.items()}
    metrics, tensors = [], []
    for d in draws:
        if masks is not None:
            masks.k = 0
        kw = {k: torch.from_numpy(v).to(device) for k, v in d.items()}
        state, m = step(state, batch, 1.0, **kw)
        metrics.append({k: v.item() for k, v in m.items()})
        # copies: a CPU state dict's tensors are the ones the next step updates
        tensors.append({f"{part}.{k}": v.to("cpu", copy=True)
                        for part, net in (("student", state.student), ("teacher", state.teacher))
                        if net is not None for k, v in net.state_dict().items()})
    return metrics, tensors
