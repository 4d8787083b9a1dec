"""Drive the PyTorch/CUDA port (cutmix_seg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure exits non-zero before the result lines:
  1. build: print the card's name and power limit, compile every kernel under
     cutmix_seg_tpu_torch/csrc/ with nvcc (sm_90a) and time the build;
  2. kernel vs plain: the CutMix kernel against its plain PyTorch version on
     the card, bit-equal masks and blends, f32 and bf16, at the main-path
     shape, the ISIC path's 10x224x224x3 and the edge cases (unaligned views,
     ragged ends, 21 channels, 70,000 images); then timed with CUDA events at
     the main-path shape (L2 flushed before each launch): the kernel in f32
     and bf16 beside its bounds and beside torch.add of the same tensors (a
     bandwidth yardstick), the plain version, the unaligned variant, the
     timing's floor (one pixel), and the same calls after a flush that
     leaves L2 clean; and the kernel and plain version at 224^2;
  3. small model, GPU vs CPU: the tiny DeepLab v2 in f32 (TF32 off) for two
     steps of each algorithm (mask_mt, ICT, VAT with a fixed and an adaptive
     radius, aug_mt) with injected rects / lambdas / noise / pair matrices,
     held against the port's own CPU run;
  3b. the other families at tiny depth, GPU vs CPU in f32 with training BN
     and dropout (masks drawn on the host, the same for both runs): DenseNet
     features (2, 2, 2, 2) in a DenseUNet with CutMix, ResUNet with ICT,
     DeepLab v3 with VAT, v3+ with aug_mt, PSPNet with the CutMix pi-model
     (layers (1, 1, 1, 1)); losses, parameters and the running statistics of
     student and teacher held as in phase 3;
  4. full width: DeepLab v2 R101, bf16, the bench.py recipe at bs 10+10+10,
     321x321: 3 warm-up and 10 timed steps through create_train_state and
     make_mask_mt_step; losses finite, one kernel launch per step;
  4b. the same for the ICT, VAT (adaptive radius 1.0, cons_weight 0.1) and
     aug_mt steps of the recipe: finite losses, no kernel launch, ms/step and
     peak memory beside phase 4; and what VAT's noise does in bf16;
  4c. the two recipes' CutMix lines as bare steps at full width, 3 warm-up
     and 10 timed, through the trainer's own step factory: DenseUNet-161 at
     224^2 with training BN and dropout, SGD 0.1 poly (ISIC), and DeepLab v3+
     R101 at 321^2 with frozen BN, Adam 1e-5 (Pascal); ms/step, img/s, peak
     memory, one kernel launch per step, the DenseUNet's running statistics
     moved and finite;
  5. augmentation and eval, card against CPU: host batches of a synthetic
     VOC tree from the port's loader (10 images, 321x321 crops from 512x512
     canvases) through augment_batch on the gather path (crop_rotate_scale,
     reflect101) and the separable path (crop_scale_hung), colour jitter on,
     with the same injected colour draws on both devices: labels bit-equal,
     images and valid masks within float32 rounding; confusion_matrix at
     10x512x512 bit-equal;
  6. the trainer at full width: train_seg_semisup_mask_mt through job.submit
     with the Pascal recipe on that VOC tree (R101, random init), 2 epochs x
     10 iterations, then --resume to epoch 3: epoch lines with finite losses
     and a VAL mIoU, one kernel launch per iteration, a checkpoint and
     model.pt, the restored state equal to the saved one bit for bit, the
     resumed run starting at epoch 3; the trainer's ms/iteration and img/s
     beside phase 4's bare step;
  6b. the ICT, VAT and aug_mt trainers with the recipe's lines on that tree,
     1 epoch x 10 iterations each: an epoch line with finite losses and a VAL
     mIoU, a checkpoint, no kernel launch, ms/iteration;
  6c. on a synthetic ISIC zip, the ISIC recipe's seven lines at full width
     (--no_pretrained, 1 epoch x 4 iterations each, fill-holes eval), the
     CutMix line restored bit for bit (BN buffers and generator included)
     and resumed for a second epoch; then the v3+ CutMix line on the
     synthetic VOC tree (1 epoch x 5 iterations);
  7. the kernel summary line and, last, the device line.

Imports nothing of JAX: it runs where only PyTorch and the CUDA toolkit are.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from cutmix_seg_tpu_torch.aug.device import augment_batch, border_for_mode
from cutmix_seg_tpu_torch.aug.params import GeomConfig
from cutmix_seg_tpu_torch.core import checkpoint, job
from cutmix_seg_tpu_torch.core.train_state import OptimizerConfig, create_train_state
from cutmix_seg_tpu_torch.data import settings
from cutmix_seg_tpu_torch.data.loader import HostBatchBuilder, train_stream
from cutmix_seg_tpu_torch.data.sources import PascalVOCDataSource
from cutmix_seg_tpu_torch.data.synthetic import write_config, write_isic_zip, write_voc_tree
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig, sample_box_rects_np
from cutmix_seg_tpu_torch.models.common import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    Dropout,
    SegModel,
    eval_mode,
    label_params_by_path,
)
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label, resnet101_deeplab_imagenet
from cutmix_seg_tpu_torch.models.deeplab3 import DeepLabV3, DeepLabV3Plus
from cutmix_seg_tpu_torch.models.denseunet import DenseUNet
from cutmix_seg_tpu_torch.models.pspnet import PSPNet
from cutmix_seg_tpu_torch.models.resunet import ResUNet
from cutmix_seg_tpu_torch.ops import build
from cutmix_seg_tpu_torch.ops.colour import (
    ColourJitterConfig,
    ColourParams,
    sample_colour_params,
)
from cutmix_seg_tpu_torch.ops.cutmix import KERNEL, cutmix_blend, cutmix_blend_plain
from cutmix_seg_tpu_torch.ops.iou import confusion_matrix
from cutmix_seg_tpu_torch.semisup.aug_cons import AugConsConfig, make_aug_cons_step
from cutmix_seg_tpu_torch.semisup.ict import ICTConfig, make_ict_step, sample_beta
from cutmix_seg_tpu_torch.semisup.mask_mt import MaskConsistencyConfig, make_mask_mt_step
from cutmix_seg_tpu_torch.semisup.vat import (
    VATConfig,
    _normalize_per_sample,
    adversarial_input,
    make_vat_step,
)
from cutmix_seg_tpu_torch.train import aug_mt, common, ict, vat_mt
from cutmix_seg_tpu_torch.train.mask_mt import build_spec, experiment, train_seg_semisup_mask_mt

# H100 SXM data sheet: HBM rate and the float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

MAIN_SHAPE = (10, 321, 321, 3)  # bench.py: 10 unsupervised images per batch, 321^2
ISIC_SHAPE = (10, 224, 224, 3)  # the ISIC recipe's CutMix blend: 10 images, 224^2
BATCH, CROP, NUM_CLASSES = 10, 321, 21
WARMUP, ITERS = 3, 10
# phase 5: augmented images agree within float32 rounding: source coordinates
# to a few ulps, times a step of up to 255 between neighbouring pixels, is
# 2e-3 on the 0-255 scale, 5e-5 after normalisation (std 0.224); a valid
# mask moves by the coordinate's own error (1e-5)
AUG_NORM_ATOL, AUG_MASK_ATOL = 5e-5, 1e-5
# phase 6: the synthetic VOC tree and the trainer's run
VOC_TRAIN, VOC_VAL, TRAIN_ITERS = 40, 10, 10


def note(msg: str) -> None:
    print(msg, flush=True)


def phase_build() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    note(smi)
    t0 = time.perf_counter()
    per_source = build.build(build.sources())
    note(f"[build] {sorted(build.sources())} built in {time.perf_counter() - t0:.2f} s "
         f"(per source: { {k: round(v, 2) for k, v in per_source.items()} })")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                note(f"[build] {name}: {line.strip()}")
    return {"nvidia_smi": smi}


def _case_inputs(n, h, w, c, box_kw, dtype, seed, offset=0):
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


def _time_ms(fn, flush: torch.Tensor, iters: int = 50, clean: bool = False) -> float:
    """Median device time of one call, each launch after an L2 flush: a
    write of `flush` (L2 left full of dirty lines, as in earlier runs), or,
    with `clean`, that write and then a read of it (L2 left full of clean
    lines, so the call pays no write-back of another kernel's data)."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        if clean:
            flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _bound_ms(x0: torch.Tensor, rects: torch.Tensor):
    """(bound in ms, bytes, what bounds it) of one call: each input read and
    each output written once; box compares and the blend as f32 operations."""
    n, h, w, c = x0.shape
    n_bytes = 3 * x0.numel() * x0.element_size() + rects.numel() * 4 \
        + n * h * w * x0.element_size()
    n_ops = n * h * w * (4 * rects.shape[1] + 3 * c)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), n_bytes, "bytes" if bytes_ms >= ops_ms else "operations"


def phase_kernel_vs_plain() -> dict:
    # name: (n, h, w, c, box config, invert, storage offset of x0 and x1)
    half = dict(prop_range=(0.5, 0.5))
    cases = {
        "main_path": (*MAIN_SHAPE, half, True, 0),
        "isic_224": (*ISIC_SHAPE, half, True, 0),
        "two_boxes_64": (4, 64, 64, 3, dict(prop_range=(0.25, 0.75), n_boxes=2), True, 0),
        "odd_height_no_invert": (2, 33, 48, 1, dict(prop_range=(0.5, 0.5), invert=False),
                                 False, 0),
        "outside_bounds": (6, 40, 52, 3, dict(prop_range=(0.3, 0.9), n_boxes=2,
                                              within_bounds=False), True, 0),
        # not 16-byte aligned: the kernel's one-element variant
        "offset_view": (*MAIN_SHAPE, half, True, 1),
        # 2907 elements: a ragged end in f32 and bf16, vectors across samples
        "tail_and_straddle": (3, 17, 19, 3, half, True, 0),
        "c21": (2, 41, 41, 21, half, True, 0),
        # past the 65,535 grid-y limit of the per-sample grid
        "batch_70000": (70000, 2, 3, 1, half, True, 0),
    }
    max_err = 0.0
    for seed, (name, (n, h, w, c, box_kw, invert, offset)) in enumerate(sorted(cases.items())):
        for dtype in (torch.float32, torch.bfloat16):
            x0, x1, rects = _case_inputs(n, h, w, c, box_kw, dtype, seed, offset)
            if name == "outside_bounds" and not bool((rects < 0).any()):
                raise RuntimeError("outside_bounds case has no negative coordinate")
            mix_k, m_k = cutmix_blend(x0, x1, rects, invert)
            mix_p, m_p = cutmix_blend_plain(x0, x1, rects, invert)
            torch.cuda.synchronize()
            err = max((mix_k.float() - mix_p.float()).abs().max().item(),
                      (m_k.float() - m_p.float()).abs().max().item())
            max_err = max(max_err, err)
            equal = torch.equal(mix_k, mix_p) and torch.equal(m_k, m_p)
            note(f"[kernel] {name} {str(dtype)[6:]} {tuple(x0.shape)} B={rects.shape[1]} "
                 f"offset={offset}: bit-equal={equal} max_abs_err={err}")
            if not equal:
                raise RuntimeError(f"cutmix_blend kernel != plain on {name} {dtype}")

    # timing at the main-path shape (one box), L2 flushed before each launch
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    x0, x1, rects = _case_inputs(*MAIN_SHAPE, half, torch.float32, 0)
    b0, b1 = x0.bfloat16(), x1.bfloat16()
    out, out_b = torch.empty_like(x0), torch.empty_like(b0)
    calls = {  # name: (call, bytes it moves)
        "kernel f32": (lambda: cutmix_blend(x0, x1, rects), _bound_ms(x0, rects)[1]),
        "kernel bf16": (lambda: cutmix_blend(b0, b1, rects), _bound_ms(b0, rects)[1]),
        # bandwidth yardstick: one PyTorch call that reads two such tensors
        # and writes one (37.09 MB of the kernel's 41.22 in f32); it computes
        # another function and nothing in the port calls it
        "torch.add f32": (lambda: torch.add(x0, x1, out=out), 3 * x0.numel() * 4),
        "torch.add bf16": (lambda: torch.add(b0, b1, out=out_b), 3 * b0.numel() * 2),
    }
    ms = {name: _time_ms(fn, flush) for name, (fn, _) in calls.items()}
    gbps = {name: nb / ms[name] / 1e6 for name, (_, nb) in calls.items()}
    plain_ms = _time_ms(lambda: cutmix_blend_plain(x0, x1, rects), flush)
    bound_ms, n_bytes, bound_by = _bound_ms(x0, rects)
    bf16_bound_ms, bf16_bytes, _ = _bound_ms(b0, rects)
    for dt, bound, nb in (("f32", bound_ms, n_bytes), ("bf16", bf16_bound_ms, bf16_bytes)):
        k = f"kernel {dt}"
        note(f"[kernel] main path {dt} {MAIN_SHAPE}: kernel {ms[k] * 1e3:.2f} us, bound "
             f"{bound * 1e3:.2f} us ({nb / 1e6:.2f} MB at 3.35 TB/s; {gbps[k]:.1f} GB/s achieved, "
             f"{bound / ms[k]:.1%} of the bound); yardstick torch.add {dt} "
             f"{ms[f'torch.add {dt}'] * 1e3:.2f} us, {gbps[f'torch.add {dt}']:.1f} GB/s: the "
             f"kernel's rate is {gbps[k] / gbps[f'torch.add {dt}']:.1%} of it")
    note(f"[kernel] plain version f32: {plain_ms * 1e3:.2f} us")

    xu0, xu1, _ = _case_inputs(*MAIN_SHAPE, half, torch.float32, 0, offset=1)
    unaligned_ms = _time_ms(lambda: cutmix_blend(xu0, xu1, rects), flush)
    note(f"[kernel] main path f32, x0/x1 at offset 1 (one-element variant): "
         f"{unaligned_ms * 1e3:.2f} us, {n_bytes / unaligned_ms / 1e6:.1f} GB/s")
    # what this timing gives a call that moves almost nothing
    p0, p1, pr = _case_inputs(1, 1, 1, 1, half, torch.float32, 0)
    floor_ms = _time_ms(lambda: cutmix_blend(p0, p1, pr), flush)
    one, one_out = torch.ones(1, device="cuda"), torch.empty(1, device="cuda")
    add1_ms = _time_ms(lambda: torch.add(one, one, out=one_out), flush)
    note(f"[kernel] floor of this timing: the kernel on 1 pixel {floor_ms * 1e3:.2f} us, "
         f"torch.add of 1 element {add1_ms * 1e3:.2f} us")
    clean = {name: _time_ms(fn, flush, clean=True) for name, (fn, _) in calls.items()}
    note("[kernel] with L2 left clean before each launch: " + ", ".join(
        f"{name} {t * 1e3:.2f} us ({calls[name][1] / t / 1e6:.1f} GB/s)"
        for name, t in clean.items()))
    # the ISIC path's shape
    xi0, xi1, ri = _case_inputs(*ISIC_SHAPE, half, torch.float32, 0)
    ms_224 = _time_ms(lambda: cutmix_blend(xi0, xi1, ri), flush)
    plain_224 = _time_ms(lambda: cutmix_blend_plain(xi0, xi1, ri), flush)
    bound_224, bytes_224, _ = _bound_ms(xi0, ri)
    note(f"[kernel] ISIC path f32 {ISIC_SHAPE}: kernel {ms_224 * 1e3:.2f} us, bound "
         f"{bound_224 * 1e3:.2f} us ({bytes_224 / 1e6:.2f} MB at 3.35 TB/s; "
         f"{bound_224 / ms_224:.1%} of the bound); plain version {plain_224 * 1e3:.2f} us")
    return {"max_abs_err": max_err, "ms": ms["kernel f32"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ms_bf16": ms["kernel bf16"],
            "bound_ms_bf16": bf16_bound_ms, "yardstick_gbps": gbps["torch.add f32"],
            "ms_224": ms_224, "plain_ms_224": plain_224, "bound_ms_224": bound_224}


def _tiny_deeplab2():
    return DeepLab2(4, layers=(1, 1, 1, 1))


def _tiny_label(module):
    return label_params_by_path(module, [("backbone", "pretrained"), ("features", "pretrained")])


def _tiny_state(device, sd, make_module=_tiny_deeplab2, mean_teacher=True):
    label = _param_label if make_module is _tiny_deeplab2 else _tiny_label
    model = SegModel("tiny", make_module(), np.zeros(3), np.ones(3), (1, 1), label)
    state, opt = create_train_state(model, OptimizerConfig(learning_rate=3e-4), 0,
                                    device=device, mean_teacher=mean_teacher, pretrained=False)
    for net in (state.student, state.teacher):
        if net is not None:
            net.load_state_dict(sd)
    return model, state, opt


def _tiny_weights(seed, module=None):
    """He-scaled convs (classifier x0.1) and random BN statistics, so the
    random model has O(1) logits and its confidence gate is exercised."""
    rng = np.random.RandomState(seed)
    sd = (module or _tiny_deeplab2()).state_dict()
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


def _tiny_batch(algo: str, n: int, h: int, w: int, rng) -> dict:
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


def _tiny_draws(algo: str, n: int, h: int, w: int, rng) -> dict:
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


# phase 3: (config, step factory); the gate threshold is one the tiny
# model's confidences cross
TINY_ALGOS = {
    "mask_mt": (MaskConsistencyConfig(conf_thresh=0.34), make_mask_mt_step),
    "ict": (ICTConfig(ict_alpha=0.5, conf_thresh=0.34), make_ict_step),
    "vat_fixed": (VATConfig(vat_radius=0.5, conf_thresh=0.34), make_vat_step),
    "vat_adaptive": (VATConfig(vat_radius=1.0, adaptive_vat_radius=True, cons_weight=0.1,
                               conf_thresh=0.34), make_vat_step),
    "aug_mt": (AugConsConfig(conf_thresh=0.34), make_aug_cons_step),
}


# phase 3: BN running statistics after the first step (its forwards ran on
# equal weights on both devices), relative to max(1, |value|)
STATS_RTOL = 1e-4


def _check_small_run(name: str, runs: dict, n_px: int, steps: int, lr: float) -> None:
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
        note(f"[small] {name} step {i}: cpu {mc} cuda {mg}")
        ok = (math.isclose(mc["sup_loss"], mg["sup_loss"], rel_tol=1e-4)
              and abs(mc["conf_rate"] - mg["conf_rate"]) <= 2 * one_gate + 1e-7
              and math.isclose(mc["cons_loss"], mg["cons_loss"],
                               rel_tol=1e-4 + 4 * one_gate))
        if not ok:
            raise RuntimeError(f"small-model {name} step {i}: GPU and CPU disagree")
    first, last = ({k: (runs["cpu"][1][i][k], runs["cuda"][1][i][k]) for k in runs["cpu"][1][i]}
                   for i in (0, -1))
    worst = max((a - b).abs().max().item() for k, (a, b) in last.items() if "running" not in k)
    stats = [((a - b).abs() / a.abs().clamp_min(1.0)).max().item()
             for k, (a, b) in first.items() if "running" in k]
    worst_stats = max(stats, default=0.0)
    note(f"[small] {name}: max |param cpu - cuda| after {steps} steps: {worst:.3g} "
         f"(bound 2*lr*steps = {2 * lr * steps:.3g}); running statistics after step 1: "
         f"max relative difference {worst_stats:.3g} over {len(stats)} (bound {STATS_RTOL})")
    if worst > 2 * lr * steps + 1e-6 or worst_stats > STATS_RTOL:
        raise RuntimeError(f"small-model {name} states diverge between GPU and CPU")


def _run_tiny(device, sd, make_module, cfg, make_step, nb, draws, masks=None) -> tuple:
    """Steps of a tiny model on ``device``: (metrics per step, every tensor
    of the student's and the teacher's state dicts on the host after each
    step)."""
    model, state, opt = _tiny_state(device, sd, make_module, cfg.mean_teacher)
    step = make_step(model, opt, cfg)
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


def phase_small_step() -> None:
    """Each algorithm's step on the tiny model, GPU against CPU: f32, TF32
    off, two steps with the same injected draws."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, h, w, steps, lr = 2, 33, 33, 2, 3e-4
    sd = _tiny_weights(3)
    for algo, (cfg, make_step) in TINY_ALGOS.items():
        rng = np.random.RandomState(0)
        nb = _tiny_batch(algo, n, h, w, rng)
        draws = [_tiny_draws(algo, n, h, w, rng) for _ in range(steps)]
        runs = {d: _run_tiny(d, sd, _tiny_deeplab2, cfg, make_step, nb, draws)
                for d in ("cpu", "cuda")}
        _check_small_run(algo, runs, n * h * w, steps, lr)


TINY = (1, 1, 1, 1)
# phase 3b: name -> (module, (n, h, w), draws of TINY_ALGOS' algorithm, config,
# step factory); every batch-statistics BN sees 4 or more values per channel
TINY_FAMILIES = {
    "denseunet_cutmix": (lambda: DenseUNet(4, block_config=(2, 2, 2, 2)), (2, 64, 64),
                         "mask_mt", MaskConsistencyConfig(conf_thresh=0.34, freeze_bn=False),
                         make_mask_mt_step),
    "resunet_ict": (lambda: ResUNet(4, layers=TINY), (2, 64, 64), "ict",
                    ICTConfig(ict_alpha=0.5, conf_thresh=0.34, freeze_bn=False), make_ict_step),
    "deeplabv3_vat": (lambda: DeepLabV3(4, layers=TINY), (4, 33, 33), "vat_fixed",
                      VATConfig(vat_radius=0.5, conf_thresh=0.34, freeze_bn=False),
                      make_vat_step),
    "deeplabv3plus_aug_mt": (lambda: DeepLabV3Plus(4, layers=TINY), (4, 41, 41), "aug_mt",
                             AugConsConfig(conf_thresh=0.34, freeze_bn=False),
                             make_aug_cons_step),
    "pspnet_cutmix_pi": (lambda: PSPNet(4, layers=TINY), (4, 50, 50), "mask_mt",
                         MaskConsistencyConfig(conf_thresh=0.34, freeze_bn=False,
                                               mean_teacher=False), make_mask_mt_step),
}


class _HostMasks:
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


def phase_small_step_families() -> None:
    """The other families at tiny depth, GPU against CPU: f32, TF32 off,
    training BN, the same dropout masks and draws, two steps."""
    steps, lr = 2, 3e-4
    masks = _HostMasks()
    draw_keep = Dropout.draw_keep
    Dropout.draw_keep = lambda self, x: masks.draw(self, x)
    try:
        for name, (make_module, (n, h, w), algo, cfg, make_step) in TINY_FAMILIES.items():
            sd = _tiny_weights(4, make_module())
            rng = np.random.RandomState(0)
            nb = _tiny_batch(algo, n, h, w, rng)
            draws = [_tiny_draws(algo, n, h, w, rng) for _ in range(steps)]
            runs = {d: _run_tiny(d, sd, make_module, cfg, make_step, nb, draws, masks)
                    for d in ("cpu", "cuda")}
            if masks.k == 0:
                raise RuntimeError(f"{name}: no dropout mask was drawn")
            _check_small_run(name, runs, n * h * w, steps, lr)
            moved = [k for k, v in runs["cuda"][1][-1].items()
                     if k.startswith("student.") and "running" in k
                     and not torch.equal(v, sd[k[len("student."):]])]
            if not moved:
                raise RuntimeError(f"{name}: training BN left the running statistics as they were")
            note(f"[small] {name}: {len(moved)} running statistics of the student moved; "
                 f"{masks.k} dropout masks per step")
    finally:
        Dropout.draw_keep = draw_keep


# phase 4b: the Pascal recipe's lines of the other algorithms
# (run_pascal_aug_experiments.sh:22-24)
FULL_ALGOS = ("ict", "vat_mt", "aug_mt")


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


def phase_full_step(algorithm: str = "mask_mt") -> dict:
    state, step, batch = make_full_step(algorithm)
    n_params = sum(p.numel() for p in state.student.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w0 = state.student.layer5.conv2d_list[0].weight.detach().clone()

    build.launch_counts.clear()
    t0 = time.perf_counter()
    for _ in range(WARMUP):
        state, m = step(state, batch, 1.0)
        if not all(math.isfinite(v.item()) for v in m.values()):
            raise RuntimeError(f"{algorithm}: non-finite warm-up metrics {m}")
    warm_s = time.perf_counter() - t0
    timed = []
    t0 = time.perf_counter()
    for _ in range(ITERS):
        state, m = step(state, batch, 1.0)
        timed.append(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(build.launch_counts)

    for m in timed:
        if sorted(m) != ["conf_rate", "cons_loss", "sup_loss"] or not all(
                math.isfinite(v.item()) for v in m.values()):
            raise RuntimeError(f"{algorithm}: non-finite or missing metrics {m}")
    # CutMix mask_mt blends with the kernel once per step; the other
    # algorithms never call it
    want = WARMUP + ITERS if algorithm == "mask_mt" else 0
    if launches.get(KERNEL, 0) != want:
        raise RuntimeError(f"{algorithm}: expected {want} {KERNEL} launches, got {launches}")
    if state.step != WARMUP + ITERS or torch.equal(
            w0, state.student.layer5.conv2d_list[0].weight):
        raise RuntimeError(f"{algorithm}: the student did not update")
    with torch.no_grad():
        logits = state.teacher(batch["sup_x"][:2])
    if logits.shape != (2, CROP, CROP, NUM_CLASSES) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"teacher logits {tuple(logits.shape)} not finite/expected")
    ms = dt / ITERS * 1e3
    result = {"ms_per_step": ms, "img_per_s": BATCH * ITERS / dt,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "warmup_s": warm_s, "launches": launches, "params": n_params,
              "last": {k: v.item() for k, v in timed[-1].items()}}
    unsup = 2 * BATCH if algorithm in ("mask_mt", "ict") else BATCH
    tag = "full" if algorithm == "mask_mt" else f"full {algorithm}"
    note(f"[{tag}] R101 bf16 bs {BATCH}+{unsup} {CROP}^2 ({n_params} params): "
         f"{ms:.2f} ms/step, {result['img_per_s']:.2f} img/s, peak "
         f"{result['peak_mem_gib']:.2f} GiB, warm-up {warm_s:.1f} s, launches {launches}, "
         f"last metrics {result['last']}")
    if algorithm == "vat_mt":
        result["eps_probe"] = _vat_eps_probe(state, batch)
    return result


def _vat_eps_probe(state, batch) -> dict:
    """What VAT's noise does at full width in bf16. eps0 is ~1.9e-7 per
    element at 321^2; the model casts its input to bf16 (8 bits of
    mantissa), so x + eps and x give the same bf16 input almost everywhere.
    With x_tea == x_stu (colour jitter off) the power step's gradient is
    then the var loss's gradient at its minimum, 0, and x_adv == x_stu."""
    cfg = VATConfig(vat_radius=1.0, adaptive_vat_radius=True, cons_weight=0.1)
    x = batch["ux_stu"]
    n, h, w, _ = x.shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    eps0 = _normalize_per_sample(torch.randn(x.shape, generator=gen, device="cuda")) \
        * (1.0e-6 * h * w / 1000.0)
    visible = ((x + eps0).bfloat16() != x.bfloat16()).float().mean().item()
    same = adversarial_input(cfg, state.teacher, x, x, eps0)
    jittered = x + 0.05 * torch.randn(x.shape, generator=gen, device="cuda")
    moved = adversarial_input(cfg, state.teacher, jittered, x, eps0)
    out = {"eps_l2_per_sample": eps0.reshape(n, -1).norm(dim=1).mean().item(),
           "eps_abs_mean": eps0.abs().mean().item(),
           "bf16_input_changed_share": visible,
           "x_adv_equals_x_stu_when_x_tea_is_x_stu": bool(torch.equal(same, x)),
           "x_adv_moves_when_x_tea_differs": bool(not torch.equal(moved, x))}
    note(f"[full vat_mt] eps probe: {out}")
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _host_batch(source, mode: str, with_labels: bool, seed: int):
    """One host batch of BATCH images from the port's loader: (geom, batch)."""
    rotate = mode == "crop_rotate_scale"
    geom = GeomConfig.from_cli((CROP, CROP), mode == "crop_scale_hung", 1.5 if rotate else 1.0,
                               20.0 if rotate else 0.0, False, True, False, False)
    if geom.mode != mode:
        raise RuntimeError(f"flags gave geometry {geom.mode}, not {mode}")
    stream = train_stream(HostBatchBuilder(source, geom, with_labels=with_labels, n_threads=4),
                          source.train_ndx, BATCH, seed=seed)
    try:
        return geom, next(stream)
    finally:
        stream.close()


def _augment(geom, batch, params, with_labels, mean, std):
    return augment_batch(batch["canvas"], batch.get("labels"), batch["m"], batch["sizes"],
                         batch["interp"], mean, std, params, (CROP, CROP), with_labels,
                         border=border_for_mode(geom.mode),
                         separable=common.separable_for_geom(geom))


def phase_augment_eval(voc_root: str, dev: str = "cuda") -> dict:
    """The port's augmentation and confusion matrix on ``dev`` against the
    CPU. TF32 is switched on for matrix products meanwhile: the separable
    warp must not take it."""
    source = PascalVOCDataSource(-1, np.random.RandomState(0), None, root=voc_root)
    mean, std = IMAGENET_MEAN, IMAGENET_STD
    colour = ColourJitterConfig()
    worst = {"image": 0.0, "mask": 0.0}
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        for seed, (mode, with_labels) in enumerate(
                [(m, lab) for m in ("crop_rotate_scale", "crop_scale_hung") for lab in (True, False)]):
            geom, host = _host_batch(source, mode, with_labels, seed)
            params = None
            if not with_labels:
                params = sample_colour_params(torch.Generator().manual_seed(seed), BATCH, colour)
            outs = {}
            for d in ("cpu", dev):
                b = common.to_device(host, torch.device(d))
                p = None if params is None else ColourParams(
                    **{f.name: getattr(params, f.name).to(d) for f in dataclasses.fields(params)})
                outs[d] = {k: v.cpu() for k, v in _augment(geom, b, p, with_labels,
                                                           mean, std).items()}
            ref, got = outs["cpu"], outs[dev]
            if sorted(ref) != sorted(got):
                raise RuntimeError(f"augment_batch keys differ: {sorted(ref)} {sorted(got)}")
            errs = {k: (got[k].double() - ref[k].double()).abs().max().item()
                    for k in ref if k != "labels"}
            labels_equal = with_labels and torch.equal(got["labels"], ref["labels"])
            note(f"[aug] {mode} {'labels' if with_labels else 'colour'} interp "
                 f"{sorted(set(host['interp'].tolist()))} {tuple(got['image'].shape)} from "
                 f"{tuple(host['canvas'].shape[1:3])} canvases, {dev} vs cpu: max_abs_err "
                 f"{errs}" + (f", labels bit-equal={labels_equal}" if with_labels else ""))
            if with_labels and not labels_equal:
                raise RuntimeError(f"{mode}: warped labels differ between {dev} and cpu")
            for k, e in errs.items():
                kind = "mask" if k == "mask" else "image"
                worst[kind] = max(worst[kind], e)
                if not e <= (AUG_MASK_ATOL if kind == "mask" else AUG_NORM_ATOL):
                    raise RuntimeError(f"{mode} {k}: {dev} and cpu differ by {e}")
    finally:
        torch.set_float32_matmul_precision(prev)

    # the Pascal recipe's per-iteration work on the card: the copy of one
    # labelled and two unlabelled host batches, then their augmentation
    geom, sup = _host_batch(source, "crop_scale_hung", True, 10)
    _, unsup = _host_batch(source, "crop_scale_hung", False, 11)
    gen = torch.Generator(device=dev).manual_seed(0)
    d = torch.device(dev)
    h2d, aug = [], []
    for _ in range(6):
        _sync(d)
        t0 = time.perf_counter()
        bs = [common.to_device(b, d) for b in (sup, unsup, unsup)]
        _sync(d)
        t1 = time.perf_counter()
        _augment(geom, bs[0], None, True, mean, std)
        for b in bs[1:]:
            _augment(geom, b, sample_colour_params(gen, BATCH, colour), False, mean, std)
        _sync(d)
        h2d.append(t1 - t0)
        aug.append(time.perf_counter() - t1)
    nbytes = sum(v.nbytes for b in (sup, unsup, unsup) for v in b.values())
    h2d_ms, aug_ms = float(np.median(h2d[1:])) * 1e3, float(np.median(aug[1:])) * 1e3
    note(f"[aug] Pascal recipe per iteration on {dev}: copy of 3 host batches "
         f"({nbytes / 1e6:.2f} MB) {h2d_ms:.2f} ms, augmentation (sup + 2 unsup with "
         f"colour) {aug_ms:.2f} ms (median of 5)")

    rng = np.random.RandomState(5)
    truth = rng.randint(0, NUM_CLASSES, size=(BATCH, 512, 512))
    truth[rng.rand(*truth.shape) < 0.2] = 255
    pred = rng.randint(0, NUM_CLASSES, size=truth.shape)
    cm_ref = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(truth), NUM_CLASSES)
    pred_d, truth_d = torch.from_numpy(pred).to(d), torch.from_numpy(truth).to(d)
    cm = confusion_matrix(pred_d, truth_d, NUM_CLASSES)
    equal = torch.equal(cm.cpu(), cm_ref) and int(cm_ref.sum()) == int((truth != 255).sum())
    _sync(d)
    t0 = time.perf_counter()
    for _ in range(10):
        confusion_matrix(pred_d, truth_d, NUM_CLASSES)
    _sync(d)
    cm_ms = (time.perf_counter() - t0) / 10 * 1e3
    note(f"[eval] confusion_matrix {truth.shape} ({truth.size} px) on {dev}: bit-equal to "
         f"cpu={equal}, {cm_ms:.3f} ms")
    if not equal:
        raise RuntimeError(f"confusion_matrix differs between {dev} and cpu")
    return {"aug_max_abs_err": worst, "h2d_ms": h2d_ms, "aug_ms": aug_ms, "cm_ms": cm_ms}


# the Pascal recipe (run_pascal_aug_experiments.sh: PARAMS_PASCALAUG_DEEPLAB2I
# and AUG_PASCAL, at this tree's size) on the synthetic VOC tree
RECIPE_COMMON = [
    "--dataset=pascal", "--arch=resnet101_deeplab_imagenet", "--freeze_bn",
    "--batch_size=10", "--learning_rate=3e-5", "--crop_size=321,321", "--aug_hflip",
    "--aug_scale_hung", "--aug_strong_colour", "--n_sup=20", "--no_pretrained",
    f"--iters_per_epoch={TRAIN_ITERS}",
]
# phase 6: the CutMix line (REG_MASK_CUTMIX)
RECIPE_FLAGS = RECIPE_COMMON + ["--cons_weight=1.0", "--mask_mode=mix",
                                "--mask_prop_range=0.5", "--conf_thresh=0.97", "--save_model"]
# phase 6b: the ICT, VAT and aug_mt lines (REG_ICT01, REG_VAT_ADARAD1_CW01,
# REG_AUG_SEMISUP; run_pascal_aug_experiments.sh:22-24)
RECIPE_ALGOS = {
    "ict": (ict.experiment, ict.train_seg_semisup_ict,
            ["--cons_weight=1.0", "--ict_alpha=0.1", "--conf_thresh=0.97"]),
    "vat_mt": (vat_mt.experiment, vat_mt.train_seg_semisup_vat_mt,
               ["--adaptive_vat_radius", "--vat_radius=1.0", "--cons_weight=0.1",
                "--conf_thresh=0.97"]),
    "aug_mt": (aug_mt.experiment, aug_mt.train_seg_semisup_aug_mt,
               ["--cons_weight=1.0", "--conf_thresh=0.97"]),
}


def _parse_flags(flags, algorithm: str = "mask_mt") -> dict:
    cmd = experiment if algorithm == "mask_mt" else RECIPE_ALGOS[algorithm][0]
    params = dict(cmd.make_context("experiment", list(flags)).params)
    del params["job_desc"]
    return params


def _run_trainer(results: str, flags, device, algorithm: str = "mask_mt",
                 desc: str = "run") -> tuple:
    """Parse ``flags`` with the port's click command of ``algorithm``, then
    run its trainer through job.submit: (engine, kernel launches in the run,
    log text)."""
    fn = train_seg_semisup_mask_mt if algorithm == "mask_mt" else RECIPE_ALGOS[algorithm][1]
    params = _parse_flags(flags, algorithm)
    build.launch_counts.clear()
    engine = job.submit(f"chip_smoke_{algorithm}", desc, fn,
                        dict(params, device=device), results_root=results)
    launches = build.launch_counts.get(KERNEL, 0)
    with open(os.path.join(engine.ctx.run_dir, f"log_{desc}.txt")) as f:
        return engine, launches, f.read()


def _epoch_line(log: str, epoch: int) -> dict:
    lines = [ln for ln in log.splitlines() if ln.startswith(f"Epoch {epoch}:")]
    if len(lines) != 1 or "VAL mIoU=" not in lines[0]:
        raise RuntimeError(f"expected one epoch-{epoch} line with a VAL mIoU, got {lines}")
    vals = {}
    for key in ("TRAIN clf loss", "consistency loss"):
        vals[key] = float(lines[0].split(key + "=")[1].split(",")[0])
    if not all(math.isfinite(v) for v in vals.values()):
        raise RuntimeError(f"non-finite losses: {lines[0]}")
    return vals


def _tensors(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for x in tree for t in _tensors(x)]
    return [tree] if torch.is_tensor(tree) else []


def _states_equal(a: dict, b: dict) -> bool:
    def eq(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(eq(x[k], y[k]) for k in x)
        if isinstance(x, list):
            return len(x) == len(y) and all(eq(u, v) for u, v in zip(x, y))
        if torch.is_tensor(x):
            return torch.equal(x, y)
        return x == y
    return eq(a, b)


def phase_trainer(voc_root: str, step_ms: float, device=None) -> dict:
    """The trainer at full width on the card: 2 epochs, then --resume to 3."""
    tmp = os.path.dirname(voc_root)
    os.environ["CUTMIX_SEG_CONFIG"] = write_config(os.path.join(tmp, "seg.cfg"), voc_root)
    results = os.path.join(tmp, "results")

    engine, launches1, log = _run_trainer(results, RECIPE_FLAGS + ["--num_epochs=2"], device)
    first = {e: _epoch_line(log, e) for e in (1, 2)}
    run_dir = engine.ctx.run_dir
    ckpts = sorted(os.listdir(engine.ctx.checkpoint_dir))
    if ckpts != [f"ckpt_{TRAIN_ITERS:09d}.pt", f"ckpt_{2 * TRAIN_ITERS:09d}.pt"]:
        raise RuntimeError(f"unexpected checkpoints {ckpts}")
    if not os.path.exists(os.path.join(run_dir, "model.pt")):
        raise RuntimeError("model.pt was not written")
    if launches1 != 2 * TRAIN_ITERS:
        raise RuntimeError(f"expected {2 * TRAIN_ITERS} {KERNEL} launches, got {launches1}")

    # the checkpoint restores the saved state bit for bit, into a fresh state
    saved = checkpoint.state_to_host(engine.state)
    model2 = common.build_model(engine.p["arch"], engine.n_classes, engine.p["compute_dtype"])
    state2, _ = create_train_state(model2, OptimizerConfig(learning_rate=3e-5), 1,
                                   device=engine.device, pretrained=False)
    latest = checkpoint.latest_checkpoint(engine.ctx.checkpoint_dir)
    restored = checkpoint.state_to_host(checkpoint.restore_checkpoint(latest, state2))
    if not _states_equal(saved, restored):
        raise RuntimeError(f"the state restored from {latest} differs from the saved one")
    del model2, state2, restored
    t0 = time.perf_counter()
    host = checkpoint.state_to_host(engine.state)
    t1 = time.perf_counter()
    checkpoint.save_checkpoint(os.path.join(tmp, "ckpt_timing"), engine.state, engine.state.step)
    t2 = time.perf_counter()
    ckpt_mb = sum(v.numel() * v.element_size() for v in _tensors(host)) / 1e6
    del host

    with open(os.path.join(run_dir, "metrics_run.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    ep2 = records[1]
    n_eval_batches = -(-VOC_VAL // BATCH)
    ms_iter = ep2["train_time"] / TRAIN_ITERS * 1e3
    result = {
        "ms_per_iter": ms_iter, "img_per_s": TRAIN_ITERS * BATCH / ep2["train_time"],
        "eval_ms_per_batch": ep2["eval_time"] / n_eval_batches * 1e3,
        "epoch_s": [r["epoch_time"] for r in records], "ckpt_host_copy_s": t1 - t0,
        "ckpt_save_s": t2 - t1, "launches": launches1, "losses": first,
    }
    note(f"[trainer] Pascal recipe, {engine.p['arch']} {engine.p['compute_dtype']}, bs {BATCH}, "
         f"{CROP}^2 crops from {engine.ds.canvas_hw} canvases, "
         f"{VOC_TRAIN} train / {VOC_VAL} val synthetic VOC images: epoch lines {first}; "
         f"{launches1} {KERNEL} launches in {2 * TRAIN_ITERS} iterations; "
         f"checkpoints {ckpts} + model.pt; restored state bit-equal to the saved one")
    note(f"[trainer] epoch 2: {ms_iter:.2f} ms/iteration, {result['img_per_s']:.2f} img/s "
         f"(host loader + copy + augmentation + step) beside phase 4's bare step "
         f"{step_ms:.2f} ms/step; eval {result['eval_ms_per_batch']:.1f} ms per val batch of "
         f"{BATCH} ({engine.ds.canvas_hw}); epochs {[round(s, 2) for s in result['epoch_s']]} s; "
         f"checkpoint ({ckpt_mb:.0f} MB: student, teacher, Adam moments): host copy "
         f"{t1 - t0:.2f} s, synchronous save {t2 - t1:.2f} s")

    engine3, launches3, log = _run_trainer(
        results, RECIPE_FLAGS + ["--num_epochs=3", "--resume"], device)
    if engine3.start_epoch != 2 or "Resumed from" not in log:
        raise RuntimeError(f"the resumed run started at epoch {engine3.start_epoch + 1}, not 3")
    result["resumed"] = _epoch_line(log, 3)
    if launches3 != TRAIN_ITERS:
        raise RuntimeError(f"expected {TRAIN_ITERS} {KERNEL} launches on resume, got {launches3}")
    if engine3.state.step != 3 * TRAIN_ITERS:
        raise RuntimeError(f"resumed run ended at step {engine3.state.step}")
    result["launches_resume"] = launches3
    note(f"[trainer] --resume: started at epoch 3, epoch line {result['resumed']}, "
         f"{launches3} {KERNEL} launches in {TRAIN_ITERS} iterations")
    return result


def phase_trainers_algos(voc_root: str, step_ms: dict, device=None) -> dict:
    """The ICT, VAT and aug_mt trainers at full width, one epoch of
    TRAIN_ITERS iterations each with the recipe's lines: an epoch line with
    finite losses and a VAL mIoU, a checkpoint, no CutMix launch."""
    results = os.path.join(os.path.dirname(voc_root), "results")
    out = {}
    for algo, (_, _, reg) in RECIPE_ALGOS.items():
        engine, launches, log = _run_trainer(
            results, RECIPE_COMMON + reg + ["--num_epochs=1"], device, algo)
        line = _epoch_line(log, 1)
        ckpts = sorted(os.listdir(engine.ctx.checkpoint_dir))
        if ckpts != [f"ckpt_{TRAIN_ITERS:09d}.pt"]:
            raise RuntimeError(f"{algo}: unexpected checkpoints {ckpts}")
        if launches != 0:
            raise RuntimeError(f"{algo}: expected no {KERNEL} launch, got {launches}")
        if engine.state.step != TRAIN_ITERS:
            raise RuntimeError(f"{algo}: the run ended at step {engine.state.step}")
        with open(os.path.join(engine.ctx.run_dir, "metrics_run.jsonl")) as f:
            rec = json.loads(f.readline())
        ms_iter = rec["train_time"] / TRAIN_ITERS * 1e3
        out[algo] = {"ms_per_iter": ms_iter, "img_per_s": TRAIN_ITERS * BATCH / rec["train_time"],
                     "eval_ms_per_batch": rec["eval_time"] / -(-VOC_VAL // BATCH) * 1e3,
                     "epoch_s": rec["epoch_time"], "launches": launches, "losses": line,
                     "val_miou": rec["val_miou"]}
        note(f"[trainer {algo}] Pascal recipe line {' '.join(reg)}: epoch 1 {line}, VAL mIoU "
             f"{rec['val_miou']:.4f}; {ms_iter:.2f} ms/iteration ({out[algo]['img_per_s']:.2f} "
             f"img/s, the epoch's first iteration included) beside the bare step "
             f"{step_ms[algo]:.2f} ms/step (phase 4b); eval "
             f"{out[algo]['eval_ms_per_batch']:.1f} ms per val batch; checkpoint {ckpts}; "
             f"{launches} {KERNEL} launches")
        del engine
    return out


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
# phase 4c: name -> (flags, classes)
RECIPE_STEPS = {
    "densenet161unet ISIC": (ISIC_COMMON + ISIC_LINES["cutmix"][1], 2),
    "deeplabv3plus Pascal": (V3PLUS_CUTMIX, NUM_CLASSES),
}
# phase 6c: the synthetic ISIC zip (248^2, the converter's size) and the runs
ISIC_TRAIN, ISIC_VAL, ISIC_ITERS, V3PLUS_ITERS = 60, 10, 4, 5


def _running_stats(net: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in net.named_buffers() if "running" in k}


def make_recipe_step(name: str):
    """A recipe's CutMix line (``RECIPE_STEPS``) as a bare step at full
    width, built as the trainer builds it (its flags, ``build_spec``,
    ``build_model``, the optimiser of its schedule), on random batches made
    on the card: (state, step, batch, parsed flags, step config)."""
    flags, classes = RECIPE_STEPS[name]
    p = _parse_flags(flags)
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


def phase_recipe_step(name: str) -> dict:
    """``make_recipe_step(name)``: 3 warm-up and 10 timed steps."""
    state, step, batch, p, cfg = make_recipe_step(name)
    classes = RECIPE_STEPS[name][1]
    crop = tuple(batch["sup_x"].shape[1:3])
    n_params = sum(t.numel() for t in state.student.parameters())
    stats0 = _running_stats(state.student)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    build.launch_counts.clear()
    t0 = time.perf_counter()
    for _ in range(WARMUP):
        state, m = step(state, batch, 1.0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    timed = []
    t0 = time.perf_counter()
    for _ in range(ITERS):
        state, m = step(state, batch, 1.0)
        timed.append(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(build.launch_counts)

    for m in timed:
        if sorted(m) != ["conf_rate", "cons_loss", "sup_loss"] or not all(
                math.isfinite(v.item()) for v in m.values()):
            raise RuntimeError(f"{name}: non-finite or missing metrics {m}")
    if launches.get(KERNEL, 0) != WARMUP + ITERS:
        raise RuntimeError(f"{name}: expected {WARMUP + ITERS} {KERNEL} launches, got {launches}")
    stats = _running_stats(state.student)
    moved = sum(not torch.equal(v, stats0[k]) for k, v in stats.items())
    finite = all(bool(torch.isfinite(v).all()) for v in stats.values())
    if not finite or moved != (0 if cfg.freeze_bn else len(stats)):
        raise RuntimeError(f"{name}: {moved} of {len(stats)} running statistics moved "
                           f"(finite: {finite}) with freeze_bn={cfg.freeze_bn}")
    with torch.no_grad(), eval_mode(state.teacher):
        logits = state.teacher(batch["sup_x"][:2])
    if logits.shape != (2, *crop, classes) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{name}: teacher logits {tuple(logits.shape)} not finite/expected")
    result = {"ms_per_step": dt / ITERS * 1e3, "img_per_s": BATCH * ITERS / dt,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "warmup_s": warm_s,
              "launches": launches.get(KERNEL, 0), "params": n_params,
              "stats_moved": moved, "stats": len(stats),
              "last": {k: v.item() for k, v in timed[-1].items()}}
    note(f"[recipe step] {name}: {p['arch']} {p['compute_dtype']} bs {BATCH}+{BATCH}+{BATCH} "
         f"{crop[0]}^2, freeze_bn={cfg.freeze_bn}, {p['opt_type']} {p['learning_rate']} "
         f"{p['lr_sched']} ({n_params} params): {result['ms_per_step']:.2f} ms/step, "
         f"{result['img_per_s']:.2f} img/s, peak {result['peak_mem_gib']:.2f} GiB, warm-up "
         f"{warm_s:.1f} s, {result['launches']} {KERNEL} launches, running statistics moved "
         f"{moved}/{len(stats)} and finite, last metrics {result['last']}")
    return result


def _trainer_record(engine, iters: int) -> dict:
    """The timing and VAL mIoU of a run's last epoch (its JSONL record)."""
    with open(engine.ctx.metrics_path) as f:
        rec = json.loads(f.readlines()[-1])
    return {"ms_per_iter": rec["train_time"] / iters * 1e3,
            "img_per_s": iters * BATCH / rec["train_time"], "val_miou": rec["val_miou"],
            "epoch_s": rec["epoch_time"], "eval_s": rec["eval_time"]}


def phase_isic_trainers(tmp: str, voc_root: str) -> dict:
    """The ISIC recipe's seven lines at full width on a synthetic ISIC zip,
    one epoch of ISIC_ITERS iterations each; the CutMix line's checkpoint
    restored bit for bit and resumed for a second epoch; then the v3+
    CutMix line on the synthetic VOC tree."""
    zip_path = write_isic_zip(os.path.join(tmp, "isic2017.zip"), ISIC_TRAIN, ISIC_VAL, seed=0)
    os.environ["CUTMIX_SEG_CONFIG"] = write_config(os.path.join(tmp, "seg_isic.cfg"),
                                                   voc_root, zip_path)
    settings._config = None  # read the new cfg
    results = os.path.join(tmp, "results_isic")
    cuts = ["--no_pretrained", f"--iters_per_epoch={ISIC_ITERS}", "--num_epochs=1"]
    out = {}
    for name, (algo, line) in ISIC_LINES.items():
        flags = ISIC_COMMON + line + cuts
        engine, launches, log = _run_trainer(results, flags, None, algo, desc=name)
        losses = _epoch_line(log, 1)
        ckpts = sorted(os.listdir(engine.ctx.checkpoint_dir))
        want = ISIC_ITERS if name == "cutmix" else 0
        if ckpts != [f"ckpt_{ISIC_ITERS:09d}.pt"] or launches != want:
            raise RuntimeError(f"ISIC {name}: checkpoints {ckpts}, {launches} {KERNEL} "
                               f"launches (expected {want})")
        if engine.p["freeze_bn"] or not engine.p["bin_fill_holes"]:
            raise RuntimeError(f"ISIC {name}: not the recipe's training BN / fill-holes eval")
        for part, net in (("student", engine.state.student), ("teacher", engine.state.teacher)):
            var = [v for k, v in _running_stats(net).items() if k.endswith("running_var")]
            if not all(bool(torch.isfinite(v).all()) and not bool((v == 1).all()) for v in var):
                raise RuntimeError(f"ISIC {name}: a {part} BN's running variance did not move "
                                   "or is not finite")
        out[name] = dict(_trainer_record(engine, ISIC_ITERS), launches=launches, losses=losses)
        note(f"[trainer isic] {name} ({algo}: {' '.join(line)}): epoch 1 {losses}, VAL mIoU "
             f"{out[name]['val_miou']:.4f} (fill-holes eval); {out[name]['ms_per_iter']:.2f} "
             f"ms/iteration ({out[name]['img_per_s']:.2f} img/s, the epoch's first iteration "
             f"included), epoch {out[name]['epoch_s']:.2f} s of which eval "
             f"{out[name]['eval_s']:.2f} s; {launches} {KERNEL} launches; the running "
             "statistics of student and teacher moved")
        if name == "cutmix":
            saved = checkpoint.state_to_host(engine.state)
            model2 = common.build_model(engine.p["arch"], engine.n_classes,
                                        engine.p["compute_dtype"])
            state2, _ = create_train_state(model2, OptimizerConfig(opt_type="sgd"), 1,
                                           pretrained=False)
            latest = checkpoint.latest_checkpoint(engine.ctx.checkpoint_dir)
            restored = checkpoint.state_to_host(checkpoint.restore_checkpoint(latest, state2))
            if not _states_equal(saved, restored):
                raise RuntimeError(f"ISIC cutmix: the state restored from {latest} differs")
            del model2, state2, restored
            engine2, launches2, log2 = _run_trainer(
                results, flags + ["--num_epochs=2", "--resume"], None, algo, desc=name)
            if engine2.start_epoch != 1 or "Resumed from" not in log2 \
                    or engine2.state.step != 2 * ISIC_ITERS or launches2 != ISIC_ITERS:
                raise RuntimeError(f"ISIC cutmix --resume: started at epoch "
                                   f"{engine2.start_epoch + 1}, ended at step "
                                   f"{engine2.state.step}, {launches2} launches")
            out["cutmix_resume"] = {"launches": launches2, "losses": _epoch_line(log2, 2)}
            note(f"[trainer isic] cutmix: the checkpoint restores the saved state bit for bit "
                 f"(BN running statistics and generator included); --resume started at epoch "
                 f"2, epoch line {out['cutmix_resume']['losses']}, {launches2} {KERNEL} launches")
            del engine2
        del engine
        torch.cuda.empty_cache()

    flags = V3PLUS_CUTMIX + ["--n_sup=20", "--no_pretrained",
                             f"--iters_per_epoch={V3PLUS_ITERS}", "--num_epochs=1"]
    engine, launches, log = _run_trainer(results, flags, None, "mask_mt", desc="v3plus_cutmix")
    losses = _epoch_line(log, 1)
    if launches != V3PLUS_ITERS:
        raise RuntimeError(f"v3+ cutmix: expected {V3PLUS_ITERS} {KERNEL} launches, got {launches}")
    out["v3plus_cutmix"] = dict(_trainer_record(engine, V3PLUS_ITERS), launches=launches,
                                losses=losses)
    note(f"[trainer v3+] Pascal v3+ CutMix line on the synthetic VOC tree: epoch 1 {losses}, "
         f"VAL mIoU {out['v3plus_cutmix']['val_miou']:.4f}; "
         f"{out['v3plus_cutmix']['ms_per_iter']:.2f} ms/iteration; {launches} {KERNEL} launches")
    del engine
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_build()
    k = phase_kernel_vs_plain()
    phase_small_step()
    phase_small_step_families()
    full = phase_full_step()
    full_algos = {}
    for algo in FULL_ALGOS:
        torch.cuda.empty_cache()
        full_algos[algo] = phase_full_step(algo)
    note("[full] bare step beside phase 4's mask_mt in this call: " + ", ".join(
        f"{a} {r['ms_per_step']:.2f} ms/step ({r['img_per_s']:.2f} img/s, peak "
        f"{r['peak_mem_gib']:.2f} GiB)"
        for a, r in [("mask_mt", full)] + list(full_algos.items())))
    recipe_steps = {}
    for name in RECIPE_STEPS:
        torch.cuda.empty_cache()
        recipe_steps[name] = phase_recipe_step(name)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        voc_root = write_voc_tree(os.path.join(tmp, "VOC2012"), VOC_TRAIN, VOC_VAL, seed=0)
        phase_augment_eval(voc_root)
        trainer = phase_trainer(voc_root, full["ms_per_step"])
        trainers = phase_trainers_algos(
            voc_root, {a: r["ms_per_step"] for a, r in full_algos.items()})
        isic = phase_isic_trainers(tmp, voc_root)
    kernels = [{
        "name": KERNEL, "route": "cuda",
        "source": "cutmix_seg_tpu_torch/csrc/cutmix_blend.cu",
        "replaces": "cutmix_seg_tpu/ops/pallas_cutmix.py:46",
        "launches": trainer["launches"], "max_abs_err": k["max_abs_err"],
        "launches_by_path": {"step (phase 4)": full["launches"].get(KERNEL, 0),
                             "trainer (phase 6)": trainer["launches"],
                             "trainer --resume (phase 6)": trainer["launches_resume"],
                             **{f"step {a} (phase 4b)": r["launches"].get(KERNEL, 0)
                                for a, r in full_algos.items()},
                             **{f"trainer {a} (phase 6b)": r["launches"]
                                for a, r in trainers.items()},
                             **{f"step {n} (phase 4c)": r["launches"]
                                for n, r in recipe_steps.items()},
                             **{f"trainer ISIC {n} (phase 6c)": r["launches"]
                                for n, r in isic.items() if n != "v3plus_cutmix"},
                             "trainer v3+ cutmix (phase 6c)": isic["v3plus_cutmix"]["launches"]},
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "kernel_us": k["ms"] * 1e3, "plain_us": k["plain_ms"] * 1e3,
        "bound_us": k["bound_ms"] * 1e3, "ms_bf16": k["ms_bf16"],
        "bound_ms_bf16": k["bound_ms_bf16"], "yardstick_gbps": k["yardstick_gbps"],
        "ms_224": k["ms_224"], "plain_ms_224": k["plain_ms_224"],
        "bound_ms_224": k["bound_ms_224"],
    }]
    note(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
