"""Drive the PyTorch/CUDA port (cutmix_seg_tpu_torch) on one NVIDIA GPU:
the timings of the kernel table, and the runs of the paths that no
benchmark cell takes.

    python3 chip_smoke.py        # from the repository root; needs one card

The checks of the kernels and of the steps on the card are the tests
marked ``cuda``, run with ``python -m pytest --noconftest <files> -m cuda``:
tests/test_torch_card_ops.py (the CutMix kernel against its plain version;
augmentation and the confusion matrix against the CPU),
tests/test_torch_bn_train.py (the training-BN kernels against their plain
version, alone and under gloo meshes), tests/test_torch_card_steps.py (the
tiny steps against the CPU, the full-width steps),
tests/test_torch_step_graph.py (the graphed step against the eager one) and
tests/test_torch_deeplab3_spans.py. Phases 2 and 2b check the kernels they
time before timing them, 2b with the BN card tests' own functions.
benchmark/run.py times the lines of its cells; this script times none of
them.

Phases, in order; any failure exits non-zero before the result lines:
  1. build: print the card's name and power limit, compile every kernel under
     cutmix_seg_tpu_torch/csrc/ with nvcc (sm_90a) and time the build;
  2. the CutMix kernel timed with CUDA events at the main-path shape (L2
     flushed before each launch): in f32 and bf16 beside its bounds and
     beside torch.add of the same tensors (a bandwidth yardstick), the plain
     version, the unaligned variant, the timing's floor (one pixel), and the
     same calls after a flush that leaves L2 clean; the kernel and plain
     version at 224^2, at the Cityscapes recipe's 4x256x512x3 and at the
     convergence sweep's 8x64x64x3; before the timings, the timed inputs'
     masks and blends bit-equal to the plain version's;
  2b. the training-BN kernels (csrc/bn_train.cu) at every BN input shape of
     DenseUNet-161 at 10x224^2 (the ISIC recipe): each shape against the
     plain version in bf16 and f32 (``_torch_card.bn_check``), the kernels
     under one and two gloo ranks sharing the card
     (``_torch_ranks.bn_card_check``), then each shape's forward and
     backward device time (CUDA graphs of 20 calls, inputs L2-warm as after
     the conv that wrote them) beside its byte bounds, the plain version's
     and torch's own batch_norm (a yardstick the port never calls) at five
     shapes, and their sum over one iteration's 4 forwards and 2 backwards
     of the 166 BN calls;
  4b. DeepLab v2 R101, bf16, the bench.py recipe at bs 10+10+10, 321x321:
     the ICT, VAT (adaptive radius 1.0, cons_weight 0.1) and aug_mt steps of
     the recipe, 3 warm-up and 10 timed: ms/step, img/s, peak memory; and
     what VAT's noise does in bf16;
  4d. gradient accumulation at full width: the Pascal CutMix line's step
     (DeepLab v2 R101, 10 + 10 + 10 in chunks of 5) and the DenseUNet-161
     ISIC step at grad_accum 2 (their grad_accum 1 lines are the
     pascal-cutmix and isic-cutmix cells'): ms/step, peak memory, launches;
  6. the trainer at full width: train_seg_semisup_mask_mt through job.submit
     with the Pascal recipe on a synthetic VOC tree (40 train and 10 val
     images; R101, random init), 2 epochs x 10 iterations, then --resume to
     epoch 3: epoch lines with finite losses and a VAL mIoU, one kernel
     launch per iteration, a checkpoint and model.pt, the restored state
     equal to the saved one bit for bit, the resumed run starting at epoch
     3; eval ms per val batch and the checkpoint's host copy and save times
     (the line's rate is the pascal-cutmix cell's);
  6b. the ICT, VAT and aug_mt trainers with the recipe's lines on that tree,
     1 epoch x 10 iterations each: an epoch line with finite losses and a VAL
     mIoU, a checkpoint, no kernel launch, ms/iteration;
  6c. on a synthetic ISIC zip, the ISIC recipe's seven lines at full width
     (--no_pretrained, 1 epoch x 4 iterations each, fill-holes eval), the
     CutMix line restored bit for bit (BN buffers and generator included)
     and resumed for a second epoch, its 2,988 training-BN kernel launches
     an iteration (the engine's JSONL line); then the v3+ CutMix line on the
     synthetic VOC tree (1 epoch x 5 iterations);
  6d. the recipes' own datasets (1 epoch x 5 iterations each, eval at the
     end): the Pascal CutMix line with --dataset=pascal_aug and its
     split_0.pkl on the SBD split of the synthetic tree (10,582 names;
     streams from the host under --data_on_device auto, as JAX does); the
     Cityscapes CutMix line at full width (2 epochs, the second timed) on a
     zip that the port's convert_cityscapes made from synthetic 2048x1024
     official zips; the
     ISIC CutMix line's first augmented batch with the store resident
     (auto) and streamed (off): labels bit-equal, images within 1e-5, the
     copy and augmentation times of each, and the off line's ms/iteration;
     the phase-6 Pascal CutMix line with --data_on_device on;
  7. data parallelism and the multi-seed trainer: 7a the phase-6 CutMix line
     (1 epoch x 5 iterations) through job.submit under a process group made
     from torchrun's variables, NCCL at world 1 in this process (world 2,
     one card per rank, where the host has two cards): a finite epoch line
     and a VAL mIoU, one kernel launch per iteration, rank 0's checkpoint,
     ms/iteration; 7b two rank processes sharing the card over gloo (NCCL
     refuses two ranks on one device): the tiny DeepLab v2
     (CutMix, frozen BN) and the tiny ResUNet (CutMix, training BN,
     host-drawn dropout masks) for two steps at 2 + 2, injected global
     rects, against one process on the card over the global batch: the ranks
     bit-identical, within check_small_run's bounds of the one-process run,
     one launch per rank per step; 7c the multi-seed trainer with two seeds on
     that CutMix line (1 epoch x 5 iterations): both seeds' epoch lines and
     the aggregate, 10 kernel launches, each seed's checkpoint, ms/iteration
     and the peak with two states resident;
  8. spatial partitioning (--spatial_train, --eval_spatial at world 2), two
     rank processes sharing the card over gloo: 8a the tiny DeepLab v2's
     CutMix, Cutout, ICT, VAT (adaptive radius) and aug_mt steps and the
     tiny DeepLab v3+'s CutMix step (host-drawn dropout masks) (f32, TF32
     off, 2 steps, 36-row crops whose feature maps split unevenly and whose
     ASPP windows reach past the neighbouring rank) with each image's rows
     split over the ranks, against one process on the same batch: ranks
     bit-identical, within check_small_run's bounds, one launch per rank
     per CutMix step and none on the other steps; 8b the
     Cityscapes CutMix line (phase 6d's flags and converted frames) with
     --spatial_train 2 and --eval_spatial through job.submit, 2 epochs x 3
     iterations: the epoch line, epoch 2's ms/iteration, each rank's peak
     memory beside the same line at world 1 in this process, the launches;
     8c that run's eval net over the val frames at 512x1024, rows split
     over the ranks, against the world-1 eval: the differing pixels (each
     must be a near tie of world 1's logits), the confusion matrices and
     the eval ms;
  9. serving, the model tools and toy2d (no kernel launch on these paths):
     9a tools/export_model on DeepLab v2 R101 (21 classes, bf16, 321^2,
     seeded random weights written as a model.pt), the artifact loaded and
     called at batches 1, 4, 8 and 16 in a fresh process that imports torch
     alone, its labels against the package forward (a flip must be a near
     tie), serve_bench's timings beside the eager serving module's, an f32
     logits artifact at batch 2 (rtol 1e-4, atol 1e-5, TF32 off) and
     DenseUNet-161 at 224^2; 9b tools/evaluate_model on phase 6's model.pt
     and checkpoints (teacher: that run's last eval line exactly; student),
     and the HTTP host on a free port with 9a's artifact (/healthz, one
     /predict equal to 9a's labels); 9c the toy2d step of each model and
     norm at width 512, 3 steps on the CPU and the card in lockstep with
     injected draws, check_small_run's bounds, then
     run_toy2d_experiments.sh's three lines through the port's CLI at 2
     epochs: error, s/epoch, renders;
  10. the convergence sweep and the patch-distance study: 10a
     tools/multi_seed_convergence with all six arms at the tool's widths
     (64x64, batch 8, 6 + 256 + 64 images a seed), 2 seeds x 100 iterations:
     every arm's line and s/arm, the peak, the CutMix kernel's launches per
     arm (one per seed per iteration on the CutMix arm, none elsewhere), the
     CutMix arm's steady ms/iteration (cuDNN's search off, as in the tool's
     own process), and that arm for 3 iterations on the CPU and the card in
     lockstep (f32, TF32 off, injected rects, check_small_run's bounds); 10b
     analysis.patch_dist's distances card against CPU at a
     small size, then a 1024x2048 frame of phase 6d's official zip against
     32 anchors of 225^2 in f32 and in TF32 (ms, peak, the self-match
     distances, how many nearest-neighbour orders TF32 changes, chunking),
     class_distances on 4 converted Cityscapes frames (device and host ms
     apart), and the two studies' statistics (input distribution on those
     frames, colour on the VOC tree);
  11. the rest of spatial partitioning and the native decoder: 11a four
     lines at full width on phase 6d's converted Cityscapes frames (bf16, bs
     4, 256x512 crops, 2 epochs x 2 iterations, eval each epoch): CutMix on
     DeepLab v3+ R101 and the ICT, VAT and aug_mt regularisers on DeepLab v2
     R101, each at world 1 in this process and then with --spatial_train 2
     --eval_spatial over two gloo ranks sharing the card: the epoch lines,
     ms/iteration, each rank's peak memory, the kernel's launches per rank
     (one per iteration on the CutMix line, none on the others) and the
     split eval's val pixels that differ from world 1's (each must be a
     near tie); 11b whether the native PNG/JPEG decoder builds here: if it
     does, bit-equal to PIL on the VOC tree's JPEGs and PNGs; if not, the
     loader's arrays equal PIL's under ``auto`` and
     CUTMIX_SEG_NATIVE_DECODE=1 raises;
  12. spatial partitioning of PSPNet, the ResUNets and DenseUNet, two gloo
     ranks sharing the card: 12a the tiny DenseUNet's CutMix, ResUNet's
     aug_mt and PSPNet's ICT steps (f32, TF32 off, training BN, host-drawn
     dropout masks, 2 steps; the U-Nets at 96 rows, whose average pool and
     nearest upsample straddle the split, PSPNet's pyramid bins on a 5-row
     map) against one process: ranks bit-identical, within
     check_small_run's bounds, one launch per rank per CutMix step and none
     on the others; 12b the ISIC recipe's CutMix line (DenseUNet-161, bs
     10, 224^2, training BN, dropout, SGD 0.1 poly, --bin_fill_holes) on
     phase 6c's synthetic ISIC zip and 12c PSPNet R101 (CutMix) and ResUNet-101
     (aug_mt) on phase 6d's Cityscapes frames (bf16, bs 4, 256x512), each
     2 epochs x 2 iterations at world 1 in this process and then with
     --spatial_train 2 --eval_spatial: as 11a, the epoch lines,
     ms/iteration, each rank's peak beside world 1's, the launches per rank
     and the split eval's differing val pixels (each a near tie);
  13. the kernel summary line and, last, the device line.

Imports nothing of JAX: it runs where only PyTorch and the CUDA toolkit are.
``python3 chip_smoke.py --rank-of <kind> <dir> ...`` is a rank process of
phase 7, 8, 11a or 12, started by the script itself.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import io
import json
import math
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from cutmix_seg_tpu_torch.core import checkpoint, job
from cutmix_seg_tpu_torch.core.train_state import OptimizerConfig, create_train_state
from cutmix_seg_tpu_torch.data import settings
from cutmix_seg_tpu_torch.data.synthetic import (
    SBD_TRAIN_AUG,
    write_cityscapes_zips,
    write_config,
    write_isic_zip,
    write_voc_tree,
)
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig, sample_box_rects_np
from cutmix_seg_tpu_torch.models.common import Dropout, eval_mode, init_weights
from cutmix_seg_tpu_torch.models.deeplab2 import resnet101_deeplab_imagenet
from cutmix_seg_tpu_torch.models.deeplab3 import DeepLabV3Plus
from cutmix_seg_tpu_torch.models.denseunet import DenseUNet
from cutmix_seg_tpu_torch.models.pspnet import PSPNet
from cutmix_seg_tpu_torch.models.resunet import ResUNet
from cutmix_seg_tpu_torch.ops import batchnorm, build
from cutmix_seg_tpu_torch.ops.cutmix import KERNEL, cutmix_blend, cutmix_blend_plain
from cutmix_seg_tpu_torch.ops.iou import confusion_matrix
from cutmix_seg_tpu_torch.eval.evaluator import normalise_eval_batch
from cutmix_seg_tpu_torch.parallel.mesh import (
    data_mesh,
    local_rows,
    maybe_initialize_distributed,
)
from cutmix_seg_tpu_torch.parallel.spatial import gather_h, set_spatial, slice_h
from cutmix_seg_tpu_torch.semisup.ict import ICTConfig, make_ict_step
from cutmix_seg_tpu_torch.semisup.mask_mt import MaskConsistencyConfig, make_mask_mt_step
from cutmix_seg_tpu_torch.semisup.aug_cons import AugConsConfig, make_aug_cons_step
from cutmix_seg_tpu_torch.semisup.vat import (
    VATConfig,
    _normalize_per_sample,
    adversarial_input,
    make_vat_step,
)
from cutmix_seg_tpu_torch.tools import multi_seed_convergence as tconv
from cutmix_seg_tpu_torch.tools.convert_cityscapes import convert_cityscapes
from cutmix_seg_tpu_torch.train import aug_mt, common, ict, vat_mt
from cutmix_seg_tpu_torch.train import multi_seed_mask_mt as mseed
from cutmix_seg_tpu_torch.train.engine import TrainEngine
from cutmix_seg_tpu_torch.train.mask_mt import build_spec, experiment, train_seg_semisup_mask_mt
from tests._torch_card import (
    ACCUM_K,
    ACCUM_STEPS,
    BATCH,
    BN_EPS,
    BN_MOMENTUM,
    CITY_SHAPE,
    CROP,
    DENSENET_BN_LAUNCHES,
    FULL_ALGOS,
    ISIC_COMMON,
    ISIC_LINES,
    ISIC_SHAPE,
    ITERS,
    MAIN_SHAPE,
    NUM_CLASSES,
    RECIPE_COMMON,
    RECIPE_FLAGS,
    STATS_RTOL,
    SWEEP_SHAPE,
    TINY,
    TINY_ALGOS,
    TRAIN_ITERS,
    V3PLUS_CUTMIX,
    WARMUP,
    HostMasks,
    bn_check,
    bn_inputs,
    case_inputs,
    check_small_run,
    densenet_bn_calls,
    make_full_step,
    make_recipe_step,
    parse_flags,
    run_steps,
    run_tiny,
    running_stats,
    tiny_batch,
    tiny_deeplab2,
    tiny_draws,
    tiny_weights,
)
from tests._torch_ranks import bn_card_check

# H100 SXM data sheet: HBM rate and the float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# phase 6: the synthetic VOC tree
VOC_TRAIN, VOC_VAL = 40, 10


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
    """The CutMix kernel's times, and the timed inputs' masks and blends
    bit-equal to the plain version's (every case: tests/test_torch_card_ops.py)."""
    half = dict(prop_range=(0.5, 0.5))
    x0, x1, rects = case_inputs(*MAIN_SHAPE, half, torch.float32, 0)
    b0, b1 = x0.bfloat16(), x1.bfloat16()
    xu0, xu1, _ = case_inputs(*MAIN_SHAPE, half, torch.float32, 0, offset=1)
    xi0, xi1, ri = case_inputs(*ISIC_SHAPE, half, torch.float32, 0)
    xc0, xc1, rc = case_inputs(*CITY_SHAPE, half, torch.float32, 0)
    bc0, bc1 = xc0.bfloat16(), xc1.bfloat16()
    xs0, xs1, rs = case_inputs(*SWEEP_SHAPE, half, torch.float32, 0)
    max_err = 0.0
    for a0, a1, r in ((x0, x1, rects), (b0, b1, rects), (xu0, xu1, rects), (xi0, xi1, ri),
                      (xc0, xc1, rc), (bc0, bc1, rc), (xs0, xs1, rs)):
        outs = zip(cutmix_blend(a0, a1, r), cutmix_blend_plain(a0, a1, r))
        max_err = max([max_err] + [(k.float() - p.float()).abs().max().item() for k, p in outs])
    note(f"[kernel] the timed inputs against the plain version: max_abs_err {max_err}")
    if max_err != 0:
        raise RuntimeError(f"cutmix_blend kernel != plain (max_abs_err {max_err})")
    # timing at the main-path shape (one box), L2 flushed before each launch
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
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

    unaligned_ms = _time_ms(lambda: cutmix_blend(xu0, xu1, rects), flush)
    note(f"[kernel] main path f32, x0/x1 at offset 1 (one-element variant): "
         f"{unaligned_ms * 1e3:.2f} us, {n_bytes / unaligned_ms / 1e6:.1f} GB/s")
    # what this timing gives a call that moves almost nothing
    p0, p1, pr = case_inputs(1, 1, 1, 1, half, torch.float32, 0)
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
    ms_224 = _time_ms(lambda: cutmix_blend(xi0, xi1, ri), flush)
    plain_224 = _time_ms(lambda: cutmix_blend_plain(xi0, xi1, ri), flush)
    bound_224, bytes_224, _ = _bound_ms(xi0, ri)
    note(f"[kernel] ISIC path f32 {ISIC_SHAPE}: kernel {ms_224 * 1e3:.2f} us, bound "
         f"{bound_224 * 1e3:.2f} us ({bytes_224 / 1e6:.2f} MB at 3.35 TB/s; "
         f"{bound_224 / ms_224:.1%} of the bound); plain version {plain_224 * 1e3:.2f} us")
    # the Cityscapes path's shape, f32 and bf16
    ms_city = _time_ms(lambda: cutmix_blend(xc0, xc1, rc), flush)
    ms_city_bf16 = _time_ms(lambda: cutmix_blend(bc0, bc1, rc), flush)
    plain_city = _time_ms(lambda: cutmix_blend_plain(xc0, xc1, rc), flush)
    bound_city, bytes_city, _ = _bound_ms(xc0, rc)
    bound_city_bf16 = _bound_ms(bc0, rc)[0]
    note(f"[kernel] Cityscapes path {CITY_SHAPE}: kernel f32 {ms_city * 1e3:.2f} us, bound "
         f"{bound_city * 1e3:.2f} us ({bytes_city / 1e6:.2f} MB at 3.35 TB/s; "
         f"{bound_city / ms_city:.1%} of the bound); bf16 {ms_city_bf16 * 1e3:.2f} us, bound "
         f"{bound_city_bf16 * 1e3:.2f} us; plain version f32 {plain_city * 1e3:.2f} us")
    # the convergence sweep's shape (phase 10a's CutMix arm)
    ms_sweep = _time_ms(lambda: cutmix_blend(xs0, xs1, rs), flush)
    plain_sweep = _time_ms(lambda: cutmix_blend_plain(xs0, xs1, rs), flush)
    bound_sweep, bytes_sweep, by_sweep = _bound_ms(xs0, rs)
    note(f"[kernel] sweep path f32 {SWEEP_SHAPE}: kernel {ms_sweep * 1e3:.2f} us, bound "
         f"{bound_sweep * 1e3:.2f} us ({bytes_sweep / 1e6:.3f} MB at 3.35 TB/s, {by_sweep}; "
         f"{bound_sweep / ms_sweep:.1%} of the bound); plain version {plain_sweep * 1e3:.2f} us")
    return {"max_abs_err": max_err, "ms": ms["kernel f32"], "plain_ms": plain_ms,
            "ms_sweep": ms_sweep, "plain_ms_sweep": plain_sweep, "bound_ms_sweep": bound_sweep,
            "bound_ms": bound_ms, "bound_by": bound_by, "ms_bf16": ms["kernel bf16"],
            "bound_ms_bf16": bf16_bound_ms, "yardstick_gbps": gbps["torch.add f32"],
            "ms_224": ms_224, "plain_ms_224": plain_224, "bound_ms_224": bound_224,
            "ms_city": ms_city, "ms_city_bf16": ms_city_bf16, "plain_ms_city": plain_city,
            "bound_ms_city": bound_city, "bound_ms_city_bf16": bound_city_bf16}


# phase 2b: the training-BN kernels at DenseUNet-161's BN shapes (the ISIC recipe)
BN_REPS = 20  # calls in a timed graph
# the shapes timed beside the plain version and torch's batch_norm
BN_TIMED_SHAPES = ((10, 64, 224, 224), (10, 96, 112, 112), (10, 336, 56, 56),
                   (10, 2064, 14, 14), (10, 2160, 7, 7))


def _graph_ms(fn, reps: int = BN_REPS, replays: int = 10) -> float:
    """Device ms of one fn() call: fn captured ``reps`` times in one CUDA
    graph (warmed up on a side stream first), the median of ``replays``
    replays over ``reps``. The inputs stay L2-warm where they fit, as after
    the conv that wrote them in a step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    events = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = float(np.median([a.elapsed_time(b) for a, b in events])) / reps
    del graph
    return ms


def _bn_times(fn, shape, relu: bool = True) -> tuple:
    """(forward ms, backward ms) of fn at a bf16 channels-last shape: the
    backward as the forward-and-backward graph less the forward's."""
    x, dy, vectors = bn_inputs(*shape, torch.bfloat16, "channels_last", 0)
    x.requires_grad_(True)
    weight = vectors["weight"].requires_grad_(True)
    bias = vectors["bias"].requires_grad_(True)
    running = (vectors["running_mean"], vectors["running_var"])

    def fwd():
        return fn(x, weight, bias, running, BN_MOMENTUM, BN_EPS, None, relu)

    def both():
        return torch.autograd.grad(fwd(), (x, weight, bias), dy)

    f = _graph_ms(fwd)
    return f, _graph_ms(both) - f


def _library_bn(x, weight, bias, running, momentum, eps, mesh, relu):
    """torch's own training batch_norm, the yardstick (the port never calls it)."""
    y = torch.nn.functional.batch_norm(x, running[0], running[1], weight, bias, True,
                                       1.0 - momentum, eps)
    return torch.relu(y) if relu else y


def _bn_bytes(shape, dtype_bytes: int = 2) -> dict:
    """Bytes of one BN call: each input read and each output written once
    (forward x, y; backward x, dy, dx), and the two-pass design's (x read
    twice forward; x and dy twice backward)."""
    e = math.prod(shape) * dtype_bytes
    return {"fwd": 2 * e, "bwd": 3 * e, "fwd_two_pass": 3 * e, "bwd_two_pass": 5 * e}


def phase_bn_kernels() -> dict:
    """The training-BN kernels against their plain version at every BN
    input shape of DenseUNet-161 and under one and two gloo ranks (the
    checks of tests/test_torch_bn_train.py's card tests), then their times."""
    t0 = time.perf_counter()
    calls = densenet_bn_calls("cuda")
    shapes = collections.Counter((shape, relu) for _, shape, relu, _ in calls)
    n_cl = sum(cl for *_, cl in calls)
    note(f"[bn] DenseUNet-161 bf16 at 10x224^2: {len(calls)} BN calls a forward, "
         f"{len(shapes)} shapes; {n_cl} inputs channels-last, {len(calls) - n_cl} not; "
         f"{sum(r for *_, r, _ in calls)} with the ReLU")
    worst = collections.defaultdict(float)
    for seed, (shape, relu) in enumerate(sorted(shapes)):
        for dtype in (torch.bfloat16, torch.float32):
            for leaf, gap in bn_check(shape, "channels_last", relu, dtype, seed).items():
                key = f"{leaf} {str(dtype)[6:]}"
                worst[key] = max(worst[key], gap)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bn_") as tmp:
        mesh_worst = max(bn_card_check(tmp, world) for world in (1, 2))
    note(f"[bn] kernels against plain at every shape, bf16 and f32, forward and backward: "
         f"two runs bit-equal, one launch of each kernel, worst gap over tolerance (1 = at "
         f"it) { {k: round(v, 4) for k, v in sorted(worst.items())} }; one gloo rank bit for "
         f"bit, two within tolerance (worst gap {mesh_worst:.4f}); "
         f"{time.perf_counter() - t0:.1f} s")
    per_shape = {}
    for shape, _ in sorted({(s, 0) for s, _ in shapes}):
        per_shape[shape] = _bn_times(batchnorm.batch_norm_train, shape)
    fwd_ms = sum(n * per_shape[s][0] for (s, _), n in shapes.items())
    bwd_ms = sum(n * per_shape[s][1] for (s, _), n in shapes.items())
    bounds = [(n, _bn_bytes(s)) for (s, _), n in shapes.items()]
    fwd_bytes = sum(n * b["fwd"] for n, b in bounds)
    bwd_bytes = sum(n * b["bwd"] for n, b in bounds)
    two_pass = sum(n * (4 * b["fwd_two_pass"] + 2 * b["bwd_two_pass"]) for n, b in bounds)
    iteration_ms = 4 * fwd_ms + 2 * bwd_ms
    iteration_bound_ms = (4 * fwd_bytes + 2 * bwd_bytes) / PEAK_BYTES_PER_S * 1e3
    note(f"[bn] one forward of the {len(calls)} calls {fwd_ms:.3f} ms (bound {fwd_bytes / 1e9:.3f} "
         f"GB, {fwd_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms), one backward {bwd_ms:.3f} ms "
         f"(bound {bwd_bytes / 1e9:.3f} GB, {bwd_bytes / PEAK_BYTES_PER_S * 1e3:.3f} ms); "
         f"an iteration's 4 forwards + 2 backwards {iteration_ms:.3f} ms against "
         f"{iteration_bound_ms:.3f} ms ({iteration_bound_ms / iteration_ms:.1%} of the bound; "
         f"the two-pass design's floor {two_pass / 1e9:.3f} GB, "
         f"{two_pass / PEAK_BYTES_PER_S * 1e3:.3f} ms)")
    for shape in sorted(per_shape, key=math.prod, reverse=True)[:6] + sorted(
            per_shape, key=math.prod)[:2]:
        b = _bn_bytes(shape)
        f, bw = per_shape[shape]
        note(f"[bn] {shape}: forward {f * 1e3:.2f} us (bound {b['fwd'] / PEAK_BYTES_PER_S * 1e6:.2f}"
             f" us, {b['fwd'] / PEAK_BYTES_PER_S * 1e3 / f:.1%}), backward {bw * 1e3:.2f} us "
             f"(bound {b['bwd'] / PEAK_BYTES_PER_S * 1e6:.2f} us, "
             f"{b['bwd'] / PEAK_BYTES_PER_S * 1e3 / bw:.1%})")
    timed = {}
    for shape in BN_TIMED_SHAPES:
        timed[shape] = {"kernels": _bn_times(batchnorm.batch_norm_train, shape),
                        "plain": _bn_times(batchnorm.batch_norm_train_plain, shape),
                        "library": _bn_times(_library_bn, shape)}
        note(f"[bn] {shape} forward / backward us: "
             + ", ".join(f"{k} {v[0] * 1e3:.2f} / {v[1] * 1e3:.2f}"
                         for k, v in timed[shape].items()))
    note(f"[bn] phase 2b {time.perf_counter() - t0:.1f} s")
    return {"calls": len(calls), "shapes": len(shapes), "worst": dict(worst),
            "mesh_worst": mesh_worst, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "iteration_ms": iteration_ms,
            "iteration_bound_ms": iteration_bound_ms, "timed": timed}


def phase_full_step(algorithm: str) -> dict:
    """4b: ``algorithm``'s step of the bench.py recipe, WARMUP warm-up and
    ITERS timed (its checks: tests/test_torch_card_steps.py)."""
    state, step, batch = make_full_step(algorithm)
    n_params = sum(p.numel() for p in state.student.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics, launches, warm_s, dt = run_steps(state, step, batch)
    result = {"ms_per_step": dt / ITERS * 1e3, "img_per_s": BATCH * ITERS / dt,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "warmup_s": warm_s, "launches": dict(launches), "params": n_params,
              "last": {k: v.item() for k, v in metrics[-1].items()}}
    unsup = 2 * BATCH if algorithm == "ict" else BATCH
    note(f"[full {algorithm}] R101 bf16 bs {BATCH}+{unsup} {CROP}^2 ({n_params} params): "
         f"{result['ms_per_step']:.2f} ms/step, {result['img_per_s']:.2f} img/s, peak "
         f"{result['peak_mem_gib']:.2f} GiB, warm-up {warm_s:.1f} s, launches {dict(launches)}, "
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
    return parse_flags(flags, experiment if algorithm == "mask_mt" else RECIPE_ALGOS[algorithm][0])


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


def phase_trainer(voc_root: str, device=None) -> dict:
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
    n_eval_batches = -(-VOC_VAL // BATCH)
    result = {
        "eval_ms_per_batch": records[1]["eval_time"] / n_eval_batches * 1e3,
        "ckpt_host_copy_s": t1 - t0, "ckpt_save_s": t2 - t1, "launches": launches1,
        "losses": first, "run_dir": run_dir,
    }
    note(f"[trainer] Pascal recipe, {engine.p['arch']} {engine.p['compute_dtype']}, bs {BATCH}, "
         f"{CROP}^2 crops from {engine.ds.canvas_hw} canvases, "
         f"{VOC_TRAIN} train / {VOC_VAL} val synthetic VOC images: epoch lines {first}; "
         f"{launches1} {KERNEL} launches in {2 * TRAIN_ITERS} iterations "
         f"(step graph {engine.step_counters()}); "
         f"checkpoints {ckpts} + model.pt; restored state bit-equal to the saved one")
    # the line's rate is the pascal-cutmix cell's (benchmark/run.py)
    note(f"[trainer] epoch 2: eval {result['eval_ms_per_batch']:.1f} ms per val batch of "
         f"{BATCH} ({engine.ds.canvas_hw}); checkpoint ({ckpt_mb:.0f} MB: student, teacher, "
         f"Adam moments): host copy "
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
         f"{launches3} {KERNEL} launches in {TRAIN_ITERS} iterations "
         f"(step graph {engine3.step_counters()})")
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


# 4d: the DenseUNet step's warm-up and timed steps (each ~0.6 s)
DENSE_WARMUP, DENSE_ITERS = 2, 5


def phase_accum_step(name: str, accum_k: int, warmup: int, iters: int) -> dict:
    """4d: ``make_recipe_step(name)`` at grad_accum ``accum_k``, ``warmup``
    warm-up and ``iters`` timed steps (its checks:
    tests/test_torch_card_steps.py)."""
    state, step, batch, p, cfg = make_recipe_step(name, [f"--grad_accum={accum_k}"])
    crop = tuple(batch["sup_x"].shape[1:3])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, metrics, launches, warm_s, dt = run_steps(state, step, batch, warmup, iters)
    result = {"ms_per_step": dt / iters * 1e3, "img_per_s": BATCH * iters / dt,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "warmup_s": warm_s,
              "launches": launches[KERNEL],
              "bn_launches": sum(launches[k] for k in batchnorm.KERNELS),
              "grad_accum": cfg.grad_accum, "last": {k: v.item() for k, v in metrics[-1].items()}}
    note(f"[accum step] {name}: {p['arch']} {p['compute_dtype']} bs {BATCH}+{BATCH}+{BATCH} "
         f"{crop[0]}x{crop[1]}, grad_accum {cfg.grad_accum}, freeze_bn={cfg.freeze_bn}, "
         f"{p['opt_type']} {p['learning_rate']} {p['lr_sched']}: {warmup} warm-up + {iters} "
         f"timed: {result['ms_per_step']:.2f} ms/step, {result['img_per_s']:.2f} img/s, peak "
         f"{result['peak_mem_gib']:.2f} GiB, warm-up {warm_s:.1f} s, {result['launches']} "
         f"{KERNEL} launches, {result['bn_launches']} BN kernel launches, last metrics "
         f"{result['last']}")
    return result


# phase 6c: the synthetic ISIC zip (248^2, the converter's size) and the runs
ISIC_TRAIN, ISIC_VAL, ISIC_ITERS, V3PLUS_ITERS = 60, 10, 4, 5


def _trainer_record(engine, iters: int, timed: bool = True) -> dict:
    """The VAL mIoU and training-BN kernel launches of a run's last epoch
    (its JSONL record) and, where
    ``timed``, its timing: a line that a benchmark cell runs is timed there
    (benchmark/run.py), not here."""
    with open(engine.ctx.metrics_path) as f:
        rec = json.loads(f.readlines()[-1])
    out = {"val_miou": rec["val_miou"], "bn_launches": rec["bn_launches"]}
    if not timed:
        return out
    return dict(out, ms_per_iter=rec["train_time"] / iters * 1e3,
                img_per_s=iters * BATCH / rec["train_time"], epoch_s=rec["epoch_time"],
                eval_s=rec["eval_time"])




def phase_isic_trainers(tmp: str, voc_root: str, zip_path: str) -> dict:
    """The ISIC recipe's seven lines at full width on the synthetic ISIC zip
    ``zip_path``, one epoch of ISIC_ITERS iterations each, the store
    resident (--data_on_device auto stages the zip's 60 canvases); the
    CutMix line's checkpoint restored bit for bit and resumed for a second
    epoch; then the v3+ CutMix line on the synthetic VOC tree."""
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
        if engine.resident is None or "Data on device:" not in log:
            raise RuntimeError(f"ISIC {name}: --data_on_device auto did not stage the store")
        for part, net in (("student", engine.state.student), ("teacher", engine.state.teacher)):
            var = [v for k, v in running_stats(net).items() if k.endswith("running_var")]
            if not all(bool(torch.isfinite(v).all()) and not bool((v == 1).all()) for v in var):
                raise RuntimeError(f"ISIC {name}: a {part} BN's running variance did not move "
                                   "or is not finite")
        # the CutMix line is the isic-cutmix cell's
        rec = _trainer_record(engine, ISIC_ITERS, timed=name != "cutmix")
        if name == "cutmix" and rec["bn_launches"] != DENSENET_BN_LAUNCHES * ISIC_ITERS:
            raise RuntimeError(f"ISIC cutmix: {rec['bn_launches']} training-BN kernel launches, "
                               f"expected {DENSENET_BN_LAUNCHES} an iteration")
        out[name] = dict(rec, launches=launches, losses=losses)
        timing = "" if name == "cutmix" else (
            f"; {rec['ms_per_iter']:.2f} ms/iteration ({rec['img_per_s']:.2f} img/s, the "
            f"epoch's first iteration included), epoch {rec['epoch_s']:.2f} s of which eval "
            f"{rec['eval_s']:.2f} s")
        note(f"[trainer isic] {name} ({algo}: {' '.join(line)}): epoch 1 {losses}, VAL mIoU "
             f"{rec['val_miou']:.4f} (fill-holes eval){timing}; {launches} {KERNEL} launches, "
             f"{rec['bn_launches']} training-BN kernel launches; the running statistics of "
             "student and teacher moved")
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
            out["cutmix_resume"] = {"launches": launches2, "losses": _epoch_line(log2, 2),
                                    "bn_launches": _trainer_record(engine2, ISIC_ITERS,
                                                                   False)["bn_launches"]}
            note(f"[trainer isic] cutmix: the checkpoint restores the saved state bit for bit "
                 f"(BN running statistics and generator included); --resume started at epoch "
                 f"2, epoch line {out['cutmix_resume']['losses']}, {launches2} {KERNEL} launches "
                 f"(step graph {engine2.step_counters()})")
            del engine2
        del engine
        torch.cuda.empty_cache()

    flags = V3PLUS_CUTMIX + ["--n_sup=20", "--no_pretrained",
                             f"--iters_per_epoch={V3PLUS_ITERS}", "--num_epochs=1"]
    engine, launches, log = _run_trainer(results, flags, None, "mask_mt", desc="v3plus_cutmix")
    losses = _epoch_line(log, 1)
    if launches != V3PLUS_ITERS:
        raise RuntimeError(f"v3+ cutmix: expected {V3PLUS_ITERS} {KERNEL} launches, got {launches}")
    # the line is the pascal-deeplab3plus-cutmix cell's
    out["v3plus_cutmix"] = dict(_trainer_record(engine, V3PLUS_ITERS, timed=False),
                                launches=launches, losses=losses)
    note(f"[trainer v3+] Pascal v3+ CutMix line on the synthetic VOC tree: epoch 1 {losses}, "
         f"VAL mIoU {out['v3plus_cutmix']['val_miou']:.4f}; {launches} {KERNEL} launches")
    del engine
    torch.cuda.empty_cache()
    return out


# phase 6d: the Pascal CutMix line as the recipe passes its dataset
# (run_pascal_aug_experiments.sh: PARAMS_PASCALAUG_DEEPLAB2I), on the SBD
# split of the synthetic tree
SPLIT_0 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "data", "splits", "pascal_aug", "split_0.pkl")
RECIPE_ITERS = 5
PASCAL_AUG_CUTMIX = RECIPE_FLAGS + ["--dataset=pascal_aug", f"--split_path={SPLIT_0}",
                                    "--n_sup=100", f"--iters_per_epoch={RECIPE_ITERS}",
                                    "--num_epochs=1"]
# phase 6d: a CutMix line of run_cityscapes_experiments.sh
# (PARAMS_CITYSCAPES_DEEPLAB2I, AUG_CITYSCAPES, REG_MASK_CUTMIX), its own
# flags bar --n_sup and the epoch sizes, on CITY_TRAIN + CITY_VAL synthetic
# 2048x1024 frames converted as the recipe's data is (downsample 2)
CITY_TRAIN, CITY_VAL = 16, 4
CITYSCAPES_CUTMIX = [
    "--dataset=cityscapes", "--arch=resnet101_deeplab_imagenet", "--freeze_bn",
    "--batch_size=4", "--learning_rate=3e-5", "--crop_size=256,512", "--aug_hflip",
    "--aug_strong_colour", "--cons_weight=1.0", "--mask_mode=mix", "--mask_prop_range=0.5",
    "--conf_thresh=0.97", "--n_sup=8", "--no_pretrained", f"--iters_per_epoch={RECIPE_ITERS}",
    "--num_epochs=2",
]
# phase 6d: iterations of the store's copy / augmentation timing
STORE_ITERS = 5


def _checked_run(results: str, flags, desc: str, iters: int, classes: int, epochs: int = 1,
                 timed: bool = True):
    """A CutMix line through the trainer: ``epochs`` epochs of ``iters``
    iterations with eval, one kernel launch per iteration; the last epoch's
    record (``_trainer_record``), the run's engine and its log."""
    engine, launches, log = _run_trainer(results, flags, None, desc=desc)
    losses = _epoch_line(log, epochs)
    n = epochs * iters
    if launches != n or engine.state.step != n or engine.n_classes != classes:
        raise RuntimeError(f"{desc}: {launches} {KERNEL} launches, step {engine.state.step}, "
                           f"{engine.n_classes} classes (expected {n}, {n}, {classes})")
    out = dict(_trainer_record(engine, iters, timed), launches=launches, losses=losses,
               resident="Data on device:" in log)
    return out, engine, log


def _store_batches(flags, mode: str, run_dir: str) -> dict:
    """The trainer's first STORE_ITERS iterations' batches with
    --data_on_device ``mode``, built but not stepped: the first augmented
    batch, and the median times (from the second iteration on) of the copy
    to the card of what an iteration ships and of the augmentation (with
    the store's gather)."""
    p = _parse_flags(list(flags) + [f"--data_on_device={mode}"])
    spec, cfg = build_spec(p)
    engine = TrainEngine(job.RunContext(run_dir, mode), spec, cfg, p)
    if not engine.setup():
        raise RuntimeError(f"the trainer's setup failed with --data_on_device {mode}")
    engine._open_epoch_streams(0)
    copy_s, aug_s, first = [], [], None
    try:
        for _ in range(STORE_ITERS):
            host = {"sup": next(engine.sup_stream), **engine.spec.fetch(engine, engine.streams)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raw = {k: common.to_device(v, engine.device) for k, v in host.items()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            batch = engine.make_batch(raw)
            torch.cuda.synchronize()
            copy_s.append(t1 - t0)
            aug_s.append(time.perf_counter() - t1)
            first = first or {k: v.cpu() for k, v in batch.items()}
    finally:
        engine.close_streams()
    nbytes = sum(v.nbytes for part in host.values() for v in part.values())
    return {"batch": first, "resident": engine.resident is not None, "shipped_mb": nbytes / 1e6,
            "copy_ms": float(np.median(copy_s[1:])) * 1e3,
            "augment_ms": float(np.median(aug_s[1:])) * 1e3}


def phase_recipe_datasets(tmp: str, voc_root: str, isic_zip: str) -> dict:
    """Phase 6d: the CutMix trainer on the recipes' own datasets, and the
    device-resident store against streaming."""
    out = {}
    t0 = time.perf_counter()
    x_zip, y_zip = write_cityscapes_zips(tmp, CITY_TRAIN, CITY_VAL, size=(1024, 2048), seed=0)
    t1 = time.perf_counter()
    city_zip = os.path.join(tmp, "cityscapes.zip")
    convert_cityscapes(x_zip, y_zip, city_zip, 2, progress=False)
    t2 = time.perf_counter()
    note(f"[recipes] Cityscapes: {CITY_TRAIN} + {CITY_VAL} synthetic 2048x1024 frames: official "
         f"zips written in {t1 - t0:.2f} s, converted (downsample 2) in {t2 - t1:.2f} s")
    os.environ["CUTMIX_SEG_CONFIG"] = write_config(
        os.path.join(tmp, "seg_recipes.cfg"), voc_root, isic_zip, cityscapes_zip=city_zip)
    settings._config = None
    results = os.path.join(tmp, "results_recipes")

    # the pascal-cutmix cell's line
    rec, engine, log = _checked_run(results, PASCAL_AUG_CUTMIX, "pascal_aug_cutmix",
                                    RECIPE_ITERS, NUM_CLASSES, timed=False)
    if rec["resident"] or f"len(unsup_ndx)={SBD_TRAIN_AUG}" not in log \
            or f"len(val_ndx)={VOC_VAL}" not in log:
        raise RuntimeError("pascal_aug: not the SBD split streamed from the host")
    out["pascal_aug"] = rec
    note(f"[recipes] Pascal CutMix line with --dataset=pascal_aug --split_path=split_0.pkl "
         f"--n_sup=100 ({SBD_TRAIN_AUG} train_aug names, {VOC_VAL} val; streamed, as "
         f"--data_on_device auto decides at {SBD_TRAIN_AUG} x 1,048,584 B): epoch 1 "
         f"{rec['losses']}, VAL mIoU {rec['val_miou']:.4f}; {rec['launches']} {KERNEL} launches")
    del engine
    torch.cuda.empty_cache()

    # two epochs: the first pays cuDNN's choice of algorithms for the new
    # shapes, the second is timed
    rec, engine, log = _checked_run(results, CITYSCAPES_CUTMIX, "cityscapes_cutmix",
                                    RECIPE_ITERS, 19, epochs=2)
    img = engine.ds.get_image(int(engine.sup_ndx[0]))
    if img.shape != (512, 1024, 3) or engine.ds.canvas_hw != (512, 1024):
        raise RuntimeError(f"Cityscapes: image {img.shape}, canvas {engine.ds.canvas_hw}")
    out["cityscapes"] = dict(rec, write_s=t1 - t0, convert_s=t2 - t1)
    note(f"[recipes] Cityscapes CutMix line (R101, frozen BN, bs 4, 256x512 crops of 1024x512 "
         f"images, 19 classes; store resident: {rec['resident']}): epoch 2 {rec['losses']}, "
         f"VAL mIoU {rec['val_miou']:.4f} over {CITY_VAL} val images; epoch 2 "
         f"{rec['ms_per_iter']:.2f} ms/iteration, eval {rec['eval_s']:.2f} s; {rec['launches']} "
         f"{KERNEL} launches in {2 * RECIPE_ITERS} iterations")
    del engine
    torch.cuda.empty_cache()

    # the ISIC CutMix line: the store (auto stages it) against streaming
    isic_flags = ISIC_COMMON + ISIC_LINES["cutmix"][1] + [
        "--no_pretrained", f"--iters_per_epoch={ISIC_ITERS}", "--num_epochs=1"]
    store = {mode: _store_batches(isic_flags, mode, os.path.join(tmp, f"store_{mode}"))
             for mode in ("auto", "off")}
    if not store["auto"]["resident"] or store["off"]["resident"]:
        raise RuntimeError("ISIC: auto did not stage the store, or off did")
    on, off = store["auto"]["batch"], store["off"]["batch"]
    if sorted(on) != sorted(off) or not torch.equal(on["sup_y"], off["sup_y"]):
        raise RuntimeError("ISIC: the resident batch's labels differ from the streamed ones")
    img_err = max((on[k] - off[k]).abs().max().item() for k in on if k != "sup_y")
    if not img_err <= 1e-5:
        raise RuntimeError(f"ISIC: resident and streamed images differ by {img_err}")
    torch.cuda.empty_cache()
    rec_off, engine, _ = _checked_run(results, isic_flags + ["--data_on_device=off"],
                                      "isic_cutmix_off", ISIC_ITERS, 2)
    del engine
    torch.cuda.empty_cache()
    out["isic_store"] = {"auto": {k: v for k, v in store["auto"].items() if k != "batch"},
                         "off": {k: v for k, v in store["off"].items() if k != "batch"},
                         "max_abs_err_images": img_err, "off_run": rec_off}
    note(f"[recipes] ISIC CutMix line, first augmented batch resident (auto) vs streamed (off): "
         f"labels bit-equal, images max_abs_err {img_err:.3g}; per iteration shipped "
         f"{store['auto']['shipped_mb']:.4f} MB vs {store['off']['shipped_mb']:.2f} MB, copy "
         f"{store['auto']['copy_ms']:.3f} ms vs {store['off']['copy_ms']:.3f} ms, augmentation "
         f"(with the gather) {store['auto']['augment_ms']:.2f} ms vs "
         f"{store['off']['augment_ms']:.2f} ms (medians of {STORE_ITERS - 1}); trainer "
         f"{rec_off['ms_per_iter']:.2f} ms/iteration streamed ({ISIC_ITERS} iterations, the "
         f"first included)")

    # the phase-6 Pascal CutMix line with the store on: the pascal-cutmix-resident cell's
    rec, engine, log = _checked_run(
        results, RECIPE_FLAGS + ["--data_on_device=on", f"--iters_per_epoch={RECIPE_ITERS}",
                                 "--num_epochs=1"], "voc_cutmix_on", RECIPE_ITERS, NUM_CLASSES,
        timed=False)
    if f"Data on device: {VOC_TRAIN} canvases" not in log:
        raise RuntimeError("VOC --data_on_device on: the store was not staged")
    out["voc_on"] = rec
    note(f"[recipes] Pascal CutMix line on the VOC tree with --data_on_device on "
         f"({VOC_TRAIN} canvases staged): epoch 1 {rec['losses']}; {rec['launches']} {KERNEL} "
         f"launches")
    del engine
    torch.cuda.empty_cache()
    return out


# phase 7: data parallelism and the multi-seed trainer
DDP_ITERS = 5  # 7a, 7c: 1 epoch of the Pascal CutMix line
DDP_FLAGS = RECIPE_FLAGS + [f"--iters_per_epoch={DDP_ITERS}", "--num_epochs=1"]
MSEED_SEEDS = "12345,23456"
# 7b: name -> (module, (global n, h, w), config); the global batch of 4 is
# 2 + 2 on the two ranks, every batch-statistics BN sees 8 or more values
# per channel on a rank
DDP_CASES = {
    "deeplab2 cutmix frozen BN": (tiny_deeplab2, (4, 33, 33),
                                  MaskConsistencyConfig(conf_thresh=0.34)),
    "resunet cutmix training BN + dropout": (lambda: ResUNet(4, layers=TINY), (4, 64, 64),
                                             MaskConsistencyConfig(conf_thresh=0.34,
                                                                   freeze_bn=False)),
}
DDP_STEPS = 2


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _spawn_ranks(kind: str, world: int, out_dir: str, timeout: float) -> list:
    """``world`` processes of this script, rank r running ``kind`` with
    torchrun's variables; each rank's result (torch.save'd). A rank that
    fails or outlives ``timeout`` fails the phase; every rank is stopped."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, **_rank_env(r, world, port))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-of", kind, out_dir],
            env=env))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"{kind}: rank exit codes {codes}")
    return [torch.load(os.path.join(out_dir, f"{kind}_{r}.pt"), weights_only=False)
            for r in range(world)]


def _ddp_trainer_rank(results: str) -> dict:
    """One rank of 7a: the CutMix line through job.submit under the group
    that torchrun's variables describe (NCCL, one card per rank)."""
    engine, launches, log = _run_trainer(results, DDP_FLAGS, None, desc="ddp")
    out = {"launches": launches, "world": dist.get_world_size(), "backend": dist.get_backend(),
           "rank": dist.get_rank(), "step": engine.state.step}
    dist.destroy_process_group()
    return dict(out, log=log, run_dir=engine.ctx.run_dir)


def phase_ddp_trainer(voc_root: str) -> dict:
    """7a: the Pascal CutMix line under a process group: NCCL at world 1 in
    this process (world 2, one card per rank, where there are two cards)."""
    results = os.path.join(os.path.dirname(voc_root), "results_ddp")
    world = 2 if torch.cuda.device_count() >= 2 else 1
    if world == 1:
        os.environ.update(_rank_env(0, 1, _free_port()))
        try:
            rec = _ddp_trainer_rank(results)
        finally:
            for k in _rank_env(0, 1, 0):
                os.environ.pop(k, None)
    else:
        os.makedirs(results, exist_ok=True)
        rec = _spawn_ranks("ddp_trainer", world, results, 600)[0]
    if rec["world"] != world or rec["backend"] != "nccl":
        raise RuntimeError(f"7a: world {rec['world']} over {rec['backend']}, expected {world} nccl")
    losses = _epoch_line(rec["log"], 1)
    ckpts = sorted(os.listdir(os.path.join(rec["run_dir"], "checkpoints")))
    if ckpts != [f"ckpt_{DDP_ITERS:09d}.pt"] or rec["step"] != DDP_ITERS:
        raise RuntimeError(f"7a: rank 0 wrote checkpoints {ckpts}, step {rec['step']}")
    if rec["launches"] != DDP_ITERS:
        raise RuntimeError(f"7a: expected {DDP_ITERS} {KERNEL} launches, got {rec['launches']}")
    with open(os.path.join(rec["run_dir"], "metrics_ddp.jsonl")) as f:
        r = json.loads(f.readline())
    out = {"world": world, "launches": rec["launches"], "losses": losses,
           "ms_per_iter": r["train_time"] / DDP_ITERS * 1e3, "val_miou": r["val_miou"],
           "img_per_s": r["images_per_sec"]}
    note(f"[ddp] 7a: Pascal CutMix line under a {world}-rank NCCL group (global batch "
         f"{BATCH * world}): epoch 1 {losses}, VAL mIoU {r['val_miou']:.4f}; "
         f"{out['ms_per_iter']:.2f} ms/iteration over {DDP_ITERS} (the first included); "
         f"{rec['launches']} {KERNEL} launches; rank 0's checkpoint {ckpts}")
    return out


class _GlobalHostMasks(HostMasks):
    """Dropout keep masks by call order for the global batch (call k from
    seed 500 + k), each rank taking its data index's rows (under spatial
    partitioning the port asks for the full maps' masks and keeps its
    rows)."""

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh

    def draw(self, drop: Dropout, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        rows = n * (1 if self.mesh is None else self.mesh.n_data)
        keep = np.random.RandomState(500 + self.k).rand(rows, h, w, c) < 1.0 - drop.rate
        self.k += 1
        return torch.from_numpy(local_rows(keep, self.mesh)).to(x.device).permute(0, 3, 1, 2)


def _ddp_inputs(name: str):
    make_module, (n, h, w), cfg = DDP_CASES[name]
    rng = np.random.RandomState(7)
    nb = tiny_batch("mask_mt", n, h, w, rng)
    draws = [tiny_draws("mask_mt", n, h, w, rng) for _ in range(DDP_STEPS)]
    return make_module, cfg, tiny_weights(6, make_module()), nb, draws


def _ddp_case(name: str, mesh) -> tuple:
    """A 7b case on cuda:0 over ``mesh``'s rows of the global batch (None:
    the whole batch in one process): _run_tiny's (metrics, tensors)."""
    make_module, cfg, sd, nb, draws = _ddp_inputs(name)
    masks = _GlobalHostMasks(mesh)
    draw_keep = Dropout.draw_keep
    Dropout.draw_keep = lambda self, x: masks.draw(self, x)
    try:
        local = {k: local_rows(v, mesh) for k, v in nb.items()}
        make = lambda model, opt, c: make_mask_mt_step(model, opt, c, mesh)  # noqa: E731
        return run_tiny("cuda", sd, make_module, cfg, make, local, draws, masks)
    finally:
        Dropout.draw_keep = draw_keep


def _ddp_steps_rank() -> dict:
    """One rank of 7b: gloo on the one card (NCCL refuses two ranks on one
    device; gloo all-reduces CUDA tensors through the host)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed("cuda:0", backend="gloo")
    try:
        mesh = data_mesh()
        build.launch_counts.clear()
        runs = {name: _ddp_case(name, mesh) for name in DDP_CASES}
        return {"runs": runs, "launches": build.launch_counts.get(KERNEL, 0),
                "backend": dist.get_backend(), "world": mesh.size}
    finally:
        dist.destroy_process_group()


def phase_ddp_steps(tmp: str) -> dict:
    """7b: the tiny steps over two ranks sharing the card, against one
    process on the card over the same global batch (f32, TF32 off in every
    process)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ranks = _spawn_ranks("ddp_steps", 2, tmp, 600)
    t_ranks = time.perf_counter() - t0
    if any(r["backend"] != "gloo" or r["world"] != 2 for r in ranks):
        raise RuntimeError("7b: the ranks did not run as two gloo ranks")
    for name in DDP_CASES:
        (m0, t0_), (m1, t1_) = ranks[0]["runs"][name], ranks[1]["runs"][name]
        if m0 != m1 or not all(torch.equal(a[k], b[k]) for a, b in zip(t0_, t1_) for k in a):
            raise RuntimeError(f"7b {name}: the ranks' states differ")
        one = _ddp_case(name, None)
        _, (n, h, w), _ = DDP_CASES[name]
        check_small_run(f"2 ranks gloo {name}", {"cpu": one, "cuda": ranks[0]["runs"][name]},
                         n * h * w, DDP_STEPS, 3e-4, labels=("one process", "2 ranks"))
    launches = sum(r["launches"] for r in ranks)
    want = 2 * len(DDP_CASES) * DDP_STEPS
    if launches != want:
        raise RuntimeError(f"7b: expected {want} {KERNEL} launches over the ranks, got {launches}")
    note(f"[ddp] 7b: {sorted(DDP_CASES)} at 2 + 2 over two gloo ranks on one card: ranks "
         f"bit-identical after each of {DDP_STEPS} steps, within check_small_run's bounds of one "
         f"process; {launches} {KERNEL} launches (one per rank per step); the ranks took "
         f"{t_ranks:.1f} s with their start-up")
    return {"launches": launches, "ranks_s": t_ranks}


def phase_multi_seed(voc_root: str) -> dict:
    """7c: the multi-seed trainer with two seeds on the Pascal CutMix line."""
    results = os.path.join(os.path.dirname(voc_root), "results_mseed")
    params = dict(mseed.experiment.make_context(
        "experiment", DDP_FLAGS + [f"--parallel_split_seeds={MSEED_SEEDS}"]).params)
    del params["job_desc"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.launch_counts.clear()
    states = job.submit("chip_smoke_mseed", "run", mseed.train_seg_semisup_mask_mt_multiseed,
                        params, results_root=results)
    launches = build.launch_counts.get(KERNEL, 0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    run_dir = os.path.join(results, "chip_smoke_mseed", "run")
    with open(os.path.join(run_dir, "log_run.txt")) as f:
        log = f.read()
    seeds = MSEED_SEEDS.split(",")
    lines = [ln for ln in log.splitlines() if ln.startswith("Epoch 1 [seed ")]
    took = []
    for s, ln in zip(seeds, lines):
        if not ln.startswith(f"Epoch 1 [seed {s}]:") or "VAL mIoU=" not in ln:
            raise RuntimeError(f"7c: unexpected epoch line {ln}")
        if not all(math.isfinite(float(ln.split(key + "=")[1].split(",")[0]))
                   for key in ("TRAIN clf loss", "consistency loss")):
            raise RuntimeError(f"7c: non-finite losses {ln}")
        took.append(float(ln.split("took ")[1].split("s,")[0]))
    agg = [ln for ln in log.splitlines() if ln.startswith(f"SEEDS AGGREGATE ({MSEED_SEEDS})")]
    if len(lines) != len(seeds) or len(agg) != 1:
        raise RuntimeError(f"7c: {len(lines)} epoch lines, {len(agg)} aggregate lines")
    for k in range(len(seeds)):
        ckpts = os.listdir(os.path.join(run_dir, "checkpoints", f"seed_{k}"))
        if ckpts != [f"ckpt_{DDP_ITERS:09d}.pt"] or states[k].step != DDP_ITERS:
            raise RuntimeError(f"7c: seed {k}: checkpoints {ckpts}, step {states[k].step}")
    want = len(seeds) * DDP_ITERS
    if launches != want:
        raise RuntimeError(f"7c: expected {want} {KERNEL} launches, got {launches}")
    ms = took[0] / DDP_ITERS * 1e3
    note(f"[mseed] 7c: seeds {MSEED_SEEDS} in turn on the Pascal CutMix line: {lines}; "
         f"{agg[0]}; {launches} {KERNEL} launches (one per seed per iteration); "
         f"{ms:.2f} ms/iteration of both seeds (the first included); peak {peak:.2f} GiB with "
         f"two states resident")
    del states
    torch.cuda.empty_cache()
    return {"launches": launches, "ms_per_iter": ms, "peak_mem_gib": peak, "aggregate": agg[0]}


# phase 8: spatial partitioning. 8a: name -> (TINY_ALGOS' draws, module,
# (global n, h, w), config, step factory); 36 rows give DeepLab v2 feature
# maps of 18, 10 and 5 rows (5/5 and 3/2 over the two ranks: the ASPP's
# dilation 6 reaches past the neighbouring rank), and DeepLab v3+ maps of
# 18, 9 and 5 (its image pooling, half-pixel resizes and dropout masks of
# the full maps; the masks drawn on the host, the same in both runs)
SPATIAL_CASES = {
    "deeplab2 cutmix": ("mask_mt", tiny_deeplab2, (2, 36, 33),
                        MaskConsistencyConfig(conf_thresh=0.34), make_mask_mt_step),
    "deeplab2 cutout per-pixel gate": ("mask_mt", tiny_deeplab2, (2, 36, 33),
                                       MaskConsistencyConfig(mask_mode="zero", conf_thresh=0.34,
                                                             conf_per_pixel=True),
                                       make_mask_mt_step),
    "deeplab2 ict": ("ict", tiny_deeplab2, (2, 36, 33), TINY_ALGOS["ict"][0], make_ict_step),
    "deeplab2 vat adaptive radius": ("vat_adaptive", tiny_deeplab2, (2, 36, 33),
                                     TINY_ALGOS["vat_adaptive"][0], make_vat_step),
    "deeplab2 aug_mt": ("aug_mt", tiny_deeplab2, (2, 36, 33), TINY_ALGOS["aug_mt"][0],
                        make_aug_cons_step),
    "deeplabv3plus cutmix": ("mask_mt", lambda: DeepLabV3Plus(4, layers=TINY), (4, 36, 33),
                             MaskConsistencyConfig(conf_thresh=0.0), make_mask_mt_step),
}
SPATIAL_STEPS = 2
# 8b: the Cityscapes CutMix line, 2 epochs of SPATIAL_ITERS iterations (the
# first pays cuDNN's choice of algorithms for the ranks' shapes; the second
# is timed)
SPATIAL_ITERS = 3
# one checkpoint a run, at its last epoch (CKPT_LAST): the R101, PSPNet and
# DenseUNet-161 checkpoints of phases 8-12 are ~1 GB each, and the whole
# script's disk writes must stay within a 45 GiB disk
CKPT_LAST = "--checkpoint_interval=2"
SPATIAL_FLAGS = CITYSCAPES_CUTMIX + [f"--iters_per_epoch={SPATIAL_ITERS}", "--num_epochs=2",
                                     CKPT_LAST]


def _spatial_case(name: str, mesh, cases=None) -> tuple:
    """An 8a case (12a: of FAMILY_CASES) on cuda:0: over ``mesh`` (each
    rank its rows of the images) or, with None, the whole batch in one
    process: _run_tiny's (metrics, tensors)."""
    algo, make_module, (n, h, w), cfg, make_step = (cases or SPATIAL_CASES)[name]
    rng = np.random.RandomState(9)
    nb = tiny_batch(algo, n, h, w, rng)
    if algo == "mask_mt" and cfg.mask_mode == "zero":
        nb = {"sup_x": nb["sup_x"], "sup_y": nb["sup_y"], "ux_tea": nb["ux0_tea"],
              "ux_stu": nb["ux0_stu"], "um": nb["um0"]}
    draws = [tiny_draws(algo, n, h, w, rng) for _ in range(SPATIAL_STEPS)]
    local = {k: local_rows(v, mesh) for k, v in nb.items()}
    make = lambda model, opt, c: make_step(model, opt, c, mesh)  # noqa: E731
    masks = _GlobalHostMasks(mesh)
    draw_keep = Dropout.draw_keep
    Dropout.draw_keep = lambda self, x: masks.draw(self, x)
    try:
        return run_tiny("cuda", tiny_weights(8, make_module()), make_module, cfg, make, local,
                         draws, masks)
    finally:
        Dropout.draw_keep = draw_keep


def _spatial_steps_rank(cases=None) -> dict:
    """One rank of 8a (12a: FAMILY_CASES): gloo on the one card, the
    images' rows split over the two ranks (--spatial_train 2)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed("cuda:0", backend="gloo")
    try:
        mesh = data_mesh(2)
        build.launch_counts.clear()
        runs = {name: _spatial_case(name, mesh, cases) for name in cases or SPATIAL_CASES}
        return {"runs": runs, "launches": build.launch_counts.get(KERNEL, 0),
                "backend": dist.get_backend(), "mesh": tuple(mesh)}
    finally:
        dist.destroy_process_group()


def phase_spatial_steps(tmp: str, cases=None, tag: str = "8a") -> dict:
    """8a: the tiny CutMix and Cutout steps with each image's rows split
    over two ranks sharing the card, against one process on the card over
    the same batch (f32, TF32 off); 12a the same for FAMILY_CASES."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases_ = cases or SPATIAL_CASES
    t0 = time.perf_counter()
    ranks = _spawn_ranks("family_steps" if cases else "spatial_steps", 2, tmp, 600)
    t_ranks = time.perf_counter() - t0
    if any(r["backend"] != "gloo" or r["mesh"] != (2, i, 2) for i, r in enumerate(ranks)):
        raise RuntimeError(f"{tag}: the ranks did not run as two gloo ranks of one image")
    for name in cases_:
        (m0, t0_), (m1, t1_) = ranks[0]["runs"][name], ranks[1]["runs"][name]
        if m0 != m1 or not all(torch.equal(a[k], b[k]) for a, b in zip(t0_, t1_) for k in a):
            raise RuntimeError(f"{tag} {name}: the ranks' states differ")
        one = _spatial_case(name, None, cases)
        _, _, (n, h, w), _, _ = cases_[name]
        check_small_run(f"H split over 2 ranks {name}",
                         {"cpu": one, "cuda": ranks[0]["runs"][name]}, n * h * w,
                         SPATIAL_STEPS, 3e-4, labels=("one process", "2 ranks"))
    per_rank = [r["launches"] for r in ranks]
    n_mix = sum(algo == "mask_mt" and cfg.mask_mode == "mix"
                for algo, _, _, cfg, _ in cases_.values())
    if per_rank != [n_mix * SPATIAL_STEPS] * 2:
        raise RuntimeError(f"{tag}: {per_rank} {KERNEL} launches per rank, expected "
                           f"{n_mix * SPATIAL_STEPS} each")
    if cases:
        note(f"[spatial families] 12a: {sorted(cases)} with the rows split over two gloo "
             f"ranks on one card: ranks bit-identical after each of {SPATIAL_STEPS} steps, "
             f"within check_small_run's bounds of one process; {per_rank} {KERNEL} launches "
             f"per rank (one per CutMix step, on the full crops; none on the others); the "
             f"ranks took {t_ranks:.1f} s with their start-up")
        return {"launches": sum(per_rank), "ranks_s": t_ranks}
    note(f"[spatial] 8a: {sorted(SPATIAL_CASES)} at 36x33 crops (DeepLab v2 feature maps of "
         f"18, 10, 5 rows; v3+ 18, 9, 5) with the rows split over two gloo ranks on one card: "
         f"ranks bit-identical after each of {SPATIAL_STEPS} steps, within check_small_run's "
         f"bounds of one process; {per_rank} {KERNEL} launches per rank (one per CutMix step, "
         f"on the full crops; none on the ICT, VAT, aug_mt and Cutout steps); the ranks took "
         f"{t_ranks:.1f} s with their start-up")
    return {"launches": sum(per_rank), "ranks_s": t_ranks}


def _val_predictions(engine, mesh, split: bool) -> tuple:
    """The eval net's predictions (N, H, W) of the val frames on every rank
    (under ``split`` each rank predicting its rows), their labels, the
    pass's time in ms, and the first batch's logits (gathered by rows)."""
    preds, labels, logits = [], [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in common.eval_batches_over(engine.ds, engine.val_ndx, engine.p["batch_size"],
                                          engine.model.block_size, mesh, split):
        n = batch["count"]
        pred = common.predict_batch(engine.eval_net(), batch, engine.mean, engine.std,
                                    engine.device, mesh, split)
        preds.append(pred[:n].cpu())
        labels.append(torch.from_numpy(batch["labels"][:n]).long())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    batch = next(common.eval_batches_over(engine.ds, engine.val_ndx, engine.p["batch_size"],
                                          engine.model.block_size, mesh, split))
    placed = common.to_device({k: batch[k] for k in ("canvas", "labels", "sizes")},
                              engine.device)
    x, _, _ = normalise_eval_batch(placed, engine.mean, engine.std)
    net = engine.eval_net()
    with torch.no_grad(), eval_mode(net):
        if split:
            set_spatial(net, mesh)
            logits = gather_h(net(slice_h(x, mesh)).float(), x.shape[1], mesh)
            set_spatial(net, None)
        else:
            logits = net(x).float()
    return torch.cat(preds), torch.cat(labels), ms, logits[:batch["count"]].cpu()


def _spatial_trainer_rank(results: str) -> dict:
    """One rank of 8b and 8c: the Cityscapes CutMix line through job.submit
    with --spatial_train 2 and --eval_spatial over two gloo ranks sharing
    the card; then the val frames' predictions, rows split over the ranks."""
    maybe_initialize_distributed("cuda:0", backend="gloo")
    try:
        rank = dist.get_rank()
        torch.cuda.reset_peak_memory_stats()
        params = _parse_flags(SPATIAL_FLAGS + ["--spatial_train=2", "--eval_spatial"])
        build.launch_counts.clear()
        engine = job.submit("chip_smoke_spatial", "spatial", train_seg_semisup_mask_mt,
                            dict(params, device="cuda:0"), results_root=results)
        launches = build.launch_counts.get(KERNEL, 0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        mesh, split = common.eval_layout(engine.mesh, True)
        dist.barrier()  # rank 0 has written its checkpoint
        preds, _, eval_ms, logits = _val_predictions(engine, mesh, split)
        out = {"launches": launches, "peak_mem_gib": peak, "eval_ms": eval_ms,
               "mesh": tuple(engine.mesh), "backend": dist.get_backend(),
               "step": engine.state.step, "run_dir": engine.ctx.run_dir, "preds": preds}
        if rank == 0:
            torch.save({"teacher": engine.eval_net().state_dict(), "logits": logits},
                       os.path.join(results, "spatial_eval.pt"))
        return out
    finally:
        dist.destroy_process_group()


def phase_spatial_trainer(tmp: str, voc_root: str) -> dict:
    """8b: the Cityscapes CutMix line at full width (R101, frozen BN, bs 4,
    256x512 crops, 19 classes, bf16) with --spatial_train 2 over two gloo
    ranks sharing the card, beside the same line at world 1 in this
    process; 8c: --eval_spatial at world 2 on that model over the val
    frames (512x1024) against the world-1 eval."""
    os.environ["CUTMIX_SEG_CONFIG"] = write_config(
        os.path.join(tmp, "seg_spatial.cfg"), voc_root,
        cityscapes_zip=os.path.join(tmp, "cityscapes.zip"))
    settings._config = None
    results = os.path.join(tmp, "results_spatial")
    os.makedirs(results, exist_ok=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    world1, launches1, log1 = _run_trainer(results, SPATIAL_FLAGS, None, desc="world1")
    peak1 = torch.cuda.max_memory_allocated() / 2 ** 30
    losses1 = _epoch_line(log1, 2)
    with open(os.path.join(world1.ctx.run_dir, "metrics_world1.jsonl")) as f:
        rec1 = json.loads(f.readlines()[-1])
    del world1
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = _spawn_ranks("spatial_trainer", 2, results, 900)
    t_ranks = time.perf_counter() - t0
    if any(r["backend"] != "gloo" or r["mesh"] != (2, i, 2) for i, r in enumerate(ranks)):
        raise RuntimeError("8b: the ranks did not run as two gloo ranks of one image")
    run_dir = ranks[0]["run_dir"]
    with open(os.path.join(run_dir, "log_spatial.txt")) as f:
        log = f.read()
    losses = _epoch_line(log, 2)
    with open(os.path.join(run_dir, "metrics_spatial.jsonl")) as f:
        rec = json.loads(f.readlines()[-1])
    per_rank = [r["launches"] for r in ranks]
    n = 2 * SPATIAL_ITERS
    if per_rank != [n] * 2 or launches1 != n or any(r["step"] != n for r in ranks):
        raise RuntimeError(f"8b: {per_rank} {KERNEL} launches per rank and {launches1} at "
                           f"world 1, expected {n} each")
    ms, ms1 = (r["train_time"] / SPATIAL_ITERS * 1e3 for r in (rec, rec1))
    peaks = [r["peak_mem_gib"] for r in ranks]
    note(f"[spatial] 8b: Cityscapes CutMix line (R101, frozen BN, bs 4, 256x512, 19 classes, "
         f"bf16) with --spatial_train 2 over two gloo ranks on one card: epoch 2 {losses}, VAL "
         f"mIoU {rec['val_miou']:.4f} (--eval_spatial); epoch 2 {ms:.2f} ms/iteration; peak "
         f"memory per rank {peaks[0]:.2f} / {peaks[1]:.2f} GiB; {per_rank} {KERNEL} launches "
         f"per rank in {n} iterations; the ranks took {t_ranks:.1f} s with their start-up. "
         f"World 1 in this call: epoch 2 {losses1}, VAL mIoU {rec1['val_miou']:.4f}; epoch 2 "
         f"{ms1:.2f} ms/iteration; peak {peak1:.2f} GiB; {launches1} launches")

    # 8c: the spatial run's eval net at world 1 over the same val frames
    params = _parse_flags(SPATIAL_FLAGS)
    spec, cfg = build_spec(params)
    engine = TrainEngine(job.RunContext(os.path.join(results, "eval1"), "eval1"), spec, cfg,
                         params)
    if not engine.setup():
        raise RuntimeError("8c: the world-1 engine's setup failed")
    saved = torch.load(os.path.join(results, "spatial_eval.pt"))
    engine.eval_net().load_state_dict(saved["teacher"])
    ev = _check_split_eval("8c", engine, saved["logits"], [r["preds"] for r in ranks], 19)
    cms = "equal" if ev["cm_counts_apart"] == 0 else f"{ev['cm_counts_apart']} counts apart"
    note(f"[spatial] 8c: --eval_spatial at world 2 over {ev['frames']} val frames of "
         f"{ev['hw']} (bf16): {ev['pixels_differ']} of {ev['pixels']} predicted pixels differ "
         f"from world 1's, confusion matrices {cms}; the first batch's logits differ by at "
         f"most {ev['logit_delta']:.4g} (|logits| up to {ev['logit_scale']:.4g}), and each of its {ev['first_flips']} flipped pixels has a "
         f"top-two margin within 2 x that ({ev['near_ties']} such near ties); eval "
         f"{ranks[0]['eval_ms']:.1f} / {ranks[1]['eval_ms']:.1f} ms per rank beside "
         f"{ev['eval_ms_world1']:.1f} ms at world 1 (this call, cuDNN warmed)")
    del engine
    torch.cuda.empty_cache()
    return {"launches": per_rank, "launches_world1": launches1, "ms_per_iter": ms,
            "ms_per_iter_world1": ms1, "peak_mem_gib": peaks, "peak_mem_gib_world1": peak1,
            "eval_ms": [r["eval_ms"] for r in ranks], "eval_ms_world1": ev["eval_ms_world1"],
            "pixels_differ": ev["pixels_differ"], "cm_counts_apart": ev["cm_counts_apart"],
            "logit_delta": ev["logit_delta"], "ranks_s": t_ranks}


def _check_split_eval(tag: str, engine, split_logits: torch.Tensor, rank_preds: list,
                      classes: int) -> dict:
    """The val frames' predictions of ``engine``'s eval net at world 1 in
    this process against the ranks' (``rank_preds``, rows split): the ranks
    must agree, and every pixel that differs from world 1 must be a near tie
    of world 1's logits on the first batch (``split_logits``: the split
    pass's logits there); the confusion matrices may move by no more than
    the differing pixels explain."""
    _val_predictions(engine, None, False)  # cuDNN's choice for the full frames
    pred1, labels, eval_ms1, logits1 = _val_predictions(engine, None, False)
    pred2 = rank_preds[0]
    if any(not torch.equal(pred2, p) for p in rank_preds[1:]) or pred2.shape != pred1.shape:
        raise RuntimeError(f"{tag}: the ranks' gathered predictions differ")
    cm1, cm2 = (confusion_matrix(p, labels, classes) for p in (pred1, pred2))
    differ = pred1 != pred2
    moved = int((cm1 - cm2).abs().sum())
    if moved > 2 * int(differ.sum()):
        raise RuntimeError(f"{tag}: the matrices differ by {moved} counts, more than the "
                           f"{int(differ.sum())} differing pixels explain")
    # a pixel's prediction can flip between the two passes only where world
    # 1's top-two logit margin is within twice their largest logit difference
    # (measured on the first batch, whose logits both passes kept)
    n0 = logits1.shape[0]
    delta = (split_logits - logits1).abs().max().item()
    top2 = logits1.topk(2, dim=-1).values
    near_tie = (top2[..., 0] - top2[..., 1]) <= 2 * delta
    unexplained = int((differ[:n0] & ~near_tie).sum())
    if unexplained:
        raise RuntimeError(f"{tag}: {unexplained} pixels of the first batch flipped with a "
                           f"top-two margin above 2 x {delta:.3g}")
    return {"frames": pred1.shape[0], "hw": tuple(pred1.shape[1:]), "pixels": pred1.numel(),
            "pixels_differ": int(differ.sum()), "cm_counts_apart": moved,
            "logit_delta": delta, "logit_scale": logits1.abs().max().item(),
            "first_flips": int(differ[:n0].sum()), "near_ties": int(near_tie.sum()),
            "eval_ms_world1": eval_ms1}


# phase 11a: the other spatial lines at full width on the Cityscapes frames
# of phase 6d: desc -> (trainer, flags). CutMix on DeepLab v3+ R101 (the
# v3+ recipe's family; 256 rows split 2 ways, where the Pascal recipe's 321
# do not), and the Pascal recipe's ICT, VAT and aug_mt regularisers
# (RECIPE_ALGOS) on the Cityscapes line's DeepLab v2 R101; 2 epochs of
# LINE_ITERS iterations (the first pays cuDNN's choice of algorithms, the
# second is timed), eval over the val frames at the end of each
LINE_ITERS = 2
CITY_BASE = [f for f in CITYSCAPES_CUTMIX
             if not f.startswith(("--mask_mode", "--mask_prop_range", "--iters_per_epoch",
                                  "--num_epochs", "--cons_weight", "--conf_thresh"))] + [
    f"--iters_per_epoch={LINE_ITERS}", "--num_epochs=2", CKPT_LAST]
SPATIAL_LINES = {
    "v3plus_cutmix": ("mask_mt", [f for f in CITY_BASE if not f.startswith("--arch")] + [
        "--arch=resnet101_deeplabv3plus_imagenet", "--cons_weight=1.0", "--mask_mode=mix",
        "--mask_prop_range=0.5", "--conf_thresh=0.97"]),
    **{algo: (algo, CITY_BASE + RECIPE_ALGOS[algo][2]) for algo in ("ict", "vat_mt", "aug_mt")},
}


def _spatial_lines_rank(results: str, lines=None) -> dict:
    """One rank of 11a (12b-c: FAMILY_LINES): each of SPATIAL_LINES with
    --spatial_train 2 --eval_spatial through job.submit over two gloo ranks
    sharing the card; after each, the val frames' predictions with the rows
    split (rank 0 saves the line's teacher and its split first-batch
    logits)."""
    maybe_initialize_distributed("cuda:0", backend="gloo")
    try:
        rank, out = dist.get_rank(), {}
        for desc, (algo, flags) in (lines or SPATIAL_LINES).items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            engine, launches, log = _run_trainer(
                results, flags + ["--spatial_train=2", "--eval_spatial"], "cuda:0", algo,
                desc=f"{desc}_spatial")
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            mesh, split = common.eval_layout(engine.mesh, True)
            dist.barrier()  # rank 0 has written its checkpoint
            preds, _, eval_ms, logits = _val_predictions(engine, mesh, split)
            out[desc] = {"launches": launches, "peak_mem_gib": peak, "eval_ms": eval_ms,
                         "mesh": tuple(engine.mesh), "step": engine.state.step,
                         "losses": _epoch_line(log, 2), "run_dir": engine.ctx.run_dir,
                         "preds": preds}
            if rank == 0:
                torch.save({"teacher": engine.eval_net().state_dict(), "logits": logits},
                           os.path.join(results, f"{desc}_eval.pt"))
            del engine
        return {"lines": out, "backend": dist.get_backend()}
    finally:
        dist.destroy_process_group()


def _epoch2_ms(run_dir: str, desc: str) -> float:
    with open(os.path.join(run_dir, f"metrics_{desc}.jsonl")) as f:
        return json.loads(f.readlines()[-1])["train_time"] / LINE_ITERS * 1e3


def phase_spatial_lines(tmp: str, voc_root: str, lines=None, isic_zip=None,
                        tag: str = "11a") -> dict:
    """11a: SPATIAL_LINES at full width (bf16, bs 4, 256x512 crops, 19
    classes) at world 1 in this process, then with --spatial_train 2
    --eval_spatial over two gloo ranks sharing the card; per line the
    epoch lines, ms/iteration, each rank's peak, the kernel's launches per
    rank (one per iteration on the CutMix lines, none on the others) and the
    split eval's differing val pixels against world 1 (each a near tie).
    12b-c: the same for FAMILY_LINES (the ISIC line on ``isic_zip``)."""
    kind = "family_lines" if lines else "spatial_lines"
    lines = lines or SPATIAL_LINES
    os.environ["CUTMIX_SEG_CONFIG"] = write_config(
        os.path.join(tmp, f"seg_{kind}.cfg"), voc_root, isic_zip,
        cityscapes_zip=os.path.join(tmp, "cityscapes.zip"))
    settings._config = None
    results = os.path.join(tmp, f"results_{kind}")
    os.makedirs(results, exist_ok=True)
    world1 = {}
    for desc, (algo, flags) in lines.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        engine, launches, log = _run_trainer(results, flags, None, algo, desc=desc)
        world1[desc] = {"engine": engine, "launches": launches, "losses": _epoch_line(log, 2),
                        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                        "ms_per_iter": _epoch2_ms(engine.ctx.run_dir, desc)}
    t0 = time.perf_counter()
    ranks = _spawn_ranks(kind, 2, results, 900)
    t_ranks = time.perf_counter() - t0
    if any(r["backend"] != "gloo" for r in ranks):
        raise RuntimeError(f"{tag}: the ranks did not run over gloo")
    n = 2 * LINE_ITERS
    out = {"ranks_s": t_ranks}
    for desc, (algo, _) in lines.items():
        w1 = world1.pop(desc)
        got = [r["lines"][desc] for r in ranks]
        if any(g["mesh"] != (2, i, 2) or g["step"] != n for i, g in enumerate(got)):
            raise RuntimeError(f"{tag} {desc}: the ranks did not run {n} steps as two ranks of "
                               "one image")
        want = n if algo == "mask_mt" else 0
        per_rank = [g["launches"] for g in got]
        if per_rank != [want] * 2 or w1["launches"] != want:
            raise RuntimeError(f"{tag} {desc}: {per_rank} {KERNEL} launches per rank and "
                               f"{w1['launches']} at world 1, expected {want} each")
        saved = torch.load(os.path.join(results, f"{desc}_eval.pt"))
        engine = w1.pop("engine")
        engine.eval_net().load_state_dict(saved["teacher"])
        ev = _check_split_eval(f"{tag} {desc}", engine, saved["logits"],
                               [g["preds"] for g in got], engine.n_classes)
        del engine
        ms = _epoch2_ms(got[0]["run_dir"], f"{desc}_spatial")
        peaks = [g["peak_mem_gib"] for g in got]
        note(f"[spatial lines] {tag} {desc} ({algo}, --spatial_train 2 --eval_spatial, two gloo "
             f"ranks on one card): epoch 2 {got[0]['losses']}; {ms:.2f} ms/iteration; peak per "
             f"rank {peaks[0]:.2f} / {peaks[1]:.2f} GiB; {per_rank} {KERNEL} launches per rank "
             f"in {n} iterations; split eval: {ev['pixels_differ']} of {ev['pixels']} val pixels "
             f"differ from world 1's, each of the first batch's {ev['first_flips']} a near tie "
             f"(logits within {ev['logit_delta']:.4g}). World 1: epoch 2 {w1['losses']}; "
             f"{w1['ms_per_iter']:.2f} ms/iteration; peak {w1['peak_mem_gib']:.2f} GiB; "
             f"{w1['launches']} launches")
        out[desc] = {"launches": per_rank, "launches_world1": w1["launches"],
                     "ms_per_iter": ms, "ms_per_iter_world1": w1["ms_per_iter"],
                     "peak_mem_gib": peaks, "peak_mem_gib_world1": w1["peak_mem_gib"],
                     "pixels_differ": ev["pixels_differ"], "pixels": ev["pixels"],
                     "logit_delta": ev["logit_delta"],
                     "eval_ms": [g["eval_ms"] for g in got],
                     "eval_ms_world1": ev["eval_ms_world1"]}
        torch.cuda.empty_cache()
    note(f"[spatial lines] {tag}: the ranks took {t_ranks:.1f} s with their start-up")
    return out


# phase 12: spatial partitioning of PSPNet, the ResUNets and DenseUNet.
# 12a: name -> (TINY_ALGOS' draws, module, (global n, h, w), config, step
# factory), training BN and host-drawn dropout masks: the U-Nets at 96
# rows (their 1/32 map has 3 rows, split 2/1: the 6 -> 3 average pool and
# the 3 -> 6 nearest upsample straddle the split), PSPNet at 36 (a 5-row
# map split 3/2 under 6 pyramid bins); the gate open (a random net's
# confidences sit near 1/C, where a gate flips on ties, as 8a's v3+ case)
FAMILY_CASES = {
    "denseunet cutmix": ("mask_mt", lambda: DenseUNet(4, block_config=(2, 2, 2, 2)),
                         (2, 96, 64), MaskConsistencyConfig(conf_thresh=0.0, freeze_bn=False),
                         make_mask_mt_step),
    "resunet aug_mt": ("aug_mt", lambda: ResUNet(4, layers=TINY), (2, 96, 64),
                       AugConsConfig(conf_thresh=0.0, freeze_bn=False), make_aug_cons_step),
    "pspnet ict": ("ict", lambda: PSPNet(4, layers=TINY), (4, 36, 33),
                   ICTConfig(ict_alpha=0.5, conf_thresh=0.0, freeze_bn=False), make_ict_step),
}
# 12b-c: desc -> (trainer, flags), 2 epochs of LINE_ITERS iterations each,
# eval at the end of each: the ISIC recipe's CutMix line (phase 6c's flags,
# DenseUNet-161, bs 10, 224^2, training BN, dropout, SGD 0.1 poly,
# --bin_fill_holes) on phase 6c's synthetic ISIC zip; PSPNet R101 with
# CutMix and ResUNet-101 with the aug_mt regulariser (no kernel on its
# path) on phase 6d's converted Cityscapes frames (bf16, bs 4, 256x512)
FAMILY_LINES = {
    "isic_cutmix": ("mask_mt", ISIC_COMMON + ISIC_LINES["cutmix"][1] + [
        "--no_pretrained", f"--iters_per_epoch={LINE_ITERS}", "--num_epochs=2", CKPT_LAST]),
    "pspnet_cutmix": ("mask_mt", [f for f in CITY_BASE if not f.startswith("--arch")] + [
        "--arch=resnet101_pspnet_imagenet", "--cons_weight=1.0", "--mask_mode=mix",
        "--mask_prop_range=0.5", "--conf_thresh=0.97"]),
    "resunet101_aug_mt": ("aug_mt", [f for f in CITY_BASE if not f.startswith("--arch")] + [
        "--arch=resnet101unet_imagenet"] + RECIPE_ALGOS["aug_mt"][2]),
}


def phase_native_decoder(voc_root: str) -> dict:
    """11b: whether the native PNG/JPEG decoder builds on this machine. If
    it does, it must be bit-equal to PIL on the VOC tree's JPEG images and
    PNG labels; if not, ``auto`` must give the loader PIL's arrays and
    ``CUTMIX_SEG_NATIVE_DECODE=1`` must raise."""
    from PIL import Image

    from cutmix_seg_tpu_torch.data import sources
    from cutmix_seg_tpu_torch.native import decode as nd

    def first(sub, n=8):
        d = os.path.join(voc_root, sub)
        return [os.path.join(d, f) for f in sorted(os.listdir(d))[:n]]

    files = first("JPEGImages") + first("SegmentationClass")
    t0 = time.perf_counter()
    built = nd.native_available()
    build_s = time.perf_counter() - t0

    def pil(path):
        with Image.open(path) as im:
            return np.array(im)

    for path in files:
        with open(path, "rb") as f:
            data = f.read()
        got, want = sources._read_file_array(path), pil(path)
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise RuntimeError(f"11b: the loader's array of {path} differs from PIL's")
        if built and (nd._decode_native(data) is None
                      or not np.array_equal(nd._decode_native(data), want)):
            raise RuntimeError(f"11b: the native decode of {path} is not PIL's")
    kinds = sorted({os.path.splitext(p)[1] for p in files})
    if built:
        note(f"[native] 11b: the decoder built in {build_s:.2f} s ({nd.library_path()}); "
             f"bit-equal to PIL on {len(files)} files of the VOC tree ({kinds})")
        return {"built": True, "files": len(files), "build_s": build_s}
    err, raised = nd.build_error(), None
    os.environ["CUTMIX_SEG_NATIVE_DECODE"] = "1"
    nd._lib, nd._lib_failed, nd._lib_error = None, False, None
    try:
        with open(files[0], "rb") as f:
            nd.decode_array(f.read())
    except Exception as e:  # the build's own error, as JAX's decoder raises it
        raised = type(e).__name__
    finally:
        del os.environ["CUTMIX_SEG_NATIVE_DECODE"]
        nd._lib, nd._lib_failed, nd._lib_error = None, False, None
    if raised is None:
        raise RuntimeError("11b: CUTMIX_SEG_NATIVE_DECODE=1 did not raise")
    why = str(getattr(err, "stderr", "") or err).strip().splitlines()[:1]
    note(f"[native] 11b: the decoder does not build here ({type(err).__name__}: {why}); "
         f"auto: the loader's arrays of {len(files)} files of the VOC tree ({kinds}) equal "
         f"PIL's; CUTMIX_SEG_NATIVE_DECODE=1 raised {raised}")
    return {"built": False, "files": len(files), "mode_1_raised": raised}


# phase 9: serving, the model tools and toy2d
SERVE_ARCH, SERVE_HW, SERVE_BATCHES = "resnet101_deeplab_imagenet", (321, 321), (1, 4, 8, 16)
SERVE_ITERS = 20
DENSE_SERVE = ("densenet161unet_imagenet", 2, (224, 224))  # the ISIC arch
# a bf16 label may flip between two runs of one graph only where the top two
# logits lie within a few bf16 steps (2^-8 of the pixel's largest |logit|)
SERVE_TIE_REL = 2.0 ** -5
# 9a's torch-only load: the artifact and the images in, the labels out
TORCH_ONLY_LOAD = r"""
import sys, torch
art, xs_path, out_path = sys.argv[1:]
call = torch.export.load(art).module()
labels = [call(x.to("cuda")).cpu() for x in torch.load(xs_path)]
bad = sorted(m for m in sys.modules if m.startswith("cutmix_seg_tpu"))
if bad:
    raise SystemExit(f"the loader imported {bad}")
torch.save(labels, out_path)
"""


def _serve_inputs(batches, hw, seed: int):
    """uint8 NHWC images per batch size, made on the host from a seed."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, 256, (b,) + tuple(hw) + (3,), dtype=torch.uint8, generator=gen)
            for b in batches]


def _flips_are_ties(labels: torch.Tensor, logits: torch.Tensor, what: str) -> dict:
    """Labels against the package forward's float logits: every differing
    pixel must have its label's logit within SERVE_TIE_REL of the top one."""
    logits = logits.float().cpu()
    want = logits.argmax(dim=-1)
    differ = labels.long().cpu() != want
    top = logits.max(dim=-1).values
    got = logits.gather(-1, labels.long().cpu()[..., None])[..., 0]
    margin = (top - got)[differ]
    bound = SERVE_TIE_REL * logits.abs().amax(dim=-1)[differ]
    if bool((margin > bound).any()):
        raise RuntimeError(f"{what}: {int((margin > bound).sum())} flipped labels are not "
                           "near ties of the package forward's logits")
    return {"flips": int(differ.sum()), "pixels": labels.numel(),
            "max_margin": float(margin.max()) if margin.numel() else 0.0}


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _http_predict(server: subprocess.Popen, port: int, image: np.ndarray) -> tuple:
    """The HTTP host's /healthz metadata and its /predict labels of one
    image, once the host answers (it loads the artifact and the card)."""
    import urllib.request

    from PIL import Image

    deadline = time.monotonic() + 300
    while True:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
                meta = json.loads(r.read())
            break
        except OSError:
            if server.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("9b: the HTTP host did not come up")
            time.sleep(1.0)
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="PNG")
    t0 = time.perf_counter()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=120) as r:
        pred = np.asarray(Image.open(io.BytesIO(r.read())))
    return meta, pred, (time.perf_counter() - t0) * 1e3


def phase_serving(tmp: str) -> dict:
    """9a: tools/export_model on the card (R101 bf16 21 classes 321^2 from a
    model.pt of seeded random weights), loaded in a fresh torch-only process
    and called at batches 1-16 against the package forward; the f32 logits
    artifact at batch 2; DenseUNet-161 at 224^2; serve_bench's timings. 9b's
    HTTP host serves the artifact from a process of its own. The two
    processes start as soon as the artifact exists and load while this one
    exports the others; the timings run after both are done with the card."""
    from cutmix_seg_tpu_torch.serve.export import (
        export_serving_artifact,
        load_serving_artifact,
        make_serving_fn,
    )
    from cutmix_seg_tpu_torch.tools import export_model, serve_bench

    out = os.path.join(tmp, "serve")
    os.makedirs(out, exist_ok=True)
    model = resnet101_deeplab_imagenet(NUM_CLASSES, dtype=torch.bfloat16, pretrained=False)
    init_weights(model.module, torch.Generator().manual_seed(0))
    params = os.path.join(out, "model.pt")
    checkpoint.export_params(params, model.module)
    art = os.path.join(out, "model_321.pt2")
    build.launch_counts.clear()
    t0 = time.perf_counter()
    export_model.main.main(["--arch", SERVE_ARCH, "--num_classes", str(NUM_CLASSES),
                            "--params", params, "--hw", ",".join(map(str, SERVE_HW)),
                            "--out", art, "--device", "cuda", "--dtype", "bfloat16"],
                           standalone_mode=False)
    export_s = time.perf_counter() - t0
    mb = os.path.getsize(art) / 1e6
    with open(art + ".json") as f:
        meta = json.load(f)
    if meta["platforms"] != ["cuda"] or meta["input_hw"] != list(SERVE_HW):
        raise RuntimeError(f"9a: unexpected metadata {meta}")

    # the torch-only load, in a fresh process from outside the repository,
    # and the HTTP host
    xs = _serve_inputs(SERVE_BATCHES, SERVE_HW, seed=1)
    torch.save(xs, os.path.join(out, "xs.pt"))
    with open(os.path.join(out, "load.py"), "w") as f:
        f.write(TORCH_ONLY_LOAD)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t_load = time.perf_counter()
    loader = subprocess.Popen([sys.executable, "load.py", art, "xs.pt", "labels.pt"], cwd=out,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = _free_port()
    server = subprocess.Popen([sys.executable, "-m", "cutmix_seg_tpu_torch.serve.http",
                               "--artifact", art, "--port", str(port)],
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        # f32 logits at batch 2, TF32 off (main turns it off)
        f32 = export_model.build_net(SERVE_ARCH, NUM_CLASSES, params, "float32")
        art32 = os.path.join(out, "logits_f32.pt2")
        export_serving_artifact(f32, SERVE_HW, art32, output="logits", device="cuda")
        call32, _ = load_serving_artifact(art32)
        x2 = _serve_inputs([2], SERVE_HW, seed=2)[0].cuda()
        with torch.no_grad():
            got, want = call32(x2), make_serving_fn(f32, "logits")(x2)
        f32_err = (got - want).abs().max().item()
        if got.dtype != torch.float32 or not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
            raise RuntimeError(f"9a: f32 logits differ by {f32_err:.3g}")
        del call32, f32, got, want

        # the ISIC arch at its crop size
        dense_arch, dense_classes, dense_hw = DENSE_SERVE
        art_d = os.path.join(out, "densenet_224.pt2")
        t0 = time.perf_counter()
        export_model.main.main(["--arch", dense_arch, "--num_classes", str(dense_classes),
                                "--hw", ",".join(map(str, dense_hw)), "--out", art_d,
                                "--device", "cuda", "--dtype", "bfloat16"], standalone_mode=False)
        dense_s = time.perf_counter() - t0
        dense = export_model.build_net(dense_arch, dense_classes, None, "bfloat16")
        dense.module.to("cuda")
        call_d, _ = load_serving_artifact(art_d)
        xd = _serve_inputs([2], dense_hw, seed=3)[0].cuda()
        with torch.no_grad():
            dense_ties = _flips_are_ties(call_d(xd), make_serving_fn(dense, "logits")(xd),
                                         "9a DenseUNet")
        dense_mb = os.path.getsize(art_d) / 1e6
        del call_d, dense

        _, err = loader.communicate(timeout=600)
        load_s = time.perf_counter() - t_load
        if loader.returncode:
            raise RuntimeError(f"9a: the torch-only load failed:\n{err[-3000:]}")
        labels = torch.load(os.path.join(out, "labels.pt"))
        host_meta, pred, predict_ms = _http_predict(server, port, xs[0][0].numpy())
    finally:
        _stop(loader)
        _stop(server)
    if host_meta.get("input_hw") != list(SERVE_HW):
        raise RuntimeError(f"9b: /healthz gave {host_meta}")
    if not np.array_equal(pred, labels[0][0].numpy().astype(np.uint8)):
        raise RuntimeError("9b: /predict's labels differ from 9a's")

    # the package forward of the same weights, on the card, with cuDNN's
    # default choice as in the fresh process
    torch.backends.cudnn.benchmark = False
    model.module.to("cuda")
    serve = make_serving_fn(model, "logits")
    ties = {}
    with torch.no_grad():
        for b, x, lab in zip(SERVE_BATCHES, xs, labels):
            if lab.shape != (b,) + SERVE_HW or lab.dtype != torch.int32:
                raise RuntimeError(f"9a: batch {b}: labels {tuple(lab.shape)} {lab.dtype}")
            ties[b] = _flips_are_ties(lab, serve(x.cuda()), f"9a batch {b}")
    call, _ = load_serving_artifact(art)
    timing = serve_bench.measure(call, SERVE_BATCHES, SERVE_HW, NUM_CLASSES,
                                 torch.device("cuda"), SERVE_ITERS)
    # the yardstick: the package's eager serving module on the same weights
    eager = serve_bench.measure(make_serving_fn(model), SERVE_BATCHES, SERVE_HW, NUM_CLASSES,
                                torch.device("cuda"), SERVE_ITERS)
    torch.backends.cudnn.benchmark = True
    del call, serve, model
    launches = build.launch_counts.get(KERNEL, 0)
    if launches:
        raise RuntimeError(f"9a: serving launched {KERNEL} {launches} times")

    note(f"[serve] 9a: tools/export_model {SERVE_ARCH} bf16 {NUM_CLASSES} classes at "
         f"{SERVE_HW}: {export_s:.1f} s, {mb:.1f} MB; loaded and called in a torch-only "
         f"process ({load_s:.1f} s from its start); labels against the package forward per "
         "batch: " + ", ".join(f"b{b} {t['flips']} of {t['pixels']} flipped (max margin "
                               f"{t['max_margin']:.3g})" for b, t in ties.items()))
    note("[serve] 9a: serve_bench timing (CUDA events, median of "
         f"{SERVE_ITERS} after {serve_bench.WARMUP} warm-up): " + ", ".join(
             f"b{b} {r['ms_per_call']:.2f} ms/call, {r['img_per_s']:.1f} img/s, "
             f"{r['ms_per_img']:.2f} ms/img (eager module {eager[str(b)]['ms_per_call']:.2f} "
             "ms/call)" for b, r in timing.items()))
    note(f"[serve] 9a: f32 logits artifact at batch 2 within {f32_err:.3g} of the package "
         f"forward (rtol 1e-4, atol 1e-5, TF32 off); {dense_arch} at {dense_hw}: export "
         f"{dense_s:.1f} s, {dense_mb:.1f} MB, {dense_ties['flips']} of "
         f"{dense_ties['pixels']} labels flipped; {launches} {KERNEL} launches")
    note(f"[tools] 9b: HTTP host (a process of its own, port {port}): /healthz and /predict "
         f"(first request {predict_ms:.0f} ms) equal to 9a's batch-1 labels")
    return {"export_s": export_s, "mb": mb, "timing": timing, "eager": eager, "ties": ties,
            "f32_err": f32_err, "dense_export_s": dense_s, "dense_mb": dense_mb,
            "launches": launches, "load_s": load_s, "predict_ms": predict_ms}


def _last_eval_lines(log: str) -> tuple:
    """The last epoch line's 'VAL mIoU=...' and the per-class line after it."""
    lines = log.splitlines()
    i = max(k for k, ln in enumerate(lines) if ln.startswith("Epoch ") and "VAL mIoU=" in ln)
    return "VAL mIoU=" + lines[i].split("VAL mIoU=")[1], lines[i + 1]


def _evaluate_tool(args) -> tuple:
    """tools/evaluate_model in this process: (IoU, its last two lines)."""
    from cutmix_seg_tpu_torch.tools import evaluate_model

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        iou = evaluate_model.main.main(args, standalone_mode=False)
    return iou, tuple(buf.getvalue().splitlines()[-2:])


def phase_tools(trainer: dict) -> dict:
    """9b: tools/evaluate_model on phase 6's model.pt and checkpoints
    against that run's last eval (its eval net, the teacher), and on the
    checkpoint's student."""
    run_dir = trainer["run_dir"]
    with open(os.path.join(run_dir, "log_run.txt")) as f:
        want = _last_eval_lines(f.read())
    common_args = ["--dataset", "pascal", "--arch", SERVE_ARCH, "--batch_size", str(BATCH),
                   "--compute_dtype", "bfloat16", "--device", "cuda"]
    build.launch_counts.clear()
    t0 = time.perf_counter()
    got = {"model.pt": _evaluate_tool(common_args + ["--model_path",
                                                     os.path.join(run_dir, "model.pt")])}
    eval_s = time.perf_counter() - t0
    ckpts = os.path.join(run_dir, "checkpoints")
    for net in ("teacher", "student"):
        got[f"checkpoint {net}"] = _evaluate_tool(common_args + ["--checkpoint", ckpts,
                                                                 "--net", net])
    for name in ("model.pt", "checkpoint teacher"):
        if got[name][1] != want:
            raise RuntimeError(f"9b: evaluate_model on {name} printed {got[name][1]}, the "
                               f"trainer's last eval {want}")
    student_iou = got["checkpoint student"][0]
    if not np.isfinite(np.nanmean(student_iou)):
        raise RuntimeError("9b: the student's IoU is not finite")
    launches = build.launch_counts.get(KERNEL, 0)
    note(f"[tools] 9b: evaluate_model on phase 6's model.pt and checkpoints/ (--net teacher) "
         f"printed the trainer's last eval {want[0]} ({eval_s:.1f} s for the model.pt pass, "
         f"{VOC_VAL} val images); --net student: mIoU {np.nanmean(student_iou):.3%}; "
         f"{launches} {KERNEL} launches")
    return {"launches": launches, "eval_s": eval_s}


TOY_STEPS, TOY_LR, TOY_SUP, TOY_UNSUP = 3, 1e-3, 35, 512
# run_toy2d_experiments.sh's three lines, --num_epochs 2 for 100 / 100 / 25
TOY_RECIPES = {
    "continuous_semisup": [
        "--dataset=img:data/toy2d/curve_mask_v3.png", "--sup_path=data/toy2d/curve_mask_v3_35.pkl",
        "--region_erode_radius=0", "--norm_layer=none", "--cons_no_dropout",
        "--cons_loss_fn=logits_var", "--cons_weight=1.0", "--perturb_noise_std=30.0",
        "--dist_contour_range=4.0", "--render_pred=class", "--save_output"],
    "cluster_semisup": [
        "--dataset=img:data/toy2d/curve_mask_v3.png", "--sup_path=data/toy2d/curve_mask_v3_35.pkl",
        "--region_erode_radius=35", "--save_output"],
    "cluster_sup": [
        "--dataset=img:data/toy2d/curve_mask_v3.png", "--sup_path=data/toy2d/curve_mask_v3_35.pkl",
        "--region_erode_radius=35", "--cons_weight=0.0", "--save_output"],
}
TOY_EPOCHS = 2


def _toy_state(device, sd, model: str, norm: str):
    """A toy2d student (weights ``sd``), its EMA teacher or None, and the
    Toy2DAlgo with its Adam, on ``device``."""
    from cutmix_seg_tpu_torch.core.train_state import Optimizer
    from cutmix_seg_tpu_torch.toy2d.model import ToyMLP
    from cutmix_seg_tpu_torch.toy2d.train import Toy2DAlgo

    student = ToyMLP(norm_layer=norm)
    student.load_state_dict(sd)
    student.to(device)
    teacher = (copy.deepcopy(student).requires_grad_(False) if model == "mean_teacher"
               else None)
    names = dict(student.named_parameters())
    opt = Optimizer(OptimizerConfig(opt_type="adam", learning_rate=TOY_LR), names,
                    {n: "new" for n in names})
    algo = Toy2DAlgo(opt, model=model, cons_weight=10.0, cons_loss_fn="var",
                     cons_no_dropout=False, conf_thresh=0.0, conf_avg=False,
                     teacher_alpha=0.99, pstd_real=np.float32([0.05, 0.05]))
    return student, teacher, algo


def _toy_tensors(student, teacher, algo) -> dict:
    """Host copies of the student's and teacher's tensors and the Adam moments."""
    out = {f"{part}.{k}": v.to("cpu", copy=True)
           for part, net in (("student", student), ("teacher", teacher))
           if net is not None for k, v in net.state_dict().items()}
    for gi, g in enumerate(algo.opt.groups):
        for name, ts in g.state.items():
            out.update({f"adam.{gi}.{name}.{i}": t.to("cpu", copy=True)
                        for i, t in enumerate(ts)})
    return out


@torch.no_grad()
def _toy_sync(dst: tuple, src: tuple) -> None:
    """Copy one toy2d state (student, teacher, algo) into another."""
    for a, b in zip(dst[:2], src[:2]):
        if a is not None:
            a.load_state_dict(b.state_dict())
    for ga, gb in zip(dst[2].opt.groups, src[2].opt.groups):
        for name in ga.state:
            for ta, tb in zip(ga.state[name], gb.state[name]):
                ta.copy_(tb)
    dst[2].opt.count = src[2].opt.count


def _toy_lockstep(sd, model: str, norm: str, draws) -> list:
    """TOY_STEPS toy2d steps on the CPU and the card in lockstep, each step
    of both from the CPU's state after the previous one (Adam turns rounding
    noise in a near-zero gradient into a step of up to lr, which a free run
    would compound): per step, the metrics and the tensors after it."""
    states = {dev: _toy_state(dev, sd, model, norm) for dev in ("cpu", "cuda")}
    out = []
    for d in draws:
        step = {}
        for dev, (student, teacher, algo) in states.items():
            t = {k: [torch.from_numpy(a).to(dev) for a in v] if isinstance(v, list)
                 else torch.from_numpy(v).to(dev) for k, v in d.items()}
            m = algo.train_step(student, teacher, t["sup_x"], t["sup_y"], t["unsup_x"],
                                noise=t["noise"], drop_masks=t["masks"])
            step[dev] = ({k: v.item() for k, v in m.items()},
                         _toy_tensors(student, teacher, algo))
        out.append(step)
        _toy_sync(states["cuda"], states["cpu"])
    return out


def phase_toy2d(tmp: str) -> dict:
    """9c: each model x norm of the toy2d step at full width, GPU against CPU
    (f32, TF32 off, injected draws, check_small_run's bounds); then the three recipe
    lines of run_toy2d_experiments.sh through the port's CLI at 2 epochs."""
    from cutmix_seg_tpu_torch.toy2d import train as toy_train
    from cutmix_seg_tpu_torch.toy2d.model import NORMS, ToyMLP

    build.launch_counts.clear()
    t0 = time.perf_counter()
    for norm in NORMS:
        net = ToyMLP(norm_layer=norm)
        net.reset_parameters(torch.Generator().manual_seed(4))
        sd = net.state_dict()
        for model in ("mean_teacher", "pi", "pi_onebatch"):
            rng = np.random.RandomState(5)
            sizes = [TOY_SUP] + ([2 * TOY_UNSUP] if model == "pi_onebatch" else [TOY_UNSUP] * 2)
            draws = []
            for _ in range(TOY_STEPS):
                unsup = rng.uniform(-1, 1, (TOY_UNSUP, 2)).astype(np.float32)
                draws.append({
                    "sup_x": rng.uniform(-1, 1, (TOY_SUP, 2)).astype(np.float32),
                    "sup_y": rng.randint(0, 2, TOY_SUP).astype(np.int64),
                    "unsup_x": unsup,
                    "noise": (rng.randn(*unsup.shape) * 0.05).astype(np.float32),
                    "masks": [rng.rand(n, 512) >= 0.5 for n in sizes]})
            _check_toy_steps(f"{model}/{norm}", _toy_lockstep(sd, model, norm, draws))
    check_s = time.perf_counter() - t0

    out = {}
    results = os.path.join(tmp, "toy2d")
    for name, flags in TOY_RECIPES.items():
        params = dict(toy_train.experiment.make_context(
            "experiment", flags + [f"--num_epochs={TOY_EPOCHS}"]).params)
        del params["job_desc"]
        params["device"] = "cuda"
        err = job.submit("toy2d_train", name, toy_train.train_toy2d, params,
                         results_root=results)
        run_dir = os.path.join(results, "toy2d_train", name)
        with open(os.path.join(run_dir, f"log_{name}.txt")) as f:
            log = f.read()
        with open(os.path.join(run_dir, f"metrics_{name}.jsonl")) as f:
            records = [json.loads(ln) for ln in f]
        renders = sorted(p for p in os.listdir(run_dir) if p.startswith("epoch_"))
        if ("FINAL RESULT: Error rate=" not in log or len(records) != TOY_EPOCHS
                or len(renders) != TOY_EPOCHS + 1 or not 0.0 <= err <= 1.0):
            raise RuntimeError(f"9c: the {name} line did not run to its end")
        out[name] = {"err": float(err), "epoch_s": [r["epoch_time"] for r in records],
                     "renders": len(renders)}
    launches = build.launch_counts.get(KERNEL, 0)
    note(f"[toy2d] 9c: 3 models x {len(NORMS)} norms, {TOY_STEPS} lockstep steps at width 512, GPU "
         f"against CPU within check_small_run's bounds ({check_s:.1f} s); the recipe lines at "
         f"{TOY_EPOCHS} epochs: " + ", ".join(
             f"{n} error {r['err']:.4%}, s/epoch {[round(s, 3) for s in r['epoch_s']]}, "
             f"{r['renders']} renders" for n, r in out.items())
         + f"; {launches} {KERNEL} launches")
    return {"lines": out, "launches": launches, "check_s": check_s}


def _check_toy_steps(name: str, steps: list) -> None:
    """Phase 3's bounds for the lockstep toy2d steps (both devices from the
    same state each step): losses rtol 1e-4, the confidence count within
    two flips, every parameter within 2 lr x TOY_STEPS (a Dense bias that
    feeds a BN has a rounding-noise gradient, which Adam turns into a step
    of lr in either direction: 2 lr apart in one step), the statistics (BN's
    running averages, SpectralNorm's u and sigma), the EMA teacher and the
    Adam moments within STATS_RTOL relative to max(1, |value|)."""
    stat = ("running", ".u", ".sigma", "teacher.", "adam.")
    worst = worst_stats = 0.0
    for i, step in enumerate(steps):
        (mc, tc), (mg, tg) = step["cpu"], step["cuda"]
        ok = (math.isclose(mc["sup_loss"], mg["sup_loss"], rel_tol=1e-4)
              and abs(mc["conf_sum"] - mg["conf_sum"]) <= 2
              and math.isclose(mc["cons_loss"], mg["cons_loss"], rel_tol=1e-4))
        if not ok:
            raise RuntimeError(f"toy2d {name} step {i}: cuda {mg} and cpu {mc} disagree")
        for k, a in tc.items():
            d = (a - tg[k]).abs()
            if any(s in k for s in stat):
                worst_stats = max(worst_stats, (d / a.abs().clamp_min(1.0)).max().item())
            else:
                worst = max(worst, d.max().item())
    note(f"[toy2d] {name}: losses {[round(s['cuda'][0]['sup_loss'], 6) for s in steps]} (cuda); "
         f"per step max |param cpu - cuda| {worst:.3g} (bound {2 * TOY_LR * TOY_STEPS:.3g}), "
         "statistics, "
         f"teacher and moments {worst_stats:.3g} (bound {STATS_RTOL})")
    if worst > 2 * TOY_LR * TOY_STEPS + 1e-6 or worst_stats > STATS_RTOL:
        raise RuntimeError(f"toy2d {name}: the states diverge between cuda and cpu")


# phase 10a: the multi-seed convergence sweep at the tool's widths (64^2,
# batch 8, 6 labelled / 256 unlabelled / 64 val images a seed), its depth
# cut to 2 seeds x 100 iterations
SWEEP_SEEDS, SWEEP_ITERS, SWEEP_LOCKSTEP, SWEEP_TIMED = 2, 100, 3, 20


def _sweep_arm(dev, arm: str, iters: int, conf_thresh: float, steps_seen=None, made=None):
    """(run_arm, states, data, stream, ramps) of one arm of the sweep at its
    widths on ``dev``; ``steps_seen`` collects each step's host metrics,
    ``made`` each seed's step as built."""
    hw = (tconv.HW[0], tconv.HW[1])
    seeds = list(range(SWEEP_SEEDS))
    cfg, inner, algorithm = tconv.arm_configs(conf_thresh)[arm]
    opt_cfg = OptimizerConfig(opt_type="adam", learning_rate=1e-3)
    states, models = tconv.init_states(seeds, opt_cfg, dev)

    def make_step(model, opt, cfg):
        step = inner(model, opt, cfg)
        if made is not None:
            made.append(step)
        if steps_seen is None:
            return step

        def rec_step(*args, **kw):
            state, m = step(*args, **kw)
            steps_seen.append({k: v.item() for k, v in m.items()})
            return state, m

        return rec_step
    run = tconv.make_arm_runner(cfg, make_step, algorithm, models, 8, hw=hw)
    data = {}
    for k, s in enumerate(seeds):
        d = tconv.build_seed_data(s, 6, 256, 64, aug_src=algorithm == "aug_mt", hw=hw)
        data[k] = {"sup_x": torch.from_numpy(d["sup_x"]).to(dev),
                   "sup_y": torch.from_numpy(d["sup_y"]).long().to(dev),
                   "unsup_x": torch.from_numpy(d["unsup_x"]).to(dev)}
    stream = {n: torch.from_numpy(a).long().to(dev)
              for n, a in tconv.index_streams(iters, 8, seeds, 6, 256).items()}
    ramps = np.minimum(1.0, np.arange(iters) / (iters * 0.3)).astype(np.float32)
    return run, states, data, stream, ramps


@torch.no_grad()
def _sync_sweep_states(dst: dict, src: dict) -> None:
    """Copy each seed's train state (nets, Adam moments, counts) from src."""
    for k, a in dst.items():
        b = src[k]
        a.student.load_state_dict(b.student.state_dict())
        a.teacher.load_state_dict(b.teacher.state_dict())
        for ga, gb in zip(a.optimizer.groups, b.optimizer.groups):
            for name in ga.state:
                for ta, tb in zip(ga.state[name], gb.state[name]):
                    ta.copy_(tb)
        a.optimizer.count, a.step = b.optimizer.count, b.step


def _sweep_lockstep() -> None:
    """The CutMix arm for SWEEP_LOCKSTEP iterations on the CPU and the card
    in lockstep (each iteration of both from the CPU's states), f32 with
    TF32 off, the same rects on both, check_small_run's bounds per iteration. The
    seeds start from tiny_weights' He-scaled weights (O(1) logits; the tool's
    initialisation gives near-uniform ones, whose consistency loss is
    rounding noise) with the gate at 0, so the consistency loss is on."""
    rng = np.random.RandomState(10)
    rects = {(t, k): sample_box_rects_np(BoxMaskConfig((0.5, 0.5)), 8, tconv.HW, rng)
             for t in range(SWEEP_LOCKSTEP) for k in range(SWEEP_SEEDS)}
    seen = {"cpu": [], "cuda": []}
    made = {"cpu": [], "cuda": []}
    arms = {dev: _sweep_arm(dev, "mask_mt", SWEEP_LOCKSTEP, 0.0, seen[dev], made[dev])
            for dev in ("cpu", "cuda")}
    for k in range(SWEEP_SEEDS):
        sd = tiny_weights(30 + k, tconv.make_model().module)
        for _, states, *_ in arms.values():
            states[k].student.load_state_dict(sd)
            states[k].teacher.load_state_dict(sd)
    for t in range(SWEEP_LOCKSTEP):
        runs = {}
        for dev, (run, states, data, stream, ramps) in arms.items():
            n0 = len(seen[dev])
            run(states, data, {n: v[t:t + 1] for n, v in stream.items()}, ramps[t:t + 1],
                draws=lambda _t, k, dev=dev, t=t: {
                    "rects": torch.from_numpy(rects[t, k]).to(dev)})
            tensors = {f"{k}.{part}.{n}": v.to("cpu", copy=True)
                       for k, st in states.items()
                       for part, net in (("student", st.student), ("teacher", st.teacher))
                       for n, v in net.state_dict().items()}
            runs[dev] = (seen[dev][n0:], [tensors])
        check_small_run(f"sweep mask_mt iteration {t}", runs, 8 * 64 * 64, 1, 1e-3)
        _sync_sweep_states(arms["cuda"][1], arms["cpu"][1])
    note(f"[sweep] 10a: lockstep, the card's step graphs per seed: "
         f"{[s.counters() for s in made['cuda']]}")


def phase_sweep(tmp: str) -> dict:
    """10a: tools/multi_seed_convergence on the card, all six arms at
    SWEEP_SEEDS x SWEEP_ITERS (one kernel launch per seed per iteration on
    the CutMix arm, none on the others); the CutMix arm's steady
    ms/iteration; the CutMix arm on the CPU and the card in lockstep."""
    per_arm, t_arm = {}, [time.perf_counter()]

    def log(msg: str) -> None:
        note(f"[sweep] {msg}")
        arm = msg.split(" ", 1)[0]
        if arm in tconv.ARMS:
            per_arm[arm] = {"launches": build.launch_counts.get(KERNEL, 0),
                            "s": time.perf_counter() - t_arm[-1]}
            build.launch_counts.clear()
            t_arm.append(time.perf_counter())

    # as in the tool's own process: earlier phases turned cuDNN's search on
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    build.launch_counts.clear()
    t_arm[0] = time.perf_counter()
    doc = tconv.run_sweep(SWEEP_ITERS, SWEEP_SEEDS, 6, 256, 64, 8, ",".join(tconv.ARMS[1:]),
                          tconv.HW[0], "shapes", 0.8, False, os.path.join(tmp, "sweep"),
                          device="cuda", log=log)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    with open(os.path.join(tmp, "sweep", "results.json")) as f:
        if json.load(f) != doc:
            raise RuntimeError("10a: results.json differs from the returned document")
    want_keys = {"task", "n_seeds", "iters", "n_sup", "configs", "arms", "total_seconds",
                 "device"}
    if set(doc) != want_keys or doc["device"] != torch.cuda.get_device_name(0):
        raise RuntimeError(f"10a: unexpected document keys {sorted(doc)} / {doc['device']}")
    for arm in tconv.ARMS:
        r = doc["arms"][arm]
        want = SWEEP_SEEDS * SWEEP_ITERS if arm == "mask_mt" else 0
        if per_arm[arm]["launches"] != want:
            raise RuntimeError(f"10a: {arm}: {per_arm[arm]['launches']} {KERNEL} launches, "
                               f"expected {want}")
        if not (len(r["miou_per_seed"]) == SWEEP_SEEDS
                and all(0.0 <= m <= 1.0 for m in r["miou_per_seed"])
                and math.isfinite(r["final_sup_loss_mean"])):
            raise RuntimeError(f"10a: {arm}: {r}")
    note("[sweep] 10a: " + ", ".join(
        f"{arm} {per_arm[arm]['s']:.2f} s ({per_arm[arm]['s'] / SWEEP_ITERS * 1e3:.2f} "
        f"ms/iteration with data, init and eval), {per_arm[arm]['launches']} launches"
        for arm in tconv.ARMS) + f"; sweep {doc['total_seconds']} s; peak +{peak:.3f} GiB")

    # the CutMix arm's steady iteration (both seeds), data and init apart
    made = []
    run, states, data, stream, ramps = _sweep_arm("cuda", "mask_mt", SWEEP_TIMED + 2, 0.8,
                                                  made=made)
    run(states, data, {n: v[:2] for n, v in stream.items()}, ramps[:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(states, data, {n: v[2:] for n, v in stream.items()}, ramps[2:])
    torch.cuda.synchronize()
    ms_iter = (time.perf_counter() - t0) / SWEEP_TIMED * 1e3
    note(f"[sweep] 10a: CutMix arm, {SWEEP_SEEDS} seeds in turn: {ms_iter:.2f} ms/iteration "
         f"steady ({SWEEP_TIMED} iterations after 2; "
         f"{ms_iter / SWEEP_SEEDS:.2f} ms per seed step); the seeds' step graphs: "
         f"{[s.counters() for s in made]}")
    del run, states, data, made
    t0 = time.perf_counter()
    _sweep_lockstep()
    note(f"[sweep] 10a: lockstep check {time.perf_counter() - t0:.1f} s")
    return {"doc": doc, "per_arm": per_arm, "ms_per_iter": ms_iter, "peak_mem_gib": peak,
            "launches": per_arm["mask_mt"]["launches"]}


# phase 10b: the patch-distance study. The tolerance of a squared distance:
# PATCH_SUM_EPS x (the integral image's total + the cross term's p*q*C)
PATCH_SUM_EPS = 4 * float(np.finfo(np.float32).eps)
BIG_ANCHORS, BIG_PATCH, STUDY_FRAMES, STUDY_NEIGHBOURS = 32, 225, 4, 1000


def _dist_close(got: torch.Tensor, want: torch.Tensor, sqr_tol: float) -> float:
    """Largest |got - want| of two distance maps over its bound: sqr_tol on
    the squared distance, so sqrt(sqr_tol) near 0 and sqr_tol / (2 d)
    elsewhere. A value above 1 fails."""
    got, want = got.double(), want.double()
    bound = torch.minimum(torch.full_like(want, math.sqrt(sqr_tol)),
                          sqr_tol / (2 * want).clamp_min(1e-30)) + 1e-7
    return ((got - want).abs() / bound).max().item()


def _padded(image: np.ndarray, patch: int) -> np.ndarray:
    pad = (patch - 1) // 2
    return np.pad(image, [(pad, pad), (pad, pad), (0, 0)], mode="symmetric")


class _Frames:
    """A dataset source over given (image, labels) pairs."""

    def __init__(self, pairs):
        self.pairs = pairs
        self.train_ndx = np.arange(len(pairs))

    def get_image(self, i):
        return self.pairs[i][0]

    def get_labels(self, i):
        return self.pairs[i][1]


def _timed(fn, reps: int = 3):
    """(result, median device ms of ``reps`` calls after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return out, float(np.median(times))


def phase_patch_study(tmp: str, voc_root: str) -> dict:
    """10b: _sliding_distances card vs CPU (TF32 off) at a small size; a
    1024x2048 frame against BIG_ANCHORS anchors of BIG_PATCH^2 in f32 and
    TF32 (ms, peak, the self-match distances, the nearest-neighbour orders
    TF32 changes, the chunking); class_distances on STUDY_FRAMES converted
    Cityscapes frames (device and host ms apart); the studies' statistics."""
    import zipfile

    from PIL import Image

    from cutmix_seg_tpu_torch.analysis import colour_aug_study as colour_study
    from cutmix_seg_tpu_torch.analysis import input_distribution_study as input_study
    from cutmix_seg_tpu_torch.analysis import intra_inter_class_patch_dist as study
    from cutmix_seg_tpu_torch.analysis import patch_dist, plot_patch_distances
    from cutmix_seg_tpu_torch.data import datasets

    torch.backends.cudnn.benchmark = False  # as in the scripts' own processes
    build.launch_counts.clear()
    rng = np.random.RandomState(20)
    # small: card against CPU
    image = rng.rand(64, 96, 3).astype(np.float32)
    patches = np.stack([patch_dist.extract_patch(image, (15, 15), (20 + 3 * i, 30 + 5 * i))
                        for i in range(8)])
    padded = _padded(image, 15)
    ref = patch_dist._sliding_distances(*(torch.from_numpy(a) for a in (padded, patches)))
    got = patch_dist._sliding_distances(*(torch.from_numpy(a).cuda() for a in (padded, patches)))
    tol = PATCH_SUM_EPS * (float((padded.astype(np.float64) ** 2).sum()) + 15 * 15 * 3)
    worst = _dist_close(got.cpu(), ref, tol)
    note(f"[patch] 10b: _sliding_distances 64x96, 8 patches of 15^2, card vs CPU (TF32 off): "
         f"worst |d| over its bound {worst:.3g}")
    if worst > 1.0:
        raise RuntimeError("10b: _sliding_distances differs between the card and the CPU")

    # one official 1024x2048 frame (phase 6d's synthetic zip) and its label ids
    with zipfile.ZipFile(os.path.join(tmp, "leftImg8bit_trainvaltest.zip")) as zx, \
            zipfile.ZipFile(os.path.join(tmp, "gtFine_trainvaltest.zip")) as zy:
        xn = sorted(n for n in zx.namelist() if n.startswith("leftImg8bit/train/"))[0]
        yn = xn.replace("leftImg8bit/", "gtFine/", 1).replace("_leftImg8bit.png",
                                                             "_gtFine_labelIds.png")
        img_u8 = np.array(Image.open(io.BytesIO(zx.read(xn))))
        labels = np.array(Image.open(io.BytesIO(zy.read(yn)))).astype(np.int32)
    frame = img_u8.astype(np.float64) / 255.0
    big = _Frames([(img_u8, labels)])
    ids = study.choose_anchors_and_negatives(big, big.train_ndx, BIG_ANCHORS,
                                             (BIG_PATCH, BIG_PATCH), np.random.RandomState(0))
    anchors, _ = study.extract_anchor_and_negative_patches(big, ids, (BIG_PATCH, BIG_PATCH))
    img_d = torch.from_numpy(_padded(frame, BIG_PATCH)).float().cuda()
    pat_d = torch.from_numpy(anchors).float().cuda()
    runs = {}
    for name, tf32 in (("f32", False), ("tf32", True)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, ms = _timed(lambda tf32=tf32: patch_dist._sliding_distances(img_d, pat_d, tf32=tf32))
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        self_d = out[torch.arange(len(ids)), torch.from_numpy(ids[:, 2]).cuda(),
                     torch.from_numpy(ids[:, 3]).cuda()]
        runs[name] = {"out": out, "ms": ms, "peak_gib": peak, "self": self_d.cpu().numpy()}
    n_px = frame.shape[0] * frame.shape[1]
    flops = 2.0 * BIG_ANCHORS * BIG_PATCH * BIG_PATCH * 3 * n_px
    f32, tf = runs["f32"], runs["tf32"]
    order_f32 = torch.topk(f32["out"].reshape(BIG_ANCHORS, -1), STUDY_NEIGHBOURS,
                           largest=False).indices
    order_tf = torch.topk(tf["out"].reshape(BIG_ANCHORS, -1), STUDY_NEIGHBOURS,
                          largest=False).indices
    changed = (order_f32 != order_tf)
    chunked = patch_dist._sliding_distances(img_d, pat_d, chunk=8)
    sqr_tol = PATCH_SUM_EPS * (float((img_d.double() ** 2).sum()) + BIG_PATCH ** 2 * 3)
    chunk_worst = _dist_close(chunked, f32["out"], sqr_tol)
    note(f"[patch] 10b: 1024x2048 frame, {BIG_ANCHORS} anchors of {BIG_PATCH}^2 "
         f"({flops / 1e12:.2f} TFLOP of cross term): f32 {f32['ms']:.2f} ms "
         f"({flops / f32['ms'] / 1e9:.1f} TFLOP/s), peak +{f32['peak_gib']:.3f} GiB; TF32 "
         f"{tf['ms']:.2f} ms ({flops / tf['ms'] / 1e9:.1f} TFLOP/s), peak "
         f"+{tf['peak_gib']:.3f} GiB; self-match distance at the anchors' centres: f32 max "
         f"{f32['self'].max():.4g} (mean {f32['self'].mean():.4g}), TF32 max "
         f"{tf['self'].max():.4g} (mean {tf['self'].mean():.4g}); TF32 changes the "
         f"{STUDY_NEIGHBOURS}-nearest order of {int(changed.any(dim=1).sum())} of "
         f"{BIG_ANCHORS} anchors ({int(changed.sum())} of {changed.numel()} ranks); max "
         f"|d_tf32 - d_f32| {(tf['out'] - f32['out']).abs().max().item():.4g}; chunks of 8 "
         f"against one conv: worst |d| over its bound {chunk_worst:.3g}")
    note("[patch] 10b: self-match distance per anchor, f32 "
         f"{[round(float(v), 3) for v in f32['self']]}; TF32 "
         f"{[round(float(v), 3) for v in tf['self']]}")
    if chunk_worst > 1.0 or not np.isfinite(f32["self"]).all():
        raise RuntimeError("10b: the chunked distances differ, or a self-match is not finite")
    big_out = {"ms_f32": f32["ms"], "ms_tf32": tf["ms"], "peak_gib": f32["peak_gib"],
               "self_f32_max": float(f32["self"].max()), "self_tf32_max": float(tf["self"].max()),
               "orders_changed": int(changed.any(dim=1).sum())}
    del runs, f32, tf, chunked, order_f32, order_tf, img_d, pat_d

    # class_distances on converted Cityscapes frames, through the loader
    os.environ["CUTMIX_SEG_CONFIG"] = write_config(
        os.path.join(tmp, "seg_study.cfg"), voc_root,
        cityscapes_zip=os.path.join(tmp, "cityscapes.zip"))
    settings._config = None
    ds = datasets.load_dataset("cityscapes", n_val=0, val_seed=0, n_sup=-1, n_unsup=-1,
                               split_seed=12345, split_path=None)["ds_src"]
    ds.train_ndx = ds.train_ndx[:STUDY_FRAMES]
    ids = study.choose_anchors_and_negatives(ds, ds.train_ndx, BIG_ANCHORS,
                                             (BIG_PATCH, BIG_PATCH), np.random.RandomState(1))
    anchors, negatives = study.extract_anchor_and_negative_patches(ds, ids,
                                                                   (BIG_PATCH, BIG_PATCH))
    patch_dist.sliding_window_distance_to_patches(
        ds.get_image(int(ds.train_ndx[0])).astype(np.float64) / 255.0, anchors, "cuda")
    dev_ms = 0.0  # after a warm-up call, as class_distances runs warm below
    for i in ds.train_ndx:
        img = ds.get_image(int(i)).astype(np.float64) / 255.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        patch_dist.sliding_window_distance_to_patches(img, anchors, "cuda")
        dev_ms += (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    res = study.class_distances(ds, ids, anchors, STUDY_NEIGHBOURS, "cuda")
    total_ms = (time.perf_counter() - t0) * 1e3
    res["anchor_negative_img_dir_y_x_cls"] = ids
    res["boundary_dists"] = np.sqrt(((anchors - negatives) ** 2).sum(axis=(1, 2, 3)))
    pkl = os.path.join(tmp, "study.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(res, f)
    summary = plot_patch_distances.distance_summary(plot_patch_distances.load_results([pkl]), 10)
    for i, row in enumerate(ids):
        if not np.array_equal(res["same_image_intra_class_coords"][i][0], row[[0, 2, 3]]):
            raise RuntimeError(f"10b: anchor {i}'s nearest same-image window is not itself")
    h, w = ds.get_image(int(ds.train_ndx[0])).shape[:2]
    note(f"[patch] 10b: class_distances, {STUDY_FRAMES} converted Cityscapes frames {h}x{w}, "
         f"{BIG_ANCHORS} anchors of {BIG_PATCH}^2, {STUDY_NEIGHBOURS} neighbours: "
         f"{total_ms:.1f} ms, of it distance maps on the card and their copy "
         f"{dev_ms:.1f} ms, host ranking (argsort) {total_ms - dev_ms:.1f} ms; "
         f"k=10 means: intra same-image median {np.nanmedian(summary['same_image_intra']):.4f}, "
         f"inter {np.nanmedian(summary['same_image_inter']):.4f}, across-boundary "
         f"{np.median(summary['boundary']):.4f}; boundary farther than the intra mean for "
         f"{summary['frac_boundary_farther']:.3f} of anchors")

    # the two studies' statistics: input distribution on those frames (the
    # synthetic VOC tree's blocks are apart by a 255 band: no class boundary),
    # colour on the VOC tree
    t0 = time.perf_counter()
    ratios = input_study.boundary_ratios(ds, input_study.pick_images(ds, STUDY_FRAMES, 12345),
                                         15, "cuda")
    voc = datasets.load_dataset("pascal", n_val=-1, val_seed=131, n_sup=-1, n_unsup=-1,
                                split_seed=12345, split_path=None)["ds_src"]
    originals = colour_study.load_originals(voc, 4, 0)
    augmented = colour_study.jittered_variants(originals, 6, colour_study.study_config(),
                                               torch.Generator(device="cuda").manual_seed(0))
    hists = colour_study.channel_histograms(originals, augmented)
    if not (np.isfinite(ratios).all() and len(augmented) == 24
            and all(a.min() >= 0.0 and a.max() <= 1.0 for a in augmented)):
        raise RuntimeError(f"10b: study statistics: ratios {ratios}")
    note(f"[patch] 10b: input-distribution boundary / non-boundary ratios (15^2) "
         f"{np.round(ratios, 4).tolist()}; colour study on the VOC tree: 4 images x 6 "
         "variants, mean R/G/B before " + "/".join(
             f"{np.concatenate([o[..., c].ravel() for o in originals]).mean():.3f}"
             for c in range(3)) + " after " + "/".join(
             f"{np.concatenate([a[..., c].ravel() for a in augmented]).mean():.3f}"
             for c in range(3)) + f", {len(hists)} channel histograms; "
         f"{time.perf_counter() - t0:.1f} s; {build.launch_counts.get(KERNEL, 0)} "
         f"{KERNEL} launches")
    return {"big": big_out, "study_ms": total_ms, "study_device_ms": dev_ms,
            "launches": build.launch_counts.get(KERNEL, 0)}


def rank_main(argv) -> int:
    """A rank process of phase 7a (two cards; ``out_dir`` is the results
    root), 7b, 8a, 8b, 11a, 12a or 12b-c."""
    kind, out_dir = argv
    rank = int(os.environ["RANK"])
    run = {"ddp_trainer": lambda: _ddp_trainer_rank(out_dir), "ddp_steps": _ddp_steps_rank,
           "spatial_steps": _spatial_steps_rank,
           "spatial_trainer": lambda: _spatial_trainer_rank(out_dir),
           "spatial_lines": lambda: _spatial_lines_rank(out_dir),
           "family_steps": lambda: _spatial_steps_rank(FAMILY_CASES),
           "family_lines": lambda: _spatial_lines_rank(out_dir, FAMILY_LINES)}[kind]
    torch.save(run(), os.path.join(out_dir, f"{kind}_{rank}.pt"))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_build()["nvidia_smi"]
    k = phase_kernel_vs_plain()
    bn = phase_bn_kernels()
    # float32 convolutions and matrix products without TF32 from here on: the
    # card-against-CPU comparisons of the later phases assume it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    full_algos = {}
    for algo in FULL_ALGOS:
        torch.cuda.empty_cache()
        full_algos[algo] = phase_full_step(algo)
    note("[full] bare steps in this call: " + ", ".join(
        f"{a} {r['ms_per_step']:.2f} ms/step ({r['img_per_s']:.2f} img/s, peak "
        f"{r['peak_mem_gib']:.2f} GiB)" for a, r in full_algos.items()))
    accum = {}
    for name in ACCUM_STEPS:
        dense = name.startswith("densenet")
        torch.cuda.empty_cache()
        accum[f"{name} K={ACCUM_K}"] = phase_accum_step(
            name, ACCUM_K, *((DENSE_WARMUP, DENSE_ITERS) if dense else (WARMUP, ITERS)))
    note(f"[accum step] grad_accum {ACCUM_K} in this call: " + ", ".join(
        f"{n} {r['ms_per_step']:.2f} ms/step, peak {r['peak_mem_gib']:.2f} GiB"
        for n, r in sorted(accum.items())))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        voc_root = write_voc_tree(os.path.join(tmp, "VOC2012"), VOC_TRAIN, VOC_VAL, seed=0,
                                  sbd_train=SBD_TRAIN_AUG)
        note(f"[recipes] synthetic VOC tree, {VOC_TRAIN} + {VOC_VAL} images and the SBD split's "
             f"{SBD_TRAIN_AUG} linked train_aug names, written in {time.perf_counter() - t0:.2f} s")
        trainer = phase_trainer(voc_root)
        trainers = phase_trainers_algos(
            voc_root, {a: r["ms_per_step"] for a, r in full_algos.items()})
        isic_zip = write_isic_zip(os.path.join(tmp, "isic2017.zip"), ISIC_TRAIN, ISIC_VAL, seed=0)
        isic = phase_isic_trainers(tmp, voc_root, isic_zip)
        recipes = phase_recipe_datasets(tmp, voc_root, isic_zip)
        torch.cuda.empty_cache()
        t7 = time.perf_counter()
        os.environ["CUTMIX_SEG_CONFIG"] = write_config(os.path.join(tmp, "seg.cfg"), voc_root)
        settings._config = None
        ddp = phase_ddp_trainer(voc_root)
        ddp_steps = phase_ddp_steps(tmp)
        multi_seed = phase_multi_seed(voc_root)
        note(f"[phase 7] {time.perf_counter() - t7:.1f} s")
        torch.cuda.empty_cache()
        t8 = time.perf_counter()
        spatial_steps = phase_spatial_steps(tmp)
        spatial_trainer = phase_spatial_trainer(tmp, voc_root)
        note(f"[phase 8] {time.perf_counter() - t8:.1f} s")
        torch.cuda.empty_cache()
        t9 = time.perf_counter()
        serving = phase_serving(tmp)
        tools = phase_tools(trainer)
        toy2d = phase_toy2d(tmp)
        note(f"[phase 9] {time.perf_counter() - t9:.1f} s")
        torch.cuda.empty_cache()
        t10 = time.perf_counter()
        sweep = phase_sweep(tmp)
        patch_study = phase_patch_study(tmp, voc_root)
        note(f"[phase 10] {time.perf_counter() - t10:.1f} s")
        torch.cuda.empty_cache()
        t11 = time.perf_counter()
        lines = phase_spatial_lines(tmp, voc_root)
        native = phase_native_decoder(voc_root)
        note(f"[phase 11] {time.perf_counter() - t11:.1f} s")
        torch.cuda.empty_cache()
        t12 = time.perf_counter()
        family_steps = phase_spatial_steps(tmp, FAMILY_CASES, "12a")
        family_lines = phase_spatial_lines(tmp, voc_root, FAMILY_LINES, isic_zip, "12b-c")
        note(f"[phase 12] {time.perf_counter() - t12:.1f} s")
    kernels = [{
        "name": KERNEL, "route": "cuda",
        "source": "cutmix_seg_tpu_torch/csrc/cutmix_blend.cu",
        "replaces": "cutmix_seg_tpu/ops/pallas_cutmix.py:46",
        "launches": trainer["launches"], "max_abs_err": k["max_abs_err"],
        "launches_by_path": {"trainer (phase 6)": trainer["launches"],
                             "trainer --resume (phase 6)": trainer["launches_resume"],
                             **{f"step {a} (phase 4b)": r["launches"].get(KERNEL, 0)
                                for a, r in full_algos.items()},
                             **{f"trainer {a} (phase 6b)": r["launches"]
                                for a, r in trainers.items()},
                             **{f"trainer ISIC {n} (phase 6c)": r["launches"]
                                for n, r in isic.items() if n != "v3plus_cutmix"},
                             "trainer v3+ cutmix (phase 6c)": isic["v3plus_cutmix"]["launches"],
                             **{f"step {n} (phase 4d)": r["launches"]
                                for n, r in accum.items()},
                             "trainer ISIC cutmix, store resident (phase 6c)":
                                 isic["cutmix"]["launches"],
                             "trainer ISIC cutmix, streamed (phase 6d)":
                                 recipes["isic_store"]["off_run"]["launches"],
                             "trainer pascal_aug cutmix (phase 6d)":
                                 recipes["pascal_aug"]["launches"],
                             "trainer Cityscapes cutmix (phase 6d)":
                                 recipes["cityscapes"]["launches"],
                             "trainer VOC cutmix --data_on_device on (phase 6d)":
                                 recipes["voc_on"]["launches"],
                             "trainer DDP (phase 7a)": ddp["launches"],
                             "step 2 ranks gloo (phase 7b)": ddp_steps["launches"],
                             "trainer multi-seed K=2 (phase 7c)": multi_seed["launches"],
                             "step H split over 2 ranks gloo (phase 8a)":
                                 spatial_steps["launches"],
                             "trainer Cityscapes cutmix --spatial_train 2, rank 0 (phase 8b)":
                                 spatial_trainer["launches"][0],
                             "trainer Cityscapes cutmix --spatial_train 2, rank 1 (phase 8b)":
                                 spatial_trainer["launches"][1],
                             "trainer Cityscapes cutmix world 1 (phase 8b)":
                                 spatial_trainer["launches_world1"],
                             "serving export + calls (phase 9a)": serving["launches"],
                             "evaluate_model (phase 9b)": tools["launches"],
                             "toy2d steps + recipe lines (phase 9c)": toy2d["launches"],
                             **{f"sweep {arm} arm, {SWEEP_SEEDS} seeds x {SWEEP_ITERS} "
                                f"iterations (phase 10a)": r["launches"]
                                for arm, r in sweep["per_arm"].items()},
                             "patch-distance study (phase 10b)": patch_study["launches"],
                             **{f"trainer Cityscapes {d} --spatial_train 2, rank {r} "
                                f"(phase 11a)": x["launches"][r]
                                for d, x in lines.items() if d != "ranks_s" for r in (0, 1)},
                             **{f"trainer Cityscapes {d} world 1 (phase 11a)":
                                x["launches_world1"]
                                for d, x in lines.items() if d != "ranks_s"},
                             "step H split over 2 ranks gloo, PSPNet / ResUNet / DenseUNet "
                             "(phase 12a)": family_steps["launches"],
                             **{f"trainer {d} --spatial_train 2, rank {r} (phase 12b-c)":
                                x["launches"][r]
                                for d, x in family_lines.items() if d != "ranks_s"
                                for r in (0, 1)},
                             **{f"trainer {d} world 1 (phase 12b-c)": x["launches_world1"]
                                for d, x in family_lines.items() if d != "ranks_s"}},
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "kernel_us": k["ms"] * 1e3, "plain_us": k["plain_ms"] * 1e3,
        "bound_us": k["bound_ms"] * 1e3, "ms_bf16": k["ms_bf16"],
        "bound_ms_bf16": k["bound_ms_bf16"], "yardstick_gbps": k["yardstick_gbps"],
        "ms_224": k["ms_224"], "plain_ms_224": k["plain_ms_224"],
        "bound_ms_224": k["bound_ms_224"], "ms_city": k["ms_city"],
        "ms_city_bf16": k["ms_city_bf16"], "plain_ms_city": k["plain_ms_city"],
        "bound_ms_city": k["bound_ms_city"], "bound_ms_city_bf16": k["bound_ms_city_bf16"],
        "ms_sweep": k["ms_sweep"], "plain_ms_sweep": k["plain_ms_sweep"],
        "bound_ms_sweep": k["bound_ms_sweep"],
    }, {
        "name": "bn_train", "route": "cuda", "source": "cutmix_seg_tpu_torch/csrc/bn_train.cu",
        "replaces": None, "kernels": list(batchnorm.KERNELS),
        "launches_by_path": {
            **{f"trainer ISIC {n} (phase 6c)": r["bn_launches"]
               for n, r in isic.items() if n != "v3plus_cutmix"},
            "trainer v3+ cutmix (phase 6c)": isic["v3plus_cutmix"]["bn_launches"],
            **{f"step {n} (phase 4d)": r["bn_launches"] for n, r in accum.items()}},
        "densenet161_calls": bn["calls"], "densenet161_shapes": bn["shapes"],
        "worst_gap": bn["worst"], "mesh_worst_gap": bn["mesh_worst"],
        "iteration_ms": bn["iteration_ms"], "iteration_bound_ms": bn["iteration_bound_ms"],
        "timed_us": {str(s): {k: [round(t * 1e3, 3) for t in v] for k, v in r.items()}
                     for s, r in bn["timed"].items()},
    }]
    note(f"[done] {time.perf_counter() - t_start:.1f} s")
    note(smi)  # again beside the results: the tail of the output is what is kept
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-of"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
