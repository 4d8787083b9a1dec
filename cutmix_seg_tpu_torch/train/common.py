"""Shared trainer plumbing on one device (port of
cutmix_seg_tpu.train.common): model and optimiser configuration, the device
augmentation of host batches, the evaluation pass and the NaN bail-out
(reference: train_seg_semisup_mask_mt.py:85-144,479-577).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cutmix_seg_tpu_torch.aug.device import augment_batch, border_for_mode
from cutmix_seg_tpu_torch.core.schedules import make_lr_schedule
from cutmix_seg_tpu_torch.core.train_state import OptimizerConfig
from cutmix_seg_tpu_torch.data.loader import eval_batches
from cutmix_seg_tpu_torch.eval.evaluator import eval_confusion, predict
from cutmix_seg_tpu_torch.models import registry
from cutmix_seg_tpu_torch.ops.colour import ColourJitterConfig, sample_colour_params
from cutmix_seg_tpu_torch.ops.iou import EvaluatorIoU


def epoch_stream_seed(base_seed: int, epoch_i: int) -> int:
    """Epoch-folded base for host-stream seeds: host randomness (sample
    order, geometric parameters) is a pure function of (seed, epoch), so a
    --resume from an epoch-boundary checkpoint continues the run exactly
    (the per-stream offsets added on top stay well below the stride)."""
    return base_seed + epoch_i * 100003


def epoch_colour_seed(base_seed: int, epoch_i: int) -> int:
    """Seed of the epoch's colour-jitter generator, a pure function of
    (base_seed, epoch) (the JAX package folds the epoch into a key instead:
    ``epoch_colour_key``). Disjoint from the state's box generator, which is
    seeded with ``base_seed``."""
    return (base_seed + 40) * 100003 + epoch_i + 1


def parse_crop_size(crop_size: str):
    if crop_size == "":
        return None
    return tuple(int(x.strip()) for x in crop_size.split(","))


def parse_prop_range(s: str):
    if ":" in s:
        a, b = s.split(":")
        return (float(a.strip()), float(b.strip()))
    v = float(s)
    return (v, v)


def build_model(arch: str, num_classes: int, compute_dtype: str = "bfloat16",
                pretrained: bool = True):
    dtype = {"bfloat16": torch.bfloat16, "float32": None}[compute_dtype]
    return registry.get(arch)(num_classes, dtype=dtype, pretrained=pretrained)


def resolve_mean_std(model, ds):
    """Net overrides dataset stats (reference: seg_transforms.get_mean_std)."""
    mean, std = ds.get_mean_std()
    if model.mean is not None:
        mean = model.mean
    if model.std is not None:
        std = model.std
    return np.asarray(mean, np.float64), np.asarray(std, np.float64)


def build_optimizer_config(opt_type, learning_rate, lr_sched, lr_step_epochs,
                           lr_step_gamma, lr_poly_power, total_iters,
                           iters_per_epoch, sgd_momentum, sgd_nesterov,
                           sgd_weight_decay) -> OptimizerConfig:
    sched = make_lr_schedule(
        lr_sched, learning_rate, total_iters, step_epochs=lr_step_epochs,
        step_gamma=lr_step_gamma, poly_power=lr_poly_power,
        iters_per_epoch=iters_per_epoch)
    return OptimizerConfig(
        opt_type=opt_type,
        learning_rate=learning_rate,
        sgd_momentum=sgd_momentum,
        sgd_nesterov=sgd_nesterov,
        sgd_weight_decay=sgd_weight_decay,
        lr_schedule=sched,
    )


def separable_for_geom(geom) -> bool:
    """Whether the warp can run on the separable matrix-product path: the
    'crop' / 'crop_scale_hung' families produce diagonal affines unless the
    diagonal (axis-swapping) flip is enabled."""
    return geom.mode in ("crop", "crop_scale_hung") and not geom.hvflip


def to_device(host_batch: Dict[str, np.ndarray], device: torch.device):
    """Host numpy arrays -> tensors on ``device``. To a CUDA device the copy
    goes through pinned memory without waiting for the device, so it queues
    behind the previous step instead of stalling the host."""
    if device.type == "cpu":
        return {k: torch.from_numpy(np.asarray(v)) for k, v in host_batch.items()}
    return {k: torch.from_numpy(np.asarray(v)).pin_memory().to(device, non_blocking=True)
            for k, v in host_batch.items()}


@dataclasses.dataclass
class DeviceAugmentor:
    """Applies the device augmentation to host batches already on the
    device (``to_device``). ``mean``/``std`` are best float32 tensors on
    that device: a host array is copied to the device on every call."""

    mean: torch.Tensor
    std: torch.Tensor
    crop_hw: Tuple[int, int]
    geom_mode: str
    colour: Optional[ColourJitterConfig] = None
    separable: bool = False

    def _augment(self, batch, with_labels: bool, colour):
        return augment_batch(
            batch["canvas"], batch.get("labels"), batch["m"], batch["sizes"],
            batch["interp"], self.mean, self.std, colour,
            out_hw=self.crop_hw, with_labels=with_labels,
            border=border_for_mode(self.geom_mode), separable=self.separable)

    def sup(self, batch) -> Dict[str, torch.Tensor]:
        return self._augment(batch, True, None)

    def unsup(self, batch, generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        """The unsupervised pair: 'image' for the teacher, 'image_stu' (the
        colour-jittered copy when colour jitter is on, drawn from
        ``generator``) for the student, and 'mask'."""
        colour = None
        if self.colour is not None:
            colour = sample_colour_params(generator, batch["canvas"].shape[0], self.colour)
        out = self._augment(batch, False, colour)
        out.setdefault("image_stu", out["image"])
        return out


def evaluate(net, source, indices, batch_size, num_classes, mean, std,
             block_size, device, fill_holes=False):
    """Full eval pass of ``net`` on ``device`` -> per-class IoU array
    (reference metric semantics). Each batch's confusion matrix is added up
    on the device and fetched once; with ``fill_holes`` the predictions come
    to the host per batch for scipy's hole filling."""
    ev = EvaluatorIoU(num_classes, fill_holes=fill_holes)
    cm = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    for batch in eval_batches(source, indices, batch_size, block_size):
        placed = to_device({k: batch[k] for k in ("canvas", "labels", "sizes")}, device)
        if fill_holes:
            pred, y = predict(net, placed, mean, std)
            n = batch["count"]
            ev.update_batch(pred[:n].cpu().numpy(), y[:n].cpu().numpy())
        else:
            cm += eval_confusion(net, placed, num_classes, mean, std)
    ev.update_cm(cm)
    return ev.score()


def check_nan(value: float) -> bool:
    """The reference's bail-out (train_seg_semisup_mask_mt.py:469-472)."""
    if np.isnan(value):
        print("NaN detected; network dead, bailing.")
        return True
    return False
