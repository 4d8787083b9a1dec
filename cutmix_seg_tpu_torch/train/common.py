"""Shared trainer plumbing (port of cutmix_seg_tpu.train.common): model,
optimiser, geometry and colour configuration, the device augmentation of
host batches, the evaluation pass (alone, or sliced over a mesh of ranks by
images and, with ``--eval_spatial``, by rows) and the NaN bail-out
(reference: train_seg_semisup_mask_mt.py:85-144,479-577).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cutmix_seg_tpu_torch.aug.device import augment_batch, border_for_mode
from cutmix_seg_tpu_torch.aug.params import GeomConfig
from cutmix_seg_tpu_torch.core.schedules import make_lr_schedule
from cutmix_seg_tpu_torch.core.train_state import OptimizerConfig
from cutmix_seg_tpu_torch.data.loader import eval_batches
from cutmix_seg_tpu_torch.eval.evaluator import normalise_eval_batch, predict
from cutmix_seg_tpu_torch.models import registry
from cutmix_seg_tpu_torch.ops.colour import (
    ColourJitterConfig,
    ColourParams,
    sample_colour_params,
)
from cutmix_seg_tpu_torch.models.common import eval_mode
from cutmix_seg_tpu_torch.ops.iou import EvaluatorIoU, confusion_matrix
from cutmix_seg_tpu_torch.parallel import mesh as mesh_mod
from cutmix_seg_tpu_torch.parallel import spatial as spatial_mod
from cutmix_seg_tpu_torch.parallel.mesh import Mesh


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


def build_geom(p: dict, crop_hw, pair: bool) -> GeomConfig:
    """The geometric augmentation of the CLI params; ``pair``: with the
    aug_mt pair options (reference: train_seg_semisup_aug_mt.py CLI)."""
    geom = GeomConfig.from_cli(
        crop_hw, p["aug_scale_hung"], p["aug_max_scale"], p["aug_rot_mag"],
        p["aug_scale_non_uniform"], p["aug_hflip"], p["aug_vflip"], p["aug_hvflip"])
    if pair:
        off = p["aug_offset_range"]
        geom = dataclasses.replace(
            geom, crop_offset=(off, off),
            constrain_rot_scale=not p.get("aug_free_scale_rot", False))
    return geom


def build_colour(p: dict) -> Optional[ColourJitterConfig]:
    """The colour jitter of the CLI params (None without
    --aug_strong_colour)."""
    if not p["aug_strong_colour"]:
        return None
    return ColourJitterConfig(
        brightness=p["aug_colour_brightness"], contrast=p["aug_colour_contrast"],
        saturation=p["aug_colour_saturation"], hue=p["aug_colour_hue"],
        apply_prob=p["aug_colour_prob"], greyscale_prob=p["aug_colour_greyscale_prob"])


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
    that device: a host array is copied to the device on every call. Over
    a ``mesh`` each batch is this rank's data index's rows of the global
    batch (full crops: a spatial step cuts its rows of them), and the colour
    draws are made for the global batch and sliced."""

    mean: torch.Tensor
    std: torch.Tensor
    crop_hw: Tuple[int, int]
    geom_mode: str
    colour: Optional[ColourJitterConfig] = None
    separable: bool = False
    mesh: Optional[Mesh] = None

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
            n = mesh_mod.global_rows(batch["canvas"].shape[0], self.mesh)
            colour = sample_colour_params(generator, n, self.colour)
            if self.mesh is not None:
                colour = ColourParams(*(mesh_mod.local_rows(getattr(colour, f.name), self.mesh)
                                        for f in dataclasses.fields(colour)))
        out = self._augment(batch, False, colour)
        out.setdefault("image_stu", out["image"])
        return out


def eval_batch_size(batch_size: int, mesh: Optional[Mesh]) -> int:
    """The eval batch rounded up to a multiple of the data indices, so
    every one takes an equal slice (padding is metric-neutral: all-255
    labels)."""
    n = 1 if mesh is None else mesh.n_data
    return -(-batch_size // n) * n


def local_count(count: int, n_local: int, mesh: Optional[Mesh]) -> int:
    """How many of this rank's slice of an eval batch are real images (the
    batch's first ``count`` are)."""
    first = 0 if mesh is None else mesh.data_index * n_local
    return min(max(count - first, 0), n_local)


def eval_layout(mesh: Optional[Mesh], spatial: bool) -> Tuple[Optional[Mesh], bool]:
    """(the mesh an eval pass runs over, whether it splits H): alone
    without a mesh; ``--eval_spatial`` over several ranks splits H
    (``spatial_mod.eval_mesh``); else the batch is split over the data
    indices."""
    if mesh is None or not spatial or mesh.size == 1:
        return mesh, False
    return spatial_mod.eval_mesh(mesh), True


def eval_batches_over(source, indices, batch_size, block_size, mesh: Optional[Mesh],
                      spatial: bool):
    """The eval batches of a pass over ``mesh``: the batch rounded up to the
    data indices, and under spatial eval H padded to lcm(h_ways, block_h)
    with zero canvas rows and ignore labels (JAX ``pad_batch_h``)."""
    h_mult = None
    if spatial:
        h_mult = int(np.lcm(spatial_mod.spatial_h_axis_size(mesh), block_size[0]))
    for batch in eval_batches(source, indices, eval_batch_size(batch_size, mesh), block_size):
        yield batch if h_mult is None else spatial_mod.pad_batch_h(batch, h_mult)


def predict_rows(net, batch, mean, std, device, mesh: Optional[Mesh], spatial: bool):
    """(pred, y) int64 of this rank's part of a raw eval batch: its data
    index's images, and under ``spatial`` its rows of them (the net set to
    split H over the mesh's model ranks)."""
    local = mesh_mod.eval_slice({k: batch[k] for k in ("canvas", "labels", "sizes")}, mesh)
    placed = to_device(local, device)
    spatial_mod.set_spatial(net, mesh if spatial else None)
    if not spatial:
        return predict(net, placed, mean, std)
    x, y, _ = normalise_eval_batch(placed, mean, std)
    x, y = spatial_mod.slice_h(x, mesh), spatial_mod.slice_h(y, mesh)
    with torch.no_grad(), eval_mode(net):
        return net(x).argmax(dim=-1), y


def predict_batch(net, batch, mean, std, device, mesh: Optional[Mesh],
                  spatial: bool) -> torch.Tensor:
    """The predictions of a whole raw eval batch on every rank: each rank
    predicts its part (``predict_rows``), then the rows and the images are
    gathered."""
    pred, _ = predict_rows(net, batch, mean, std, device, mesh, spatial)
    if spatial:
        pred = spatial_mod.gather_h(pred, batch["canvas"].shape[1], mesh)
    return pred if mesh is None else mesh_mod.gather_rows(pred, mesh)


def evaluate(net, source, indices, batch_size, num_classes, mean, std,
             block_size, device, fill_holes=False, mesh: Optional[Mesh] = None,
             spatial: bool = False):
    """Full eval pass of ``net`` on ``device`` -> per-class IoU array
    (reference metric semantics). Each batch's confusion matrix is added up
    on the device and fetched once; with ``fill_holes`` the predictions come
    to the host per batch for scipy's hole filling.

    Over a ``mesh`` (JAX's batch-parallel eval) the batch is rounded up to
    a multiple of the data indices, every rank builds the whole batch and
    evaluates its data index's slice (under ``--spatial_train`` the model
    group's rank 0 alone: JAX's replicated copies count once), hole filling
    (per image) runs on those slices' predictions, and the confusion matrix
    is summed over the ranks. ``spatial`` (--eval_spatial) over several
    ranks splits H as well (``eval_layout``): every rank counts the pixels
    of its rows, and hole filling gathers the rows first. With one rank
    JAX's H-sharded eval is the plain pass (H padded to lcm(1, block_h),
    which the eval batches' block padding already is)."""
    mesh, spatial = eval_layout(mesh, spatial)
    ev = EvaluatorIoU(num_classes, fill_holes=fill_holes)
    cm = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    lead = mesh is None or mesh.model_index == 0
    batches = eval_batches_over(source, indices, batch_size, block_size, mesh, spatial)
    for batch in (batches if lead or spatial else ()):
        pred, y = predict_rows(net, batch, mean, std, device, mesh, spatial)
        if not fill_holes:
            cm += confusion_matrix(pred, y, num_classes)
            continue
        if spatial:
            pred = spatial_mod.gather_h(pred, batch["canvas"].shape[1], mesh)
        if lead:
            n = local_count(batch["count"], pred.shape[0], mesh)
            y = mesh_mod.local_rows(batch["labels"], mesh).astype(np.int64)
            ev.update_batch(pred[:n].cpu().numpy(), y[:n])
    spatial_mod.set_spatial(net, None)
    if mesh is not None:
        cm += torch.from_numpy(ev.cm).to(device)
        ev.cm[:] = 0
        dist.all_reduce(cm)
    ev.update_cm(cm)
    return ev.score()


def check_nan(value: float) -> bool:
    """The reference's bail-out (train_seg_semisup_mask_mt.py:469-472)."""
    if np.isnan(value):
        print("NaN detected; network dead, bailing.")
        return True
    return False
