"""Evaluation on one device (port of cutmix_seg_tpu.eval.evaluator, without
the mesh): normalise the raw uint8 eval canvases, run the eval net, take the
argmax and count the batch's confusion matrix, all on the canvases' device.
Padded pixels carry the ignore label, so padding cannot move the metric.
"""

from __future__ import annotations

import torch
from torch import nn

from cutmix_seg_tpu_torch.aug.device import normalise
from cutmix_seg_tpu_torch.models.common import eval_mode
from cutmix_seg_tpu_torch.ops.iou import confusion_matrix


def normalise_eval_batch(batch, mean, std):
    """Normalise a raw eval batch (no geometry at eval time).

    batch: {'canvas': (N, H, W, 3) uint8 images at the canvas origin,
    'labels': (N, H, W) integer (255-filled beyond the true extent),
    'sizes': (N, 2) int true (h, w)}, tensors on one device. Equivalent to
    the identity-matrix warp of ``aug.device.augment_batch``: the valid mask
    comes from the extents and the alpha-trick standardisation applies.
    Returns (x (N, H, W, 3) float32, y (N, H, W) int64, valid (N, H, W, 1)).
    """
    canvas = batch["canvas"]
    sizes = batch["sizes"]
    _, h, w = canvas.shape[:3]
    ys = torch.arange(h, device=canvas.device)[None, :, None]
    xs = torch.arange(w, device=canvas.device)[None, None, :]
    valid = ((ys < sizes[:, 0, None, None]) & (xs < sizes[:, 1, None, None])).float()[..., None]
    x = normalise(canvas.float(), valid, mean, std)
    y = batch["labels"].long()
    return x, y, valid


@torch.no_grad()
def predict(net: nn.Module, batch, mean, std):
    """(pred (N, H, W) int64, y (N, H, W) int64) of a raw eval batch, the
    net in eval mode (running-average BN, no dropout)."""
    x, y, _ = normalise_eval_batch(batch, mean, std)
    with eval_mode(net):
        return net(x).argmax(dim=-1), y


def eval_confusion(net: nn.Module, batch, num_classes: int, mean, std,
                   ignore_value: int = 255) -> torch.Tensor:
    """(C, C) int64 confusion matrix of a raw eval batch, on its device."""
    x, y, _ = normalise_eval_batch(batch, mean, std)
    return eval_confusion_normalised(net, x, y, num_classes, ignore_value)


@torch.no_grad()
def eval_confusion_normalised(net: nn.Module, x: torch.Tensor, y: torch.Tensor,
                              num_classes: int, ignore_value: int = 255) -> torch.Tensor:
    """(C, C) int64 confusion matrix of images already normalised (the
    counterpart of JAX's ``make_eval_cm_fn``), the net in eval mode."""
    with eval_mode(net):
        pred = net(x).argmax(dim=-1)
    return confusion_matrix(pred, y, num_classes, ignore_value)
