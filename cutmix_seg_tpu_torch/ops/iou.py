"""Per-class IoU from confusion matrices (port of cutmix_seg_tpu.ops.iou).

The reference's evaluator semantics (reference: evaluation.py:6-62): per-class
intersection and union with an ignore value of 255, accumulated over the
whole validation set as integer counts, final score ``I / max(U, 1)``.

``confusion_matrix`` counts on the tensors' device with one exact integer
formulation, an int64 ``bincount`` of ``t * C + p``. It equals both JAX
formulations (the chunked one-hot matmul and the scatter-add) for any pixel
count: nothing passes through float32, so no chunking is needed.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, truth: torch.Tensor, num_classes: int,
                     ignore_value: int = 255) -> torch.Tensor:
    """(C, C) int64 confusion matrix (rows = truth, cols = pred) of a batch.

    ``pred``/``truth``: integer tensors of one shape on one device. A pixel
    counts when its truth is not ``ignore_value`` and both values lie in
    [0, C), as in the JAX one-hot formulation (whose one-hot rows are zero
    otherwise). Uncounted pixels go to an extra bin that is dropped, so the
    count has a fixed size and needs no boolean indexing."""
    c = num_classes
    t = truth.reshape(-1).long()
    p = pred.reshape(-1).long()
    valid = (t != ignore_value) & (t >= 0) & (t < c) & (p >= 0) & (p < c)
    bins = torch.where(valid, t * c + p, c * c)
    return torch.bincount(bins, minlength=c * c + 1)[: c * c].reshape(c, c)


def i_and_u_from_cm(cm: torch.Tensor):
    """Per-class (intersection, union) from a confusion matrix."""
    inter = torch.diagonal(cm)
    return inter, cm.sum(0) + cm.sum(1) - inter


class EvaluatorIoU:
    """Host-side streaming evaluator with the reference's exact scoring.

    Accumulates an exact int64 confusion matrix from batches (tensors on any
    device, or numpy) or from matrices, and scores per-class IoU as
    I / max(U, 1) (reference: evaluation.py:61-62). Optional binary hole
    filling for 2-class problems (ISIC; reference: evaluation.py:52-55) runs
    on the host per sample through scipy.
    """

    def __init__(self, num_classes: int, fill_holes: bool = False):
        if fill_holes and num_classes != 2:
            raise ValueError("fill_holes requires num_classes == 2")
        self.num_classes = num_classes
        self.fill_holes = fill_holes
        self.cm = np.zeros((num_classes, num_classes), dtype=np.int64)

    def update_batch(self, pred, truth, ignore_value: int = 255):
        """Accumulate a batch. pred/truth: (N, H, W) integer arrays."""
        if self.fill_holes:
            from scipy.ndimage import binary_fill_holes

            pred = _host(pred)
            pred = np.stack([binary_fill_holes(p != 0).astype(np.int64) for p in pred])
        pred = torch.as_tensor(pred)
        truth = torch.as_tensor(truth, device=pred.device)
        self.update_cm(confusion_matrix(pred, truth, self.num_classes, ignore_value))

    def update_cm(self, cm):
        """Accumulate an already-reduced confusion matrix."""
        self.cm += _host(cm).astype(np.int64)

    @property
    def intersection(self) -> np.ndarray:
        return np.diagonal(self.cm).astype(np.float64)

    @property
    def union(self) -> np.ndarray:
        return (self.cm.sum(axis=0) + self.cm.sum(axis=1)
                - np.diagonal(self.cm)).astype(np.float64)

    def score(self) -> np.ndarray:
        return self.intersection / np.maximum(self.union, 1.0)

    def miou(self) -> float:
        return float(self.score().mean())


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
