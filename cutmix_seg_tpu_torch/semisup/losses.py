"""Consistency-loss menu, confidence thresholding and supervised CE (port of
cutmix_seg_tpu.semisup.losses), over NHWC logits.

Class-dimension aggregation follows the reference: sum over classes, with
logit-space losses divided by sqrt(num_classes). ``compute_dtype`` is the
dtype of the (N, H, W, C)-scale softmax chain; pixel sums are float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

EPS_BCE = 1e-6


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_value: int = 255,
                         compute_dtype: torch.dtype = torch.float32,
                         count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over the pixels whose label is not
    ``ignore_value`` (torch CrossEntropyLoss(ignore_index=...) semantics).
    ``count`` replaces this batch's valid-pixel count in the denominator:
    under a mesh it is the global count, and the result is this rank's
    share of the global mean.

    :param logits: (N, H, W, C) float
    :param labels: (N, H, W) int
    """
    valid = labels != ignore_value
    safe_labels = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits.to(compute_dtype), dim=-1)
    picked = logp.gather(-1, safe_labels[..., None])[..., 0].float()
    losses = torch.where(valid, -picked, 0.0)
    return losses.sum() / (valid.sum() if count is None else count).clamp_min(1)


def robust_binary_crossentropy(pred: torch.Tensor, tgt: torch.Tensor,
                               eps: float = EPS_BCE) -> torch.Tensor:
    """Elementwise BCE with epsilon guards."""
    inv_tgt = 1.0 - tgt
    inv_pred = 1.0 - pred + eps
    return -(tgt * torch.log(pred + eps) + inv_tgt * torch.log(inv_pred))


def _root_c(logits: torch.Tensor) -> torch.Tensor:
    """sqrt(num_classes), the float32 square root rounded to ``logits``'
    dtype, as a 0-dim tensor on their device: filled there, with no copy
    from the host (a tensor divisor divides where a Python one would be a
    multiply by its reciprocal on the card)."""
    root = float(np.sqrt(np.float32(logits.shape[-1])))
    return torch.full((), root, dtype=logits.dtype, device=logits.device)


def consistency_loss_per_pixel(loss_fn: str, logits_stu: torch.Tensor,
                               logits_tea: torch.Tensor,
                               compute_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """Per-pixel consistency loss (N, H, W, 1) in float32, class dim summed.

    loss_fn: 'var' | 'logits_var' | 'logits_smoothl1' | 'bce' | 'kld'
    """
    stu = logits_stu.to(compute_dtype)
    tea = logits_tea.to(compute_dtype)

    if loss_fn == "var":
        d = F.softmax(stu, dim=-1) - F.softmax(tea, dim=-1)
        return (d * d).sum(dim=-1, keepdim=True).float()
    if loss_fn == "logits_var":
        d = stu - tea
        return ((d * d).sum(dim=-1, keepdim=True) / _root_c(stu)).float()
    if loss_fn == "logits_smoothl1":
        d = torch.abs(stu - tea)
        l = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
        return (l.sum(dim=-1, keepdim=True) / _root_c(stu)).float()
    if loss_fn == "bce":
        p_stu = F.softmax(stu, dim=-1)
        p_tea = F.softmax(tea, dim=-1)
        return robust_binary_crossentropy(p_stu, p_tea).sum(
            dim=-1, keepdim=True).float()
    if loss_fn == "kld":
        logp_stu = F.log_softmax(stu, dim=-1)
        p_tea = F.softmax(tea, dim=-1)
        logp_tea = F.log_softmax(tea, dim=-1)
        # KL(p_tea || p_stu), as F.kl_div(input=logp_stu, target=p_tea)
        return (p_tea * (logp_tea - logp_stu)).sum(dim=-1, keepdim=True).float()
    raise ValueError(f"unknown consistency loss {loss_fn!r}")


def consistency_from_prob_targets(loss_fn: str, logits_stu: torch.Tensor,
                                  logits_tea: torch.Tensor,
                                  prob_tea: torch.Tensor) -> torch.Tensor:
    """Per-pixel consistency loss (N, H, W, 1) against teacher probability
    targets that are not ``softmax(logits_tea)``: ICT blends the teacher's
    probabilities across the mixup pair, aug_mt warps them into the
    student's frame. Prob-space losses (var, bce, kld) take ``prob_tea`` as
    the target; logit-space losses (logits_var, logits_smoothl1) take
    ``logits_tea``. Inputs are float32."""
    if loss_fn == "var":
        d = F.softmax(logits_stu, dim=-1) - prob_tea
        return (d * d).sum(dim=-1, keepdim=True)
    if loss_fn in ("logits_var", "logits_smoothl1"):
        return consistency_loss_per_pixel(loss_fn, logits_stu, logits_tea)
    if loss_fn == "bce":
        return robust_binary_crossentropy(
            F.softmax(logits_stu, dim=-1), prob_tea).sum(dim=-1, keepdim=True)
    if loss_fn == "kld":
        logp_stu = F.log_softmax(logits_stu, dim=-1)
        safe_p = torch.clamp_min(prob_tea, 1e-20)
        return (prob_tea * (torch.log(safe_p) - logp_stu)).sum(dim=-1, keepdim=True)
    raise ValueError(f"unknown consistency loss {loss_fn!r}")


def confidence_mask(prob_tea: torch.Tensor, conf_thresh: float, per_pixel: bool):
    """Teacher-confidence gating.

    :param prob_tea: (N, H, W, C) teacher probabilities
    :return: (mask, conf_rate): mask is (N, H, W, 1) if per_pixel, else the
        scalar mean confidence rate; conf_rate is that mean either way.
    """
    conf = prob_tea.amax(dim=-1, keepdim=True)
    m = (conf >= conf_thresh).float()
    rate = m.mean()
    if per_pixel:
        return m, rate
    return rate, rate
