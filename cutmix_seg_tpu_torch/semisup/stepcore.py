"""Pieces shared by the semi-supervised train steps (port of
cutmix_seg_tpu.semisup.stepcore): the common options, confidence gating, the
masked per-sub-batch consistency reduction, the student's forward/backward
and the end of a step (optimiser update, EMA teacher update, step
advance)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from cutmix_seg_tpu_torch.core.train_state import Optimizer, TrainState
from cutmix_seg_tpu_torch.semisup import losses as L
from cutmix_seg_tpu_torch.semisup.ema import ema_update, float_tensors


@dataclasses.dataclass(frozen=True)
class ConsistencyCommon:
    """Options shared by every consistency algorithm (CLI surface parity)."""

    cons_loss_fn: str = "var"
    cons_weight: float = 1.0
    conf_thresh: float = 0.97
    conf_per_pixel: bool = False
    freeze_bn: bool = True
    mean_teacher: bool = True
    teacher_alpha: float = 0.99
    unsup_batch_ratio: int = 1
    ignore_value: int = 255
    grad_accum: int = 1


def masked_consistency(cfg: ConsistencyCommon, per_px: torch.Tensor,
                       loss_mask: torch.Tensor, conf_px: Optional[torch.Tensor]):
    """Apply the valid mask and confidence gate and reduce per sub-batch.

    per_px, loss_mask: (R*B, H, W, 1); conf_px: per-pixel confidence mask or
    None (conf_thresh == 0). Returns (sum over the R sub-batch means, their
    mean, conf_rate)."""
    R = cfg.unsup_batch_ratio

    def subbatch_mean(arr):
        return arr.reshape(R, -1).mean(dim=1)

    if conf_px is not None:
        conf_rates = subbatch_mean(conf_px)
        if cfg.conf_per_pixel:
            masked = subbatch_mean(per_px * (loss_mask * conf_px))
        else:
            masked = subbatch_mean(per_px * loss_mask) * conf_rates
        conf_rate = conf_rates.mean()
    else:
        masked = subbatch_mean(per_px * loss_mask)
        conf_rate = torch.ones((), dtype=torch.float32, device=per_px.device)
    return masked.sum(), masked.mean(), conf_rate


def confidence_px(cfg: ConsistencyCommon, conf_tea: torch.Tensor):
    """Per-pixel confidence mask from (R*B, H, W, 1) teacher confidences."""
    if cfg.conf_thresh > 0.0:
        return (conf_tea >= cfg.conf_thresh).float()
    return None


def refuse_unported(cfg: ConsistencyCommon) -> None:
    """Raise for the step options the port does not run yet."""
    if cfg.grad_accum > 1:
        raise NotImplementedError("grad_accum > 1 is not ported yet")
    if not cfg.freeze_bn:
        # flax updates BN running variance with the biased batch variance,
        # torch's batch_norm with the unbiased one: training BN needs its own
        # parity work
        raise NotImplementedError("training BN (freeze_bn=False) is not ported yet")


def student_backward(cfg: ConsistencyCommon, student: torch.nn.Module, batch,
                     x_cons: Optional[torch.Tensor],
                     per_px_fn: Callable[[torch.Tensor], torch.Tensor],
                     loss_mask: Optional[torch.Tensor], conf_px: Optional[torch.Tensor],
                     ramp: float) -> dict:
    """The student's loss and backward: CE (ignore) on ``sup_x`` plus, with
    ``x_cons``, ``ramp * cons_weight`` times the masked consistency of
    ``per_px_fn(logits of x_cons)``. Under frozen BN one forward over
    ``[sup_x | x_cons]`` is the JAX step's two forwards. Leaves the
    gradients in ``.grad``; returns the metrics (device tensors)."""
    sup_x = batch["sup_x"]
    n = sup_x.shape[0]
    logits_cons = None
    if x_cons is not None and sup_x.shape[1:] == x_cons.shape[1:]:
        logits = student(torch.cat([sup_x, x_cons]))
        logits_sup, logits_cons = logits[:n], logits[n:]
    else:
        logits_sup = student(sup_x)
        if x_cons is not None:
            logits_cons = student(x_cons)
    sup_loss = L.cross_entropy_ignore(logits_sup, batch["sup_y"], cfg.ignore_value)
    metrics = {"sup_loss": sup_loss.detach()}
    total = sup_loss
    if logits_cons is not None:
        loss_sum, loss_mean, conf_rate = masked_consistency(
            cfg, per_px_fn(logits_cons), loss_mask, conf_px)
        total = total + loss_sum * ramp * cfg.cons_weight
        metrics["cons_loss"] = loss_mean.detach()
        metrics["conf_rate"] = conf_rate.detach()
    total.backward()
    return metrics


def finish_step(state: TrainState, opt: Optimizer,
                cfg: ConsistencyCommon) -> TrainState:
    """Optimiser update from the student's gradients, EMA teacher update,
    step advance (all in place)."""
    opt.step()
    opt.zero_grad()
    if cfg.mean_teacher:
        ema_update(float_tensors(state.teacher), float_tensors(state.student),
                   cfg.teacher_alpha)
    state.step += 1
    return state
