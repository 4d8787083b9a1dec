"""Pieces shared by the semi-supervised train steps (port of
cutmix_seg_tpu.semisup.stepcore): the common options, confidence gating, the
masked per-sub-batch consistency reduction, the nets' mode for a step, the
teacher's forwards, the student's forward/backward and the end of a step
(optimiser update, EMA teacher update, step advance).

BN and dropout follow the JAX steps: every forward but VAT's direction net
runs in train mode, so dropout draws masks (from the state's generator) in
the teacher too; with training BN (``freeze_bn=False``) each forward
normalises with its batch's statistics and updates the running ones, one
forward after the other, and the EMA then mixes the teacher's updated
running statistics with the student's. The pi-model's teacher pass is the
student's own forward, whose updated statistics the JAX step discards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from cutmix_seg_tpu_torch.core.train_state import Optimizer, TrainState
from cutmix_seg_tpu_torch.models.common import (
    running_stats_kept,
    set_dropout_generator,
    set_freeze_bn,
)
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
        raise NotImplementedError("grad_accum > 1 is not ported yet (ROADMAP A2)")


def prepare_nets(cfg: ConsistencyCommon, state: TrainState) -> torch.nn.Module:
    """Set the BN mode (``cfg.freeze_bn``) and the dropout generator (the
    state's) of the student and the teacher for a step; returns the teacher
    net (the student itself in pi-model mode)."""
    nets = [state.student] + ([state.teacher] if cfg.mean_teacher else [])
    for net in nets:
        set_freeze_bn(net, cfg.freeze_bn)
        set_dropout_generator(net, state.generator)
    return nets[-1]


@torch.no_grad()
def teacher_forward(cfg: ConsistencyCommon, teacher: torch.nn.Module,
                    x: torch.Tensor) -> torch.Tensor:
    """A no-grad train-mode teacher forward; in pi-model mode it leaves the
    student's running statistics as they were."""
    if cfg.mean_teacher:
        return teacher(x)
    with running_stats_kept(teacher):
        return teacher(x)


def teacher_pair(cfg: ConsistencyCommon, teacher: torch.nn.Module,
                 x0: torch.Tensor, x1: torch.Tensor):
    """The teacher's logits of two unsupervised batches: one forward over
    ``[x0 | x1]`` under frozen BN (the same math), else two forwards, x0's
    statistics updated before x1's."""
    if cfg.freeze_bn:
        both = teacher_forward(cfg, teacher, torch.cat([x0, x1]))
        return both[:x0.shape[0]], both[x0.shape[0]:]
    return teacher_forward(cfg, teacher, x0), teacher_forward(cfg, teacher, x1)


def student_backward(cfg: ConsistencyCommon, student: torch.nn.Module, batch,
                     x_cons: Optional[torch.Tensor],
                     per_px_fn: Callable[[torch.Tensor], torch.Tensor],
                     loss_mask: Optional[torch.Tensor], conf_px: Optional[torch.Tensor],
                     ramp: float, sup_loss_fn: Optional[Callable] = None) -> dict:
    """The student's loss and backward: CE (ignore) on ``sup_x`` plus, with
    ``x_cons``, ``ramp * cons_weight`` times the masked consistency of
    ``per_px_fn(logits of x_cons)``; ``sup_loss_fn(logits, labels)``
    replaces the CE. Under frozen BN one forward over
    ``[sup_x | x_cons]`` is the JAX step's two forwards; with training BN
    the two run in turn, sup_x's statistics updated first. Leaves the
    gradients in ``.grad``; returns the metrics (device tensors)."""
    sup_x = batch["sup_x"]
    n = sup_x.shape[0]
    logits_cons = None
    if x_cons is not None and cfg.freeze_bn and sup_x.shape[1:] == x_cons.shape[1:]:
        logits = student(torch.cat([sup_x, x_cons]))
        logits_sup, logits_cons = logits[:n], logits[n:]
    else:
        logits_sup = student(sup_x)
        if x_cons is not None:
            logits_cons = student(x_cons)
    if sup_loss_fn is None:
        sup_loss = L.cross_entropy_ignore(logits_sup, batch["sup_y"], cfg.ignore_value)
    else:
        sup_loss = sup_loss_fn(logits_sup, batch["sup_y"])
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
