"""Augmentation-driven consistency step, aug_mt (port of
cutmix_seg_tpu.semisup.aug_cons, grad_accum == 1).

The two elements of each unsupervised pair are two crops of one image with
different geometry. One step, in the JAX step's order:
  1. a no-grad train-mode teacher forward on element 0 (``ux0``), in
     float32;
  2. its logits, its probabilities and element 0's valid mask warped into
     element 1's frame with the pair's relative transform ``xf0_to_1`` (grid
     space, align_corners=True, zeros outside: ``ops.resample``);
  3. loss mask = warped um0 * um1; the confidence is the max of the warped
     probabilities;
  4. the student forward/backward over ``[sup_x | ux1]`` (two forwards with
     training BN): CE(ignore) +
     cons_sum * ramp * cons_weight; prob-space losses take the warped
     probabilities as targets, logit-space losses the warped logits;
  5. the optimiser step, then the EMA teacher update.

The reference's 'logits_var' branch reuses a stale probability delta and so
computes 'var' (reference: train_seg_semisup_aug_mt.py:370-374); the JAX
package computes the logit-space loss, and so does the port.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.nn import functional as F

from cutmix_seg_tpu_torch.core.train_state import TrainState
from cutmix_seg_tpu_torch.ops.resample import grid_sample_affine
from cutmix_seg_tpu_torch.semisup import losses as L
from cutmix_seg_tpu_torch.semisup.stepcore import (
    ConsistencyCommon,
    confidence_px,
    finish_step,
    prepare_nets,
    refuse_unported,
    student_backward,
    teacher_forward,
)

__all__ = ["AugConsConfig", "make_aug_cons_step"]


@dataclasses.dataclass(frozen=True)
class AugConsConfig(ConsistencyCommon):
    pass


def make_aug_cons_step(model, opt, cfg: AugConsConfig):
    """Build the step function.

    batch dict (NHWC, on the state's device): sup_x, sup_y, ux0 (teacher
    image), ux1 (student image), um0, um1 (valid masks (N, H, W, 1)),
    xf0_to_1 ((N, 2, 3) grid-space matrices from element 1's frame into
    element 0's).

    Returns ``step(state, batch, ramp) -> (state, metrics)``.
    """
    refuse_unported(cfg)
    use_cons = cfg.cons_weight > 0.0

    def step(state: TrainState, batch, ramp):
        teacher = prepare_nets(cfg, state)
        x1 = loss_mask = conf_px = per_px_fn = None
        if use_cons:
            x1 = batch["ux1"]
            hw = tuple(x1.shape[1:3])
            logits_tea = teacher_forward(cfg, teacher, batch["ux0"]).float()
            with torch.no_grad():
                theta = batch["xf0_to_1"].float()
                prob_tea = F.softmax(logits_tea, dim=-1)
                logits_tea_in_stu = grid_sample_affine(logits_tea, theta, hw)
                prob_tea_in_stu = grid_sample_affine(prob_tea, theta, hw)
                um0_in_stu = grid_sample_affine(batch["um0"].float(), theta, hw)
                loss_mask = um0_in_stu * batch["um1"].float()
                conf_px = confidence_px(cfg, prob_tea_in_stu.amax(dim=-1, keepdim=True))

            def per_px_fn(logits_stu):
                return L.consistency_from_prob_targets(
                    cfg.cons_loss_fn, logits_stu.float(), logits_tea_in_stu, prob_tea_in_stu)

        metrics = student_backward(cfg, state.student, batch, x1, per_px_fn, loss_mask,
                                   conf_px, ramp)
        return finish_step(state, opt, cfg), metrics

    return step
