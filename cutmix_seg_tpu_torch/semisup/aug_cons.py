"""Augmentation-driven consistency step, aug_mt (port of
cutmix_seg_tpu.semisup.aug_cons).

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

With ``grad_accum`` K > 1, steps 1-4 run once per strided chunk
(``stepcore.accumulate``): the pair matrices are chunked with the images.
Over a ``mesh`` of ranks the losses are global (``stepcore``); the step
draws nothing. With model ranks (``--spatial_train``) the warp reads
across rows: the teacher runs on this rank's rows of element 0, its
float32 logits are gathered to the full height over the model group (no
gradient), warped whole with the full valid mask, and this rank keeps its
rows of the warped logits, probabilities and mask.

The reference's 'logits_var' branch reuses a stale probability delta and so
computes 'var' (reference: train_seg_semisup_aug_mt.py:370-374); the JAX
package computes the logit-space loss, and so does the port.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.nn import functional as F
from torch.profiler import record_function

from cutmix_seg_tpu_torch.core.train_state import TrainState
from cutmix_seg_tpu_torch.ops.resample import grid_sample_affine
from cutmix_seg_tpu_torch.parallel.spatial import gather_h, slice_batch_h, slice_h
from cutmix_seg_tpu_torch.semisup import losses as L
from cutmix_seg_tpu_torch.semisup.stepcore import (
    ConsistencyCommon,
    accumulate,
    confidence_px,
    finish_step,
    prepare_nets,
    split_scalars,
    step_scalars,
    student_backward,
    teacher_forward,
    validate_accum,
)

__all__ = ["AugConsConfig", "make_aug_cons_step"]


@dataclasses.dataclass(frozen=True)
class AugConsConfig(ConsistencyCommon):
    pass


def make_aug_cons_step(model, opt, cfg: AugConsConfig, mesh=None):
    """Build the step function.

    batch dict (NHWC, on the state's device): sup_x, sup_y, ux0 (teacher
    image), ux1 (student image), um0, um1 (valid masks (N, H, W, 1)),
    xf0_to_1 ((N, 2, 3) grid-space matrices from element 1's frame into
    element 0's).

    Returns ``step(state, batch, ramp) -> (state, metrics)``. ``mesh``: as
    ``make_mask_mt_step``'s.
    """
    if cfg.grad_accum > 1:
        validate_accum(cfg, "aug_mt")
    use_cons = cfg.cons_weight > 0.0
    spatial = mesh is not None and mesh.n_model > 1

    def rows(x):
        return slice_h(x, mesh) if spatial else x

    def step(state: TrainState, batch, ramp):
        ramp = split_scalars(opt, step_scalars(opt, ramp, state.generator.device))
        teacher = prepare_nets(cfg, state, mesh)
        full = {"sup_x": batch["sup_x"], "sup_y": batch["sup_y"]}
        if use_cons:
            full.update(ux0=batch["ux0"], ux1=batch["ux1"], um0=batch["um0"].float(),
                        um1=batch["um1"].float(), xf=batch["xf0_to_1"].float())
        if spatial:
            full = slice_batch_h(full, mesh, per_sample=("xf", "um0"))

        def one_chunk(c):
            x1 = loss_mask = conf_px = per_px_fn = None
            if use_cons:
                x1 = c["ux1"]
                hw = tuple(c["um0"].shape[1:3])  # the full crop
                with record_function("step.teacher"), torch.no_grad():
                    logits_tea = teacher_forward(cfg, teacher, c["ux0"]).float()
                    if spatial:
                        logits_tea = gather_h(logits_tea, hw[0], mesh)
                    prob_tea = F.softmax(logits_tea, dim=-1)
                with record_function("step.perturb"), torch.no_grad():
                    logits_tea_in_stu = rows(grid_sample_affine(logits_tea, c["xf"], hw))
                    prob_tea_in_stu = rows(grid_sample_affine(prob_tea, c["xf"], hw))
                    um0_in_stu = rows(grid_sample_affine(c["um0"], c["xf"], hw))
                    loss_mask = um0_in_stu * c["um1"]
                    conf_px = confidence_px(cfg, prob_tea_in_stu.amax(dim=-1, keepdim=True))

                def per_px_fn(logits_stu):
                    return L.consistency_from_prob_targets(
                        cfg.cons_loss_fn, logits_stu.float(), logits_tea_in_stu,
                        prob_tea_in_stu)

            return student_backward(cfg, state.student, c, x1, per_px_fn, loss_mask,
                                    conf_px, ramp, mesh=mesh)

        metrics = accumulate(cfg.grad_accum, state.student, full, one_chunk, mesh)
        return finish_step(state, opt, cfg), metrics

    return step
