"""CutMix / Cutout mean-teacher train step (port of
cutmix_seg_tpu.semisup.mask_mt, grad_accum == 1).

One step, in the JAX step's order:
  1. box rects sampled on the device from the state's generator (or
     injected by the caller);
  2. 'mix': the CUDA CutMix kernel rasterises the masks and blends the two
     unsupervised batches; 'zero': ``rasterise_masks`` and the Cutout product;
     the loss mask is ``um0 * (1 - m) + um1 * m`` ('zero': ``m * um``);
  3. the no-grad teacher forwards: one over ``[ux0_tea | ux1_tea]`` under
     frozen BN, two in turn with training BN (``stepcore.teacher_pair``);
  4. the teacher-logit blend with the same mask, in ``cons_compute_dtype``;
  5. the softmax-max confidence in ``loss_softmax_dtype`` and the gate;
  6. the student forward/backward over ``[sup_x | x_mix]`` (two forwards
     with training BN);
  7. loss = CE(ignore) + cons_sum * ramp * cons_weight;
  8. the optimiser step, then the EMA teacher update.

Metrics stay device tensors (nothing here waits for the device).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from cutmix_seg_tpu_torch.core.train_state import TrainState
from cutmix_seg_tpu_torch.masks.box_mask import (
    BoxMaskConfig,
    rasterise_masks,
    sample_box_rects,
)
from cutmix_seg_tpu_torch.ops.cutmix import cutmix_blend
from cutmix_seg_tpu_torch.semisup import losses as L
from cutmix_seg_tpu_torch.semisup.stepcore import (
    ConsistencyCommon,
    confidence_px,
    finish_step,
    prepare_nets,
    refuse_unported,
    student_backward,
    teacher_forward,
    teacher_pair,
)

__all__ = ["MaskConsistencyConfig", "make_mask_mt_step"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class MaskConsistencyConfig(ConsistencyCommon):
    mask_mode: str = "mix"  # 'mix' (CutMix) | 'zero' (Cutout)
    box: BoxMaskConfig = BoxMaskConfig((0.5, 0.5))
    # dtype of the blended teacher logits: 'float32' | 'bfloat16'
    cons_compute_dtype: str = "float32"
    # recompute the two loss tails (softmax chains) in the backward pass
    # instead of keeping their (B, H, W, C) intermediates
    remat_loss_chain: bool = False
    # dtype of the loss-side softmax chains themselves; pixel sums stay f32
    loss_softmax_dtype: str = "float32"


def _mix_geometry(cfg: MaskConsistencyConfig, batch, generator, rects):
    """Returns (x_stu_cons, m, loss_mask) for 'mix' / 'zero'."""
    x = batch["ux0_stu"] if cfg.mask_mode == "mix" else batch["ux_stu"]
    n, hw = x.shape[0], tuple(x.shape[1:3])
    if rects is None:
        rects = sample_box_rects(cfg.box, generator, n, hw)
    if cfg.mask_mode == "mix":
        x_stu_cons, m = cutmix_blend(x, batch["ux1_stu"], rects, invert=cfg.box.invert)
        loss_mask = batch["um0"] * (1.0 - m) + batch["um1"] * m
    else:
        m = rasterise_masks(rects, hw, invert=cfg.box.invert, dtype=x.dtype)
        x_stu_cons = x * m
        loss_mask = m * batch["um"]
    return x_stu_cons, m, loss_mask


def _tail(cfg: MaskConsistencyConfig, fn, *args):
    """A loss tail, recomputed in the backward pass under remat_loss_chain."""
    if cfg.remat_loss_chain:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def make_mask_mt_step(model, opt, cfg: MaskConsistencyConfig):
    """Build the step function.

    ``model`` is the SegModel, ``opt`` the optimiser that
    ``create_train_state`` returned with the state.

    batch dict (NHWC; leading dim B for sup, R*B for unsup; images float,
    labels int (N, H, W), valid masks (N, H, W, 1) float), all on the state's
    device:
      sup_x, sup_y
      mix mode: ux0_tea, ux0_stu, um0, ux1_tea, ux1_stu, um1
      zero mode: ux_tea, ux_stu, um

    Returns ``step(state, batch, ramp, rects=None) -> (state, metrics)``;
    ``rects`` (N, n_boxes, 4) float32 replaces the sampled boxes.
    """
    refuse_unported(cfg)
    if cfg.mask_mode not in ("mix", "zero"):
        raise ValueError(f"unknown mask_mode {cfg.mask_mode!r}")
    use_cons = cfg.cons_weight > 0.0
    ldt = _DTYPES[cfg.cons_compute_dtype]
    sdt = _DTYPES[cfg.loss_softmax_dtype]

    def step(state: TrainState, batch, ramp, rects=None):
        teacher = prepare_nets(cfg, state)
        x_stu_cons = loss_mask = conf_px = per_px_fn = None

        # ---- mixing geometry + teacher: all outside the gradient ----
        if use_cons:
            with torch.no_grad():
                x_stu_cons, m, loss_mask = _mix_geometry(
                    cfg, batch, state.generator, rects)
                if cfg.mask_mode == "mix":
                    tea0, tea1 = teacher_pair(cfg, teacher, batch["ux0_tea"], batch["ux1_tea"])
                    m_l = m.to(ldt)
                    logits_tea = tea0.to(ldt) * (1.0 - m_l) + tea1.to(ldt) * m_l
                else:
                    logits_tea = teacher_forward(cfg, teacher, batch["ux_tea"]).to(ldt)
                # only the (.., 1) max-prob map is kept; the gate compares f32
                conf = F.softmax(logits_tea.to(sdt), dim=-1).amax(
                    dim=-1, keepdim=True).float()
                conf_px = confidence_px(cfg, conf)
                loss_mask = loss_mask.float()

            def per_px_fn(logits_stu):
                return _tail(cfg, L.consistency_loss_per_pixel, cfg.cons_loss_fn,
                             logits_stu, logits_tea, sdt)

        # ---- student losses under the gradient ----
        metrics = student_backward(
            cfg, state.student, batch, x_stu_cons, per_px_fn, loss_mask, conf_px, ramp,
            sup_loss_fn=lambda logits, y: _tail(cfg, L.cross_entropy_ignore, logits, y,
                                                cfg.ignore_value, sdt))
        return finish_step(state, opt, cfg), metrics

    return step
