"""CutMix / Cutout mean-teacher train step (port of
cutmix_seg_tpu.semisup.mask_mt).

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

With ``grad_accum`` K > 1, steps 1-2 run once over the whole batch (one
kernel launch per step, so the boxes do not depend on K) and steps 3-7 once
per strided chunk (``stepcore.accumulate``); the bf16 and remat loss-chain
options are refused there, as the JAX step refuses them, so the chunks'
teacher logits and softmax chains are float32.

Over a ``mesh`` of ranks (``parallel.mesh``) the boxes are drawn for the
global batch and each rank keeps its data index's rows; the kernel runs on
the rank's slice (the counterpart of ``cutmix_blend_sharded``), and the
losses are global (``stepcore``). With model ranks (``--spatial_train``,
``parallel.spatial``) the batch holds the data index's full crops: the
kernel blends them whole, once per step, and then every image-shaped input
of the forwards (the crops, labels, teacher inputs, the blend, its mask and
the loss mask) is cut to this rank's rows.

Metrics stay device tensors (nothing here waits for the device).

On a CUDA state without a mesh the step is replayed from a CUDA graph
(``semisup.step_graph``): its first call runs eagerly, its second captures
it, and later calls with the same batch signature replay it. The batch is
then consumed: the step empties the caller's dict.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.nn import functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from cutmix_seg_tpu_torch.core.train_state import TrainState
from cutmix_seg_tpu_torch.masks.box_mask import (
    BoxMaskConfig,
    rasterise_masks,
    sample_box_rects,
)
from cutmix_seg_tpu_torch.ops.cutmix import cutmix_blend
from cutmix_seg_tpu_torch.parallel.mesh import global_rows, local_rows
from cutmix_seg_tpu_torch.parallel.spatial import slice_batch_h
from cutmix_seg_tpu_torch.semisup import losses as L
from cutmix_seg_tpu_torch.semisup.step_graph import GraphedStep
from cutmix_seg_tpu_torch.semisup.stepcore import (
    ConsistencyCommon,
    accumulate,
    confidence_px,
    finish_step,
    prepare_nets,
    split_scalars,
    student_backward,
    teacher_forward,
    teacher_pair,
    validate_accum,
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


def _mix_geometry(cfg: MaskConsistencyConfig, batch, generator, rects, mesh):
    """Returns (x_stu_cons, m, loss_mask) for 'mix' / 'zero'."""
    x = batch["ux0_stu"] if cfg.mask_mode == "mix" else batch["ux_stu"]
    n, hw = x.shape[0], tuple(x.shape[1:3])
    if rects is None:
        rects = sample_box_rects(cfg.box, generator, global_rows(n, mesh), hw)
    rects = local_rows(rects, mesh)
    if cfg.mask_mode == "mix":
        # without colour jitter the augmented images are a channels-first
        # buffer seen as NHWC; the blend takes dense NHWC
        x_stu_cons, m = cutmix_blend(x.contiguous(), batch["ux1_stu"].contiguous(), rects,
                                     invert=cfg.box.invert)
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


def make_mask_mt_step(model, opt, cfg: MaskConsistencyConfig, mesh=None):
    """Build the step function.

    ``model`` is the SegModel, ``opt`` the optimiser that
    ``create_train_state`` returned with the state; ``mesh`` the ranks the
    step runs over (None: alone), each given its rows of the global batch.

    batch dict (NHWC; leading dim B for sup, R*B for unsup; images float,
    labels int (N, H, W), valid masks (N, H, W, 1) float), all on the state's
    device:
      sup_x, sup_y
      mix mode: ux0_tea, ux0_stu, um0, ux1_tea, ux1_stu, um1
      zero mode: ux_tea, ux_stu, um

    Returns ``step(state, batch, ramp, rects=None) -> (state, metrics)``;
    ``rects`` (N, n_boxes, 4) float32, for the global batch, replaces the
    sampled boxes. The step is a ``GraphedStep``: without a mesh, on a CUDA
    state, it consumes ``batch`` and, from its second call, replays a CUDA
    graph; over a mesh it steps eagerly. Its ``counters()`` count captures,
    replays and eager steps; its ``body(state, batch, scalars, rects)`` is
    the eager step, its host scalars given on the device
    (``stepcore.step_scalars``).
    """
    if cfg.mask_mode not in ("mix", "zero"):
        raise ValueError(f"unknown mask_mode {cfg.mask_mode!r}")
    K = cfg.grad_accum
    if K > 1:
        # the chunks' loss chains are float32 and not recomputed
        if (cfg.cons_compute_dtype != "float32" or cfg.remat_loss_chain
                or cfg.loss_softmax_dtype != "float32"):
            raise ValueError(
                "cons_compute_dtype='bfloat16' / remat_loss_chain / "
                "loss_softmax_dtype='bfloat16' are not supported with "
                "grad_accum > 1")
        validate_accum(cfg, "mask_mt")
    use_cons = cfg.cons_weight > 0.0
    spatial = mesh is not None and mesh.n_model > 1
    ldt = _DTYPES[cfg.cons_compute_dtype]
    sdt = _DTYPES[cfg.loss_softmax_dtype]
    tea_keys = ("ux0_tea", "ux1_tea") if cfg.mask_mode == "mix" else ("ux_tea",)

    def body(state: TrainState, batch, scalars, rects=None):
        """The step, its host scalars on the device (``step_scalars``)."""
        ramp = split_scalars(opt, scalars)
        teacher = prepare_nets(cfg, state, mesh)
        full = {"sup_x": batch["sup_x"], "sup_y": batch["sup_y"]}
        # ---- mixing geometry over the whole batch, outside the gradient ----
        if use_cons:
            with record_function("step.perturb"), torch.no_grad():
                x_stu_cons, m, loss_mask = _mix_geometry(cfg, batch, state.generator, rects, mesh)
                loss_mask = loss_mask.float()
            if K > 1 and batch["sup_x"].shape[1:] != x_stu_cons.shape[1:]:
                raise ValueError(
                    "grad_accum > 1 requires matching supervised/"
                    f"unsupervised crop shapes, got {tuple(batch['sup_x'].shape[1:])}"
                    f" vs {tuple(x_stu_cons.shape[1:])}")
            full.update({k: batch[k] for k in tea_keys})
            full.update(x_cons=x_stu_cons, m=m, loss_mask=loss_mask)
        if spatial:
            # the forwards, the blends and the losses run on this rank's rows
            full = slice_batch_h(full, mesh)

        def one_chunk(c):
            # ---- teacher: all outside the gradient ----
            conf_px = per_px_fn = None
            if use_cons:
                with record_function("step.teacher"), torch.no_grad():
                    if cfg.mask_mode == "mix":
                        tea0, tea1 = teacher_pair(cfg, teacher, c["ux0_tea"], c["ux1_tea"])
                        m_l = c["m"].to(ldt)
                        logits_tea = tea0.to(ldt) * (1.0 - m_l) + tea1.to(ldt) * m_l
                    else:
                        logits_tea = teacher_forward(cfg, teacher, c["ux_tea"]).to(ldt)
                    # only the (.., 1) max-prob map is kept; the gate compares f32
                    conf = F.softmax(logits_tea.to(sdt), dim=-1).amax(
                        dim=-1, keepdim=True).float()
                    conf_px = confidence_px(cfg, conf)

                def per_px_fn(logits_stu):
                    return _tail(cfg, L.consistency_loss_per_pixel, cfg.cons_loss_fn,
                                 logits_stu, logits_tea, sdt)

            # ---- student losses under the gradient ----
            return student_backward(
                cfg, state.student, c, c.get("x_cons"), per_px_fn, c.get("loss_mask"),
                conf_px, ramp, mesh=mesh,
                sup_loss_fn=lambda logits, y, count: _tail(
                    cfg, L.cross_entropy_ignore, logits, y, cfg.ignore_value, sdt, count))

        metrics = accumulate(K, state.student, full, one_chunk, mesh)
        return finish_step(state, opt, cfg), metrics

    return GraphedStep(body, opt, capturable=mesh is None)
