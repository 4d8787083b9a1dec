"""ICT (Interpolation Consistency Training) mean-teacher step (port of
cutmix_seg_tpu.semisup.ict).

One step, in the JAX step's order:
  1. a per-sample mix factor lambda ~ Beta(ict_alpha, ict_alpha), drawn on
     the device from the state's generator (or injected by the caller);
  2. the student images and the valid masks of the two unsupervised batches
     blended with lambda;
  3. the no-grad teacher forwards (``stepcore.teacher_pair``: one over
     ``[ux0_tea | ux1_tea]`` under frozen BN, two in turn with training BN),
     in float32 from there on;
  4. the teacher's logits, its probabilities and its two per-pixel
     confidences blended with the same lambda, each separately (blended
     probabilities are not the softmax of blended logits: prob-space losses
     take the former, logit-space losses the latter);
  5. the student forward/backward over ``[sup_x | x_mixed]`` (two forwards
     with training BN): CE(ignore) +
     cons_sum * ramp * cons_weight;
  6. the optimiser step, then the EMA teacher update.

With ``grad_accum`` K > 1, steps 1-2 run once over the whole batch (the
lambdas do not depend on K) and steps 3-5 once per strided chunk
(``stepcore.accumulate``).

Over a ``mesh`` of ranks the lambdas are drawn for the global batch and
each rank keeps its rows; the losses are global (``stepcore``). With model
ranks (``--spatial_train``) the batch holds the data index's full crops:
they are mixed whole, and then every image-shaped input is cut to this
rank's rows (lambda is per sample and stays whole).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.nn import functional as F
from torch.profiler import record_function

from cutmix_seg_tpu_torch.core.train_state import TrainState
from cutmix_seg_tpu_torch.parallel.mesh import global_rows, local_rows
from cutmix_seg_tpu_torch.parallel.spatial import slice_batch_h
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
    teacher_pair,
    validate_accum,
)

__all__ = ["ICTConfig", "beta_logit", "make_ict_step", "sample_beta"]


@dataclasses.dataclass(frozen=True)
class ICTConfig(ConsistencyCommon):
    ict_alpha: float = 0.1


def beta_logit(alpha: float, shape, generator: torch.Generator) -> torch.Tensor:
    """log(X / Y) of two Gamma(alpha) draws (float32, on the generator's
    device): the log-odds of a Beta(alpha, alpha) draw.

    The ratio X / (X + Y) itself is 0 / 0 where both gammas underflow, which
    at alpha 0.1 happens in float32. So each gamma is drawn in log space:
    log Gamma(alpha) = log Gamma(alpha + 1) + log(U) / alpha (Marsaglia and
    Tsang's boost). U = 1 - rand lies in (0, 1], so no log is -inf."""
    dev = generator.device

    def log_gamma():
        g = torch._standard_gamma(torch.full(shape, alpha + 1.0, device=dev),
                                  generator=generator)
        u = 1.0 - torch.rand(shape, generator=generator, device=dev)
        return torch.log(g) + torch.log(u) / alpha

    log_x = log_gamma()
    return log_x - log_gamma()


def sample_beta(alpha: float, shape, generator: torch.Generator) -> torch.Tensor:
    """Beta(alpha, alpha) draws, sigmoid of ``beta_logit``: never NaN."""
    return torch.sigmoid(beta_logit(alpha, shape, generator))


def make_ict_step(model, opt, cfg: ICTConfig, mesh=None):
    """Build the step function.

    batch dict (NHWC; leading dim B for sup, R*B for unsup; images float,
    labels int (N, H, W), valid masks (N, H, W, 1) float), on the state's
    device: sup_x, sup_y, ux0_tea, ux0_stu, um0, ux1_tea, ux1_stu, um1.

    Returns ``step(state, batch, ramp, lam=None) -> (state, metrics)``;
    ``lam`` (N, 1, 1, 1), for the global batch, replaces the sampled mix
    factors. ``mesh``: as ``make_mask_mt_step``'s.
    """
    if cfg.grad_accum > 1:
        validate_accum(cfg, "ict")
    use_cons = cfg.cons_weight > 0.0
    spatial = mesh is not None and mesh.n_model > 1

    def step(state: TrainState, batch, ramp, lam: Optional[torch.Tensor] = None):
        ramp = split_scalars(opt, step_scalars(opt, ramp, state.generator.device))
        teacher = prepare_nets(cfg, state, mesh)
        full = {"sup_x": batch["sup_x"], "sup_y": batch["sup_y"]}
        if use_cons:
            with record_function("step.perturb"), torch.no_grad():
                ux0, ux1 = batch["ux0_stu"], batch["ux1_stu"]
                n = ux0.shape[0]
                if lam is None:
                    lam = sample_beta(cfg.ict_alpha, (global_rows(n, mesh), 1, 1, 1),
                                      state.generator)
                lam = local_rows(lam, mesh).to(ux0.dtype)
                full.update(
                    ux0_tea=batch["ux0_tea"], ux1_tea=batch["ux1_tea"],
                    x_mixed=ux0 * (1.0 - lam) + ux1 * lam,
                    um_mixed=(batch["um0"] * (1.0 - lam) + batch["um1"] * lam).float(),
                    lam=lam.float())
        if spatial:
            full = slice_batch_h(full, mesh, per_sample=("lam",))

        def one_chunk(c):
            conf_px = per_px_fn = None
            if use_cons:
                with record_function("step.teacher"), torch.no_grad():
                    tea0, tea1 = (t.float() for t in teacher_pair(
                        cfg, teacher, c["ux0_tea"], c["ux1_tea"]))
                    p0, p1 = F.softmax(tea0, dim=-1), F.softmax(tea1, dim=-1)
                    lam32 = c["lam"]
                    logits_tea_mix = tea0 * (1 - lam32) + tea1 * lam32
                    prob_tea_mix = p0 * (1 - lam32) + p1 * lam32
                    conf_mix = (p0.amax(dim=-1, keepdim=True) * (1 - lam32)
                                + p1.amax(dim=-1, keepdim=True) * lam32)
                    conf_px = confidence_px(cfg, conf_mix)

                def per_px_fn(logits_stu):
                    return L.consistency_from_prob_targets(
                        cfg.cons_loss_fn, logits_stu.float(), logits_tea_mix, prob_tea_mix)

            return student_backward(cfg, state.student, c, c.get("x_mixed"), per_px_fn,
                                    c.get("um_mixed"), conf_px, ramp, mesh=mesh)

        metrics = accumulate(cfg.grad_accum, state.student, full, one_chunk, mesh)
        return finish_step(state, opt, cfg), metrics

    return step
