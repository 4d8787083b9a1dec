"""VAT (Virtual Adversarial Training) mean-teacher step (port of
cutmix_seg_tpu.semisup.vat, grad_accum == 1).

One step, in the JAX step's order:
  1. the direction net (the teacher, or the student under
     ``vat_dir_from_student``), in eval mode, predicts on ``ux_tea`` with
     the running statistics as they are before this step's forwards;
  2. eps0 ~ N(0, 1) from the state's generator (or injected), normalised per
     sample to unit L2 and scaled by 1e-6 * H * W / 1000;
  3. one power step: the direction is the per-sample normalised gradient,
     with respect to eps, of the SUMMED consistency loss between
     net(ux_stu + eps) and the prediction of 1. It is taken with
     ``torch.autograd.grad(loss, eps)``, so no parameter's ``.grad`` moves;
  4. the radius: ``vat_radius * sqrt(C * H * W)``, or adaptive, from central
     differences of ``ux_stu`` along H and W (times 0.5);
  5. x_adv = ux_stu + direction * radius, detached;
  6. a no-grad train-mode teacher forward on ``ux_tea``, in float32;
  7. the student forward/backward over ``[sup_x | x_adv]`` (two forwards
     with training BN): CE(ignore) +
     cons_sum * ramp * cons_weight, the standard loss menu;
  8. the optimiser step, then the EMA teacher update.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.nn import functional as F

from cutmix_seg_tpu_torch.core.train_state import TrainState
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

__all__ = ["VATConfig", "make_vat_step"]


@dataclasses.dataclass(frozen=True)
class VATConfig(ConsistencyCommon):
    vat_radius: float = 0.5
    adaptive_vat_radius: bool = False
    vat_dir_from_student: bool = False


def _normalize_per_sample(x: torch.Tensor) -> torch.Tensor:
    mag = torch.sqrt((x.reshape(x.shape[0], -1) ** 2).sum(dim=1))
    return x / (mag[:, None, None, None] + 1e-12)


def _vat_sum_loss(loss_fn: str, eps_logits: torch.Tensor,
                  y_logits: torch.Tensor) -> torch.Tensor:
    """The summed consistency loss of the power step."""
    y_prob = F.softmax(y_logits, dim=-1)
    if loss_fn == "var":
        d = F.softmax(eps_logits, dim=-1) - y_prob
        return (d * d).sum()
    if loss_fn == "bce":
        return L.robust_binary_crossentropy(F.softmax(eps_logits, dim=-1), y_prob).sum()
    if loss_fn == "kld":
        logp = F.log_softmax(eps_logits, dim=-1)
        safe = torch.clamp_min(y_prob, 1e-20)
        return (y_prob * (torch.log(safe) - logp)).sum()
    if loss_fn == "logits_var":
        d = eps_logits - y_logits
        return (d * d).sum()
    raise ValueError(f"unsupported VAT direction loss {loss_fn!r}")


def adversarial_input(cfg: VATConfig, dir_net: torch.nn.Module, x_tea: torch.Tensor,
                      x_stu: torch.Tensor, eps0: torch.Tensor) -> torch.Tensor:
    """Steps 1 and 3-5: ``x_stu`` moved along the power step's direction.
    ``dir_net`` runs in eval mode; its previous mode is restored."""
    n, h, w, c = x_stu.shape
    was_training = dir_net.training
    dir_net.eval()
    try:
        with torch.no_grad():
            y_logits = dir_net(x_tea).float()
        with torch.enable_grad():
            eps = eps0.detach().clone().requires_grad_(True)
            loss = _vat_sum_loss(cfg.cons_loss_fn, dir_net(x_stu + eps).float(), y_logits)
            (eps_grad,) = torch.autograd.grad(loss, eps)
    finally:
        dir_net.train(was_training)
    with torch.no_grad():
        direction = _normalize_per_sample(eps_grad)
        if cfg.adaptive_vat_radius:
            dv = x_stu[:, 2:, :, :] - x_stu[:, :-2, :, :]
            dh = x_stu[:, :, 2:, :] - x_stu[:, :, :-2, :]
            mag = torch.sqrt((dv.reshape(n, -1) ** 2).sum(dim=1)
                             + (dh.reshape(n, -1) ** 2).sum(dim=1))
            radius = cfg.vat_radius * mag[:, None, None, None] * 0.5
        else:
            radius = cfg.vat_radius * math.sqrt(float(c * h * w))
        return x_stu + direction * radius


def make_vat_step(model, opt, cfg: VATConfig):
    """Build the step function.

    batch dict (NHWC, on the state's device): sup_x, sup_y, ux_tea, ux_stu,
    um (valid mask (N, H, W, 1)).

    Returns ``step(state, batch, ramp, eps0=None) -> (state, metrics)``;
    ``eps0`` (the shape of ``ux_stu``, float32, normalised and scaled)
    replaces the sampled noise.
    """
    refuse_unported(cfg)
    use_cons = cfg.cons_weight > 0.0

    def step(state: TrainState, batch, ramp, eps0: Optional[torch.Tensor] = None):
        teacher = prepare_nets(cfg, state)
        x_adv = conf_px = per_px_fn = None
        if use_cons:
            x_tea, x_stu = batch["ux_tea"], batch["ux_stu"]
            h, w = x_stu.shape[1:3]
            if eps0 is None:
                noise = torch.randn(x_stu.shape, generator=state.generator,
                                    device=x_stu.device)
                eps0 = _normalize_per_sample(noise) * (1.0e-6 * h * w / 1000.0)
            dir_net = state.student if cfg.vat_dir_from_student else teacher
            x_adv = adversarial_input(cfg, dir_net, x_tea, x_stu, eps0)
            logits_tea = teacher_forward(cfg, teacher, x_tea).float()
            with torch.no_grad():
                conf_px = confidence_px(
                    cfg, F.softmax(logits_tea, dim=-1).amax(dim=-1, keepdim=True))

            def per_px_fn(logits_stu):
                return L.consistency_loss_per_pixel(cfg.cons_loss_fn, logits_stu, logits_tea)

        metrics = student_backward(cfg, state.student, batch, x_adv, per_px_fn,
                                   batch["um"].float() if use_cons else None, conf_px, ramp)
        return finish_step(state, opt, cfg), metrics

    return step
