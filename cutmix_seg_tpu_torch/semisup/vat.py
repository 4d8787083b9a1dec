"""VAT (Virtual Adversarial Training) mean-teacher step (port of
cutmix_seg_tpu.semisup.vat).

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

With ``grad_accum`` K > 1, the noise of 2 is drawn once for the whole batch
(it does not depend on K) and steps 1 and 3-7 run once per strided chunk
(``stepcore.accumulate``). The direction net of chunk k reads the running
statistics its net holds after chunks 0 .. k-1, as the JAX scan carry gives
them: the teacher's after their teacher forwards, or the student's after
their student forwards (``vat_dir_from_student``). In pi-model mode with
training BN the teacher's statistics are a carry of their own, started from
the student's and updated by the teacher forwards only, which the step
discards at its end (``_PiTeacherStats``).

Over a ``mesh`` of ranks the noise is drawn for the global batch and each
rank keeps its rows; the direction net runs in eval mode, so each sample's
direction is its own, and the losses are global (``stepcore``). With model
ranks (``--spatial_train``) the batch holds the data index's full crops:
the noise is normalised and scaled over the full crop (its global H) and
the radius computed from it (the adaptive radius's central differences
cross rows), before every image-shaped input is cut to this rank's rows;
the direction's per-sample squared norm is summed over the model group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.nn import functional as F
from torch.profiler import record_function

from cutmix_seg_tpu_torch.core.train_state import TrainState
from cutmix_seg_tpu_torch.parallel.mesh import Mesh, global_rows, local_rows
from cutmix_seg_tpu_torch.parallel.spatial import model_group, slice_batch_h
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

__all__ = ["VATConfig", "make_vat_step", "vat_radius"]


@dataclasses.dataclass(frozen=True)
class VATConfig(ConsistencyCommon):
    vat_radius: float = 0.5
    adaptive_vat_radius: bool = False
    vat_dir_from_student: bool = False


def _normalize_per_sample(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """x over its per-sample L2 norm; with model ranks (x: this rank's rows)
    the squared norms are summed over the model group."""
    sq = (x.reshape(x.shape[0], -1) ** 2).sum(dim=1)
    if mesh is not None and mesh.n_model > 1:
        dist.all_reduce(sq, group=model_group(mesh))
    return x / (torch.sqrt(sq)[:, None, None, None] + 1e-12)


def vat_radius(cfg: VATConfig, x_stu: torch.Tensor):
    """Step 4 on the full crops x_stu: ``vat_radius * sqrt(C * H * W)`` (a
    float), or the adaptive per-sample radius (N, 1, 1, 1)."""
    n, h, w, c = x_stu.shape
    if not cfg.adaptive_vat_radius:
        return cfg.vat_radius * math.sqrt(float(c * h * w))
    dv = x_stu[:, 2:, :, :] - x_stu[:, :-2, :, :]
    dh = x_stu[:, :, 2:, :] - x_stu[:, :, :-2, :]
    mag = torch.sqrt((dv.reshape(n, -1) ** 2).sum(dim=1) + (dh.reshape(n, -1) ** 2).sum(dim=1))
    return cfg.vat_radius * mag[:, None, None, None] * 0.5


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
                      x_stu: torch.Tensor, eps0: torch.Tensor, radius=None,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Steps 1 and 3-5: ``x_stu`` moved along the power step's direction by
    ``radius`` (default: ``vat_radius`` of x_stu). ``dir_net`` runs in eval
    mode; its previous mode is restored. With model ranks in ``mesh`` the
    images are this rank's rows and ``radius`` is the full crops'."""
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
        direction = _normalize_per_sample(eps_grad, mesh)
        if radius is None:
            radius = vat_radius(cfg, x_stu)
        return x_stu + direction * radius


class _PiTeacherStats:
    """The pi-model teacher's running statistics under training BN with
    grad_accum > 1: a copy of the student's at the step's start, swapped into
    the student net for the teacher side of each chunk (direction net and
    teacher forward, which updates it) and out again for the student's
    forward/backward."""

    def __init__(self, net: torch.nn.Module):
        self.bufs = [b for name, b in net.named_buffers() if "running" in name]
        self.carry = [b.clone() for b in self.bufs]

    def __enter__(self):
        self.saved = [b.clone() for b in self.bufs]
        for b, c in zip(self.bufs, self.carry):
            b.copy_(c)

    def __exit__(self, *exc):
        for b, c, s in zip(self.bufs, self.carry, self.saved):
            c.copy_(b)
            b.copy_(s)


def make_vat_step(model, opt, cfg: VATConfig, mesh=None):
    """Build the step function.

    batch dict (NHWC, on the state's device): sup_x, sup_y, ux_tea, ux_stu,
    um (valid mask (N, H, W, 1)).

    Returns ``step(state, batch, ramp, eps0=None) -> (state, metrics)``;
    ``eps0`` (the shape of the global ``ux_stu``, float32, normalised and
    scaled) replaces the sampled noise. ``mesh``: as
    ``make_mask_mt_step``'s.
    """
    K = cfg.grad_accum
    if K > 1:
        validate_accum(cfg, "vat_mt")
    use_cons = cfg.cons_weight > 0.0
    pi_carry = (K > 1 and not cfg.mean_teacher and not cfg.freeze_bn
                and not cfg.vat_dir_from_student)
    spatial = mesh is not None and mesh.n_model > 1

    def step(state: TrainState, batch, ramp, eps0: Optional[torch.Tensor] = None):
        ramp = split_scalars(opt, step_scalars(opt, ramp, state.generator.device))
        teacher = prepare_nets(cfg, state, mesh)
        full = {"sup_x": batch["sup_x"], "sup_y": batch["sup_y"]}
        radius = None
        if use_cons:
            x_stu = batch["ux_stu"]  # the full crops
            h, w = x_stu.shape[1:3]
            if eps0 is None:
                shape = (global_rows(x_stu.shape[0], mesh),) + tuple(x_stu.shape[1:])
                noise = local_rows(torch.randn(shape, generator=state.generator,
                                               device=x_stu.device), mesh)
                eps0 = _normalize_per_sample(noise) * (1.0e-6 * h * w / 1000.0)
            else:
                eps0 = local_rows(eps0, mesh)
            full.update(ux_tea=batch["ux_tea"], ux_stu=x_stu, um=batch["um"].float(),
                        eps0=eps0)
            radius = vat_radius(cfg, x_stu)
            if torch.is_tensor(radius):  # per sample: chunked with the batch
                full["radius"] = radius
        if spatial:
            full = slice_batch_h(full, mesh, per_sample=("radius",))
        tea_stats = _PiTeacherStats(teacher) if use_cons and pi_carry else None

        def one_chunk(c):
            x_adv = conf_px = per_px_fn = None
            if use_cons:
                with tea_stats or contextlib.nullcontext():
                    dir_net = state.student if cfg.vat_dir_from_student else teacher
                    with record_function("step.perturb"):
                        x_adv = adversarial_input(cfg, dir_net, c["ux_tea"], c["ux_stu"],
                                                  c["eps0"], c.get("radius", radius), mesh)
                    with record_function("step.teacher"), torch.no_grad():
                        if tea_stats is None:
                            logits_tea = teacher_forward(cfg, teacher, c["ux_tea"]).float()
                        else:  # the pi carry's own statistics update
                            logits_tea = teacher(c["ux_tea"]).float()
                        conf_px = confidence_px(
                            cfg, F.softmax(logits_tea, dim=-1).amax(dim=-1, keepdim=True))

                def per_px_fn(logits_stu):
                    return L.consistency_loss_per_pixel(cfg.cons_loss_fn, logits_stu,
                                                        logits_tea)

            return student_backward(cfg, state.student, c, x_adv, per_px_fn, c.get("um"),
                                    conf_px, ramp, mesh=mesh)

        metrics = accumulate(K, state.student, full, one_chunk, mesh)
        return finish_step(state, opt, cfg), metrics

    return step
