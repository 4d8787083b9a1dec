"""Pieces shared by the semi-supervised train steps (port of
cutmix_seg_tpu.semisup.stepcore): the common options, confidence gating, the
masked per-sub-batch consistency reduction, the nets' mode for a step, the
teacher's forwards, the student's forward/backward, gradient accumulation
and the end of a step (optimiser update, EMA teacher update, step advance).

Gradient accumulation (``grad_accum`` K > 1): every draw of a step (boxes,
lambdas, noise) is made for the whole batch first, then the batch runs as K
strided chunks (chunk k is ``x[k::K]``), each through the teacher's forwards
and the student's forward/backward in turn, where the JAX step runs one
``lax.scan`` body per chunk. ``.grad`` sums the chunks' gradients, divided by
K once after the last chunk (the JAX step's ``sum / K``); the metrics are
the chunks' means. BN running statistics thread from chunk to chunk in the
modules' buffers, one forward after the other, as they do through the JAX
scan carry.

Data parallelism (a ``mesh`` of N ranks, ``parallel.mesh``): the JAX step
runs over the global batch, so its denominators are global: the CE's valid
pixel count, the gate's confidence rates and the per-sub-batch pixel counts.
Each rank computes its numerators over those (``global_denominators``, one
all-reduce without a gradient per chunk), which makes its loss its share of
the global loss; the gradients and the loss metrics are then summed over
the ranks in one all-reduce after the last chunk, before the division by K.
The global unsupervised batch is the ranks' batches in rank order, and
JAX's ``reshape(R, -1)`` cuts THAT into R sub-batches, so a rank's rows may
fall in another sub-batch than its own ``reshape`` would put them in
(``_subbatch_of_rows``). At K > 1 the global chunk k is the union of the
ranks' ``x[k::K]`` (K divides each rank's batch), and the denominators and
BN statistics are the chunk's. Dropout masks are drawn per rank, from a
generator folded with the rank and the step.

Spatial partitioning (a mesh with ``n_model`` > 1 ranks to an image,
``parallel.spatial``): the JAX program is the same global one with its
activations split on H, so the same global sums hold. A step receives its
data index's full crops, makes its draws and whole-crop reductions on them
and cuts every image-shaped input to this rank's rows
(``parallel.spatial.slice_batch_h``). Rank r holds the rows of model index
r % n_model of the images of data index r // n_model; the sub-batches count
in data indices, a global sub-batch's element count is n_model times a
rank's rows, and every pixel sum (the denominators, BN's statistics, the
gradients) stays an all-reduce over the whole world, whose ranks hold
disjoint pixels. The dropout generator is folded by data index (with one
data index it is the state's, as alone), so the model ranks of an image
draw the same full-map masks and keep their rows.

BN and dropout follow the JAX steps: every forward but VAT's direction net
runs in train mode, so dropout draws masks (from the state's generator) in
the teacher too; with training BN (``freeze_bn=False``) each forward
normalises with its batch's statistics and updates the running ones, one
forward after the other, and the EMA then mixes the teacher's updated
running statistics with the student's. The pi-model's teacher pass is the
student's own forward, whose updated statistics the JAX step discards.

Phase spans (``torch.profiler.record_function``; one enter and exit each
when no profiler runs): every step marks five disjoint phases, so a trace
sets each kernel and device gap against the part of the step that launched
it. ``step.perturb`` (in the algorithm's file) builds the perturbation:
mask_mt's boxes, blend and loss mask, ICT's lambdas and mixes, VAT's
``adversarial_input``, aug_mt's warps into the student's frame with the
gate. ``step.teacher`` (also there) holds the no-grad teacher forwards and
what is made of their logits besides: blend, softmax, gate.
``step.student`` (``student_backward``) runs from ``global_denominators``
to the summed loss, ``step.backward`` is ``total.backward()``, and
``step.update`` (``finish_step``) the optimiser, ``zero_grad``, the EMA and
the step advance. Phases inside the chunk loop run once per chunk, the
others once per step; ``prepare_nets``, VAT's noise, the K > 1 division and
the ranks' all-reduce lie outside every phase.

The host's per-step scalars (``ramp``, the optimiser's learning rates and
bias corrections) reach the device in one copy before the step
(``step_scalars``), so a step launches the same kernels on every call and
the mask_mt step can be replayed from a CUDA graph (``semisup.step_graph``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional

import torch

import torch.distributed as dist
from torch.profiler import record_function

from cutmix_seg_tpu_torch.core.train_state import Optimizer, TrainState, scalars_to_device
from cutmix_seg_tpu_torch.models.common import (
    running_stats_kept,
    set_bn_mesh,
    set_dropout_generator,
    set_freeze_bn,
)
from cutmix_seg_tpu_torch.parallel.mesh import Mesh, all_reduce_grads
from cutmix_seg_tpu_torch.parallel.spatial import set_spatial
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


def _subbatch_of_rows(cfg: ConsistencyCommon, n: int, mesh: Mesh, device) -> torch.Tensor:
    """The global sub-batch of each of this rank's n unsupervised rows: the
    global batch is [data index 0's n rows | data index 1's | ...], cut
    into R equal parts."""
    rows = mesh.data_index * n + torch.arange(n, device=device)
    return rows // (n * mesh.n_data // cfg.unsup_batch_ratio)


def global_denominators(cfg: ConsistencyCommon, mesh: Mesh, sup_y: torch.Tensor,
                        conf_px: Optional[torch.Tensor]) -> torch.Tensor:
    """[the CE's valid-pixel count, the R sub-batches' confidence sums] of
    the global batch: this rank's, summed over the ranks (no gradient)."""
    parts = [(sup_y != cfg.ignore_value).sum().double().reshape(1)]
    if conf_px is not None:
        R = cfg.unsup_batch_ratio
        sub = _subbatch_of_rows(cfg, conf_px.shape[0], mesh, conf_px.device)
        per_row = conf_px.reshape(conf_px.shape[0], -1).double().sum(dim=1)
        parts.append(torch.zeros(R, dtype=torch.float64, device=conf_px.device)
                     .index_add(0, sub, per_row))
    den = torch.cat(parts)
    dist.all_reduce(den)
    return den.float()


def masked_consistency(cfg: ConsistencyCommon, per_px: torch.Tensor,
                       loss_mask: torch.Tensor, conf_px: Optional[torch.Tensor],
                       mesh: Optional[Mesh] = None, den: Optional[torch.Tensor] = None):
    """Apply the valid mask and confidence gate and reduce per sub-batch.

    per_px, loss_mask: (R*B, H, W, 1); conf_px: per-pixel confidence mask or
    None (conf_thresh == 0). Returns (sum over the R sub-batch means, their
    mean, conf_rate). Under a mesh, ``den`` is ``global_denominators``' and
    the two sums are this rank's shares of the global ones; conf_rate is
    global."""
    R = cfg.unsup_batch_ratio
    if mesh is not None:
        return _masked_consistency_share(cfg, per_px, loss_mask, conf_px, mesh, den)

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


def _masked_consistency_share(cfg, per_px, loss_mask, conf_px, mesh, den):
    R = cfg.unsup_batch_ratio
    n = per_px.shape[0]
    sub = _subbatch_of_rows(cfg, n, mesh, per_px.device)
    # elements of a global sub-batch (each rank holds 1/n_model of an image's rows)
    count = n * mesh.n_data // R * per_px[0].numel() * mesh.n_model

    def subbatch_share(arr):
        per_row = arr.reshape(n, -1).sum(dim=1)
        return torch.zeros(R, dtype=per_row.dtype, device=per_row.device) \
            .index_add(0, sub, per_row) / count

    if conf_px is not None:
        conf_rates = den[1:] / count
        if cfg.conf_per_pixel:
            masked = subbatch_share(per_px * (loss_mask * conf_px))
        else:
            masked = subbatch_share(per_px * loss_mask) * conf_rates
        conf_rate = conf_rates.mean()
    else:
        masked = subbatch_share(per_px * loss_mask)
        conf_rate = torch.ones((), dtype=torch.float32, device=per_px.device)
    return masked.sum(), masked.mean(), conf_rate


def confidence_px(cfg: ConsistencyCommon, conf_tea: torch.Tensor):
    """Per-pixel confidence mask from (R*B, H, W, 1) teacher confidences."""
    if cfg.conf_thresh > 0.0:
        return (conf_tea >= cfg.conf_thresh).float()
    return None


def step_scalars(opt: Optimizer, ramp: float, device,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A step's host scalars on ``device`` in one copy: ``ramp`` (for
    ``student_backward``), then ``opt.scalar_values()`` (for the update:
    ``split_scalars``); into ``out`` when given."""
    return scalars_to_device([float(ramp), *opt.scalar_values()], device, out)


def split_scalars(opt: Optimizer, scalars: torch.Tensor) -> torch.Tensor:
    """Hand the optimiser its part of ``step_scalars``' tensor (for the
    update that ``finish_step`` makes); returns the ramp's 0-dim tensor."""
    opt.device_scalars = scalars[1:]
    return scalars[0]


def validate_accum(cfg: ConsistencyCommon, algo: str) -> None:
    """The grad_accum > 1 preconditions every algorithm shares."""
    if cfg.unsup_batch_ratio != 1:
        raise ValueError(
            f"{algo}: grad_accum > 1 requires unsup_batch_ratio == 1 "
            "(chunking must not cut across unsupervised sub-batches)")
    if cfg.conf_thresh > 0.0 and not cfg.conf_per_pixel and cfg.cons_weight > 0.0:
        warnings.warn(
            f"{algo}: grad_accum > 1 with the batch-mean confidence gate "
            "(conf_per_pixel=False): each micro-chunk is gated by its own "
            "mean confidence rather than the full batch's, so the gradient "
            "is the standard accumulation average, not bit-equal to "
            "grad_accum=1. Pass conf_per_pixel=True for exact chunk "
            "decomposition.", stacklevel=4)


def chunk_strided(x: torch.Tensor, K: int) -> List[torch.Tensor]:
    """The K strided chunks of x's leading axis: chunk k is ``x[k::K]``."""
    if x.shape[0] % K != 0:
        raise ValueError(f"batch size {x.shape[0]} not divisible by grad_accum={K}")
    return [x[k::K] for k in range(K)]


def accumulate(K: int, student: torch.nn.Module, batch: Dict[str, torch.Tensor],
               one_chunk: Callable[[Dict[str, torch.Tensor]], dict],
               mesh: Optional[Mesh] = None) -> dict:
    """Run ``one_chunk`` on each of the K strided chunks of ``batch`` (a dict
    of tensors with a common leading axis), in chunk order. Each call leaves
    its chunk's gradients added into the student's ``.grad`` and returns its
    metrics; the summed gradients are divided by K once, and the metrics
    are their means over the chunks. K == 1 runs ``one_chunk(batch)``.
    Under a mesh the gradients and the loss shares are summed over the
    ranks after the last chunk, before the division."""
    if K == 1:
        total = one_chunk(batch)
    else:
        per_key = {k: chunk_strided(v, K) for k, v in batch.items()}
        total = None
        for i in range(K):
            m = one_chunk({k: v[i] for k, v in per_key.items()})
            total = m if total is None else {k: total[k] + v for k, v in m.items()}
    if mesh is not None:
        total = _sum_over_ranks(student, total)
    if K == 1:
        return total
    with torch.no_grad():
        for p in student.parameters():
            if p.grad is not None:
                p.grad.div_(K)
    return {k: v / K for k, v in total.items()}


def _sum_over_ranks(student: torch.nn.Module, metrics: dict) -> dict:
    """One all-reduce of the student's gradients with the loss shares
    (conf_rate is already global)."""
    shares = [k for k in ("sup_loss", "cons_loss") if k in metrics]
    summed = all_reduce_grads([p for p in student.parameters() if p.requires_grad],
                              torch.stack([metrics[k] for k in shares]))
    return dict(metrics, **{k: summed[i] for i, k in enumerate(shares)})


def accum_zero_metrics(use_cons: bool, device=None) -> Dict[str, torch.Tensor]:
    """Zero metric sums of a step's keys: sup_loss, and cons_loss and
    conf_rate with the consistency term."""
    keys = ["sup_loss"] + (["cons_loss", "conf_rate"] if use_cons else [])
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in keys}


def prepare_nets(cfg: ConsistencyCommon, state: TrainState,
                 mesh: Optional[Mesh] = None) -> torch.nn.Module:
    """Set the BN mode (``cfg.freeze_bn``) and mesh, the dropout generator
    (the state's; over several data indices, this data index's fold of it:
    the model ranks of an image draw alike) and the
    spatial split (``parallel.spatial.set_spatial``: the mesh's model
    ranks split H) of the student and the teacher for a step; returns the
    teacher net (the student itself in pi-model mode)."""
    nets = [state.student] + ([state.teacher] if cfg.mean_teacher else [])
    dropout_gen = state.generator
    if mesh is not None and mesh.n_data > 1:
        dropout_gen = rank_generator(state, mesh.data_index)
    for net in nets:
        set_freeze_bn(net, cfg.freeze_bn)
        set_bn_mesh(net, mesh)
        set_dropout_generator(net, dropout_gen)
        set_spatial(net, mesh)
    return nets[-1]


def rank_generator(state: TrainState, index: int) -> torch.Generator:
    """A generator of a data index's own (the rank at ``n_model`` 1) for a
    step's dropout masks, seeded from the state generator's seed, the step
    and the index: masks differ between data indices and steps, the model
    ranks of an image draw the same ones, and a resumed run draws them
    again."""
    seed = ((state.generator.initial_seed() * 1_000_003 + state.step) * 4096 + index) % (1 << 63)
    return torch.Generator(device=state.generator.device).manual_seed(seed)


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
                     ramp: torch.Tensor, sup_loss_fn: Optional[Callable] = None,
                     mesh: Optional[Mesh] = None) -> dict:
    """The student's loss and backward: CE (ignore) on ``sup_x`` plus, with
    ``x_cons``, ``ramp * cons_weight`` (``ramp``: ``step_scalars``' first
    element) times the masked consistency of
    ``per_px_fn(logits of x_cons)``; ``sup_loss_fn(logits, labels, count)``
    replaces the CE. Under frozen BN one forward over
    ``[sup_x | x_cons]`` is the JAX step's two forwards; with training BN
    the two run in turn, sup_x's statistics updated first. Leaves the
    gradients in ``.grad``; returns the metrics (device tensors). Under a
    mesh the losses are this rank's shares of the global ones."""
    with record_function("step.student"):
        sup_x = batch["sup_x"]
        n = sup_x.shape[0]
        den = count = None
        if mesh is not None:
            den = global_denominators(cfg, mesh, batch["sup_y"],
                                      conf_px if x_cons is not None else None)
            count = den[0]
        logits_cons = None
        if x_cons is not None and cfg.freeze_bn and sup_x.shape[1:] == x_cons.shape[1:]:
            logits = student(torch.cat([sup_x, x_cons]))
            logits_sup, logits_cons = logits[:n], logits[n:]
        else:
            logits_sup = student(sup_x)
            if x_cons is not None:
                logits_cons = student(x_cons)
        if sup_loss_fn is None:
            sup_loss = L.cross_entropy_ignore(logits_sup, batch["sup_y"], cfg.ignore_value,
                                              count=count)
        else:
            sup_loss = sup_loss_fn(logits_sup, batch["sup_y"], count)
        metrics = {"sup_loss": sup_loss.detach()}
        total = sup_loss
        if logits_cons is not None:
            loss_sum, loss_mean, conf_rate = masked_consistency(
                cfg, per_px_fn(logits_cons), loss_mask, conf_px, mesh, den)
            total = total + loss_sum * ramp * cfg.cons_weight
            metrics["cons_loss"] = loss_mean.detach()
            metrics["conf_rate"] = conf_rate.detach()
    with record_function("step.backward"):
        total.backward()
    return metrics


def finish_step(state: TrainState, opt: Optimizer,
                cfg: ConsistencyCommon) -> TrainState:
    """Optimiser update from the student's gradients (with the scalars a
    step left in ``opt.device_scalars``), EMA teacher update, step advance
    (all in place)."""
    with record_function("step.update"):
        opt.step()
        opt.zero_grad()
        if cfg.mean_teacher:
            ema_update(float_tensors(state.teacher), float_tensors(state.student),
                       cfg.teacher_alpha)
        state.step += 1
    return state
