"""The semi-supervised steps of the recipes and their first iterations, in
float32, from the seed: the reference that a run's first steps are held
to. Written from the method description (French et al., BMVC 2020,
mean-teacher CutMix) and the published recipes' options:

* CutMix (mask_mt, mix): one box per image of half its area, aspect ratio
  exp(u log p), placed uniformly, drawn from the step generator; the
  student sees ``x0 (1 - m) + x1 m`` of the two jittered unlabelled batches,
  the EMA teacher sees both unjittered and its logits are mixed with the
  same mask; the gate keeps the consistency when the teacher's mixed
  softmax reaches ``conf_thresh`` (its batch mean weights the loss);
  consistency is the squared difference of the softmaxes summed over
  classes, averaged over the valid (loss-mask) pixels of the batch;
* the loss: cross-entropy over the labelled pixels (255 ignored) plus
  ``cons_weight`` times the consistency;
* Adam (0.9, 0.999, 1e-8) or SGD (weight decay, then momentum 0.9, poly
  learning rate), each parameter group at its rate (the backbone at a
  tenth), frozen BN not updated; then the EMA teacher (alpha 0.99) over
  every parameter and running statistic.

``run`` drives three iterations from the seed and returns what the
comparison reads: each step's losses, the first gradient of each
parameter as the optimiser takes it, and each parameter's change over the
three steps.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.nn import functional as F

from benchmark.reference import models, pipeline

GROUP_SCALE = {"pretrained": 0.1, "new": 1.0}
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def lr_at(hp: dict, count: int) -> float:
    base = hp["learning_rate"]
    if hp["lr_sched"] == "none":
        return base
    if hp["lr_sched"] == "poly":
        total = max(hp["iters_per_epoch"] * hp["num_epochs"], 1)
        return base * (1.0 - min(max(count / total, 0.0), 1.0)) ** hp["lr_poly_power"]
    raise ValueError(f"the reference has no schedule {hp['lr_sched']!r}")


class Optimiser:
    """Adam or SGD over the named trainable tensors, by group."""

    def __init__(self, hp: dict, params: Dict[str, torch.Tensor], groups: Dict[str, str]):
        self.hp, self.params, self.groups = hp, params, groups
        self.state = {n: [torch.zeros_like(p), torch.zeros_like(p)] for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Updates the parameters in place; returns the gradient of each as
        the optimiser takes it (with SGD, weight decay added)."""
        hp, t = self.hp, self.count + 1
        lr = lr_at(hp, self.count)
        taken = {}
        for n, p in self.params.items():
            g = grads[n]
            a, b = self.state[n]
            if hp["opt_type"] == "adam":
                a.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
                b.mul_(ADAM_B2).add_((1 - ADAM_B2) * g * g)
                upd = (a / (1 - ADAM_B1 ** t)) / (torch.sqrt(b / (1 - ADAM_B2 ** t)) + ADAM_EPS)
                taken[n] = g
            else:
                g = g + hp["sgd_weight_decay"] * p
                a.mul_(hp["sgd_momentum"]).add_(g)
                upd = a
                taken[n] = g
            p.sub_(lr * GROUP_SCALE[self.groups[n]] * upd)
        self.count += 1
        return taken


def sample_boxes(gen: torch.Generator, n: int, hw, prop: float) -> torch.Tensor:
    """(N, 4) int boxes (y0, x0, y1, x1) of area ``prop``, random aspect."""
    dev = gen.device
    props = prop + 0.0 * torch.rand((n, 1), generator=gen, device=dev)
    u = torch.rand((n, 1), generator=gen, device=dev)
    y = torch.exp(u * torch.log(props.clamp_min(1e-20)))
    x = props / y
    size_hw = torch.tensor(hw, dtype=torch.float32, device=dev)
    sizes = torch.round(torch.stack([y, x], dim=2) * size_hw)
    pos = torch.round((size_hw - sizes) * torch.rand((n, 1, 2), generator=gen, device=dev))
    return torch.cat([pos, pos + sizes], dim=2)[:, 0].long()


def box_masks(boxes: torch.Tensor, hw) -> torch.Tensor:
    ys = torch.arange(hw[0], device=boxes.device)[None, :, None]
    xs = torch.arange(hw[1], device=boxes.device)[None, None, :]
    b = boxes[:, :, None, None]
    inside = (ys >= b[:, 0]) & (ys < b[:, 2]) & (xs >= b[:, 1]) & (xs < b[:, 3])
    return inside.float()[..., None]


def ce_ignore(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    valid = labels != 255
    logp = F.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    return -(picked * valid).sum() / valid.sum().clamp_min(1)


def consistency(logits_stu, logits_tea, loss_mask, conf_thresh):
    """(the masked, gated consistency, the gate's open share)."""
    p_tea = F.softmax(logits_tea, dim=-1)
    d = F.softmax(logits_stu, dim=-1) - p_tea
    per_px = (d * d).sum(dim=-1, keepdim=True)
    conf = (p_tea.amax(dim=-1, keepdim=True) >= conf_thresh).float().mean()
    return (per_px * loss_mask).mean() * conf, conf


class Nets:
    """Student and EMA teacher: parameter and buffer dicts of one model."""

    def __init__(self, model_cfg: dict, weights: Dict[str, torch.Tensor],
                 precision: models.Precision):
        self.cfg = model_cfg
        self.leaves = models.leaves_of(model_cfg)
        self.precision = precision
        self.dtype = precision.dtype
        self.train = [lf.name for lf in self.leaves if lf.group in GROUP_SCALE]
        self.groups = {lf.name: lf.group for lf in self.leaves}
        par = [lf.name for lf in self.leaves if lf.group != "buffer"]
        buf = [lf.name for lf in self.leaves if lf.group == "buffer"]
        self.sP = {n: weights[n].detach().to(self.dtype, copy=True) for n in par}
        self.sB = {n: weights[n].detach().to(self.dtype, copy=True) for n in buf}
        self.tP = {n: t.clone() for n, t in self.sP.items()}
        self.tB = {n: t.clone() for n, t in self.sB.items()}

    def fwd(self, teacher: bool, x, train_bn: bool, gen=None, update=True):
        P, B = (self.tP, self.tB) if teacher else (self.sP, self.sB)
        mode = models.Mode(train_bn=train_bn, dropout_gen=gen, precision=self.precision,
                           update_stats=update)
        return models.forward(self.cfg, P, B, x, mode)

    @torch.no_grad()
    def ema(self, alpha: float) -> None:
        for t, s in ((self.tP, self.sP), (self.tB, self.sB)):
            for n in t:
                t[n].mul_(alpha).add_((1 - alpha) * s[n])


def mask_mt_losses(nets: Nets, hp: dict, b: Dict[str, torch.Tensor], gen: torch.Generator,
                   train_bn: bool):
    """The CutMix step's forward: (total loss, metrics)."""
    n, hw = b["ux0_stu"].shape[0], tuple(b["ux0_stu"].shape[1:3])
    m = box_masks(sample_boxes(gen, n, hw, hp["mask_prop"]), hw)
    x_mix = b["ux0_stu"] * (1 - m) + b["ux1_stu"] * m
    loss_mask = b["um0"] * (1 - m) + b["um1"] * m
    dgen = gen if train_bn else None
    with torch.no_grad():
        if train_bn:
            t0 = nets.fwd(True, b["ux0_tea"], True, dgen)
            t1 = nets.fwd(True, b["ux1_tea"], True, dgen)
        else:
            t0, t1 = nets.fwd(True, torch.cat([b["ux0_tea"], b["ux1_tea"]]), False).chunk(2)
        tea = t0 * (1 - m) + t1 * m
    if train_bn:
        s_sup = nets.fwd(False, b["sup_x"], True, dgen)
        s_mix = nets.fwd(False, x_mix, True, dgen)
    else:
        s_sup, s_mix = nets.fwd(False, torch.cat([b["sup_x"], x_mix]), False).split(
            [b["sup_x"].shape[0], n])
    sup = ce_ignore(s_sup, b["sup_y"])
    cons, conf = consistency(s_mix, tea, loss_mask, hp["conf_thresh"])
    return sup + cons * hp["cons_weight"], {"sup_loss": sup, "cons_loss": cons, "conf_rate": conf}


def make_batches(ds, geom, hp, seed: int, device, colour_gen):
    """The endless batches of epoch 0, as the trainer's streams give them."""
    bs = hp["batch_size"]
    sup = pipeline.Stream(ds.sup, bs, seed + 10)
    unsup = [pipeline.Stream(ds.unsup, bs * hp["unsup_batch_ratio"], seed + 20 + 10 * i)
             for i in range(2)]
    mean, std = hp["mean"], hp["std"]

    def crops(idx, labelled, stream):
        return [pipeline.sample_crop(geom, ds.image(int(i)).shape[:2], stream.crop_rng, labelled)
                for i in idx]

    while True:
        idx = sup.take()
        s = pipeline.augment(ds, idx, crops(idx, True, sup), geom, mean, std, True, None, device)
        batch = {"sup_x": s["image"], "sup_y": s["labels"]}
        for st, name, mk in zip(unsup, ("ux0", "ux1"), ("um0", "um1")):
            idx = st.take()
            c = pipeline.draw_colour(colour_gen, len(idx), hp["colour"])
            u = pipeline.augment(ds, idx, crops(idx, False, st), geom, mean, std, False, c, device)
            batch[name + "_tea"], batch[name + "_stu"], batch[mk] = \
                u["image"], u["image_stu"], u["mask"]
        yield batch


def run(model_cfg: dict, hp: dict, ds, geom, weights: Dict[str, torch.Tensor], seed: int,
        device, precision: str = "float32", steps: int = 3) -> dict:
    """Three iterations from ``seed``: {'losses': [{sup_loss, cons_loss,
    conf_rate}] per step, 'grad': {leaf: norm of its first gradient},
    'grad_tensors': {leaf: that gradient on the host},
    'change': {leaf: norm of its change over the steps}, 'teacher_change':
    {leaf: the same of the EMA teacher}}; ``precision`` 'fp8' computes the
    control, 'float64' a witness of float32's rounding
    (``models.Precision``)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    # cuDNN's heuristics: a search per shape would cost more than the steps
    torch.backends.cudnn.benchmark = False
    try:
        nets = Nets(model_cfg, weights, models.Precision(precision))
        p0 = {n: nets.sP[n].clone() for n in nets.train}
        opt = Optimiser(hp, {n: nets.sP[n] for n in nets.train}, nets.groups)
        gen = torch.Generator(device=device).manual_seed(seed)
        colour_gen = torch.Generator(device=device).manual_seed((seed + 40) * 100003 + 1)
        batches = make_batches(ds, geom, hp, seed, device, colour_gen)
        train_bn = not hp["freeze_bn"]
        out = {"losses": [], "grad": {}, "change": {}, "teacher_change": {}}
        for k in range(steps):
            b = {n: (t.to(nets.dtype) if t.is_floating_point() else t)
                 for n, t in next(batches).items()}
            for n in nets.train:
                nets.sP[n].requires_grad_(True)
            loss, metrics = mask_mt_losses(nets, hp, b, gen, train_bn)
            grads = torch.autograd.grad(loss, [nets.sP[n] for n in nets.train], allow_unused=True)
            for n in nets.train:
                nets.sP[n].requires_grad_(False)
            grads = {n: (g if g is not None else torch.zeros_like(nets.sP[n]))
                     for n, g in zip(nets.train, grads)}
            taken = opt.step(grads)
            nets.ema(hp["teacher_alpha"])
            out["losses"].append({k2: float(v.detach()) for k2, v in metrics.items()})
            if k == 0:
                out["grad"] = {n: float(g.norm()) for n, g in taken.items()}
                out["grad_tensors"] = {n: g.to("cpu", torch.float32, copy=True)
                                       for n, g in taken.items()}
        out["change"] = {n: float((nets.sP[n] - p0[n]).norm()) for n in nets.train}
        out["teacher_change"] = {n: float((nets.tP[n] - p0[n]).norm()) for n in nets.train}
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = prev
