"""Toy-2D semi-supervised trainer (Figure-3 experiments; port of
cutmix_seg_tpu.toy2d.train).

Re-derivation of the reference's toy2d_train.py: MLP on 2D points with
Gaussian-perturbation consistency, optional distance-map contour gating, and
per-epoch decision-boundary renders. The whole iteration (sup CE +
consistency + Adam + EMA) is one step with a single backward over the
combined loss, as the reference does here (toy2d_train.py:401-412); renders
are saved with PIL.

Model variants (reference: toy2d_train.py:355-366):
  mean_teacher — EMA teacher provides no-grad targets;
  pi           — the target branch is a second student forward WITH gradient;
  pi_onebatch  — both branches through one concatenated forward.

The host's draws (data, permutations, supervised picks) come from
``np.random.RandomState(seed)`` in the JAX trainer's order, so both
trainers see the same points; the step's own draws (perturbation noise,
dropout masks) come from a torch generator seeded with ``seed``, or are
given to the step (``noise=``, ``drop_masks=``). Runs on the GPU unless
given ``--device cpu``.

    python -m cutmix_seg_tpu_torch.toy2d.train --dataset=img:data/toy2d/curve_mask_v3.png \
        --sup_path=data/toy2d/curve_mask_v3_35.pkl --region_erode_radius=35 --save_output
"""

from __future__ import annotations

import copy
import os
import time
from typing import Optional, Sequence

import click
import numpy as np
import torch
from torch.nn import functional as F

from cutmix_seg_tpu_torch.core import job
from cutmix_seg_tpu_torch.core.train_state import Optimizer, OptimizerConfig
from cutmix_seg_tpu_torch.semisup.ema import ema_update, float_tensors
from cutmix_seg_tpu_torch.toy2d import data as toy_data
from cutmix_seg_tpu_torch.toy2d.model import ToyMLP
from cutmix_seg_tpu_torch.utils.device import resolve_device


def _sample_dist_map(dist_map: torch.Tensor, pts_yx: torch.Tensor) -> torch.Tensor:
    """Bilinear point sampling of the signed distance map with torch
    grid_sample default semantics (align_corners=False, zeros padding;
    reference: toy2d_train.py:174-206), in the JAX function's arithmetic.
    pts_yx are in [-1, 1] real space."""
    h, w = dist_map.shape
    px = ((pts_yx[:, 1] + 1.0) * w - 1.0) / 2.0
    py = ((pts_yx[:, 0] + 1.0) * h - 1.0) / 2.0
    x0 = torch.floor(px).long()
    y0 = torch.floor(py).long()
    fx = px - x0
    fy = py - y0

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = dist_map[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inb, v, 0.0)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def _robust_bce(pred, tgt):
    return -(tgt * torch.log(pred + 1e-6) + (1 - tgt) * torch.log(1 - pred + 1e-6))


class Toy2DAlgo:
    """The toy2d algorithm core: forward wrapper, confidence / dist-map
    gating, the consistency menu, the one fused train step, prediction and
    the Figure-3 gradient-magnitude probe (reference: toy2d_train.py:146-206,
    233-278,325-443). ``opt`` is the student's Adam (``optax.adam(lr)``'s
    arithmetic); ``generator`` draws the noise and the dropout masks that a
    step is not given."""

    def __init__(self, opt: Optimizer, *, model, cons_weight, cons_loss_fn,
                 cons_no_dropout, conf_thresh, conf_avg, teacher_alpha, pstd_real,
                 dist_contour_range=0.0, dist_map=None,
                 generator: Optional[torch.Generator] = None):
        self.opt = opt
        self.model = model
        self.mean_teacher = model == "mean_teacher"
        self.cons_weight = cons_weight
        self.cons_loss_fn = cons_loss_fn
        self.use_dropout_cons = not cons_no_dropout
        self.conf_thresh = conf_thresh
        self.conf_avg = conf_avg
        self.teacher_alpha = teacher_alpha
        self.pstd_real = torch.as_tensor(np.asarray(pstd_real), dtype=torch.float32)
        self.dist_contour_range = dist_contour_range
        self.dist_map = dist_map
        self.generator = generator

    def fwd(self, net: ToyMLP, x, *, train: bool, use_dropout: bool, keep=None,
            update_stats: Optional[bool] = None):
        net.train(train)
        return net(x, use_dropout=use_dropout, keep=keep, update_stats=update_stats)

    def conf_factor(self, prob_tea):
        conf = prob_tea.max(dim=1).values
        fac = ((conf >= self.conf_thresh).float() if self.conf_thresh > 0.0
               else torch.ones_like(conf))
        if self.conf_avg:
            fac = torch.ones_like(fac) * fac.mean()
        return fac

    def dist_weight(self, xu, xu1):
        if self.dist_map is None or self.dist_contour_range <= 0:
            return torch.ones((xu.shape[0],), dtype=torch.float32, device=xu.device)
        d0 = _sample_dist_map(self.dist_map, xu)
        d1 = _sample_dist_map(self.dist_map, xu1)
        return ((d0 - d1) ** 2 <= self.dist_contour_range ** 2).float()

    def cons_terms(self, stu_logits, tea_logits, mod_fac, weight):
        p_stu = F.softmax(stu_logits, dim=1)
        p_tea = F.softmax(tea_logits, dim=1)
        if self.cons_loss_fn == "bce":
            per = _robust_bce(p_stu, p_tea).mean(dim=1)
        elif self.cons_loss_fn == "var":
            d = p_stu - p_tea
            per = (d * d).mean(dim=1)
        elif self.cons_loss_fn == "logits_var":
            d = stu_logits - tea_logits
            per = (d * d).mean(dim=1)
        else:
            raise ValueError(self.cons_loss_fn)
        return (per * mod_fac).sum() / torch.clamp_min(weight.sum(), 1e-12)

    def _noise(self, x):
        return (torch.randn(x.shape, generator=self.generator, device=x.device)
                * self.pstd_real.to(x.device)[None, :])

    def train_step(self, student: ToyMLP, teacher: Optional[ToyMLP], sup_x, sup_y, unsup_x,
                   noise=None, drop_masks: Optional[Sequence[torch.Tensor]] = None) -> dict:
        """One step in place: the student's Adam update, its statistics and
        the EMA teacher; returns the metrics as 0-d tensors. ``noise``: the
        perturbation already scaled by the noise std (JAX's
        ``normal(k_noise) * pstd_real``); ``drop_masks``: the keep masks of
        the step's dropout forwards in order (sup, then the consistency
        forwards that use dropout)."""
        unsup_x1 = unsup_x + (self._noise(unsup_x) if noise is None else noise)
        masks = iter(drop_masks or ())
        for net in (student, teacher):
            if net is not None:
                net.generator = self.generator
        use_drop = self.use_dropout_cons

        def keep(use):
            return next(masks, None) if use else None

        self.opt.zero_grad()
        sup_logits = self.fwd(student, sup_x, train=True, use_dropout=True, keep=keep(True))
        sup_loss = -F.log_softmax(sup_logits, dim=1).gather(1, sup_y[:, None]).mean()
        metrics = {"sup_loss": sup_loss.detach()}
        total = sup_loss
        if self.cons_weight > 0.0:
            if self.mean_teacher:
                with torch.no_grad():
                    tea_logits = self.fwd(teacher, unsup_x, train=True, use_dropout=use_drop,
                                          keep=keep(use_drop), update_stats=False)
                stu_logits = self.fwd(student, unsup_x1, train=True, use_dropout=use_drop,
                                      keep=keep(use_drop))
            elif self.model == "pi":
                tea_logits = self.fwd(student, unsup_x, train=True, use_dropout=use_drop,
                                      keep=keep(use_drop))
                stu_logits = self.fwd(student, unsup_x1, train=True, use_dropout=use_drop,
                                      keep=keep(use_drop))
            else:  # pi_onebatch
                logits = self.fwd(student, torch.cat([unsup_x, unsup_x1]), train=True,
                                  use_dropout=use_drop, keep=keep(use_drop))
                tea_logits, stu_logits = logits[:unsup_x.shape[0]], logits[unsup_x.shape[0]:]
            weight = self.dist_weight(unsup_x, unsup_x1)
            cfac = self.conf_factor(F.softmax(tea_logits.detach(), dim=1))
            cons_loss = self.cons_terms(stu_logits, tea_logits, cfac * weight, weight)
            total = total + cons_loss * self.cons_weight
            metrics["cons_loss"] = cons_loss.detach()
            metrics["conf_sum"] = cfac.sum()
        total.backward()
        self.opt.step()
        if self.mean_teacher:
            ema_update(float_tensors(teacher), float_tensors(student), self.teacher_alpha)
        return metrics

    @torch.no_grad()
    def predict(self, net: ToyMLP, x):
        return self.fwd(net, x, train=False, use_dropout=True)

    def cons_grad_mag(self, pred_net: ToyMLP, student: ToyMLP, x, noise=None):
        """|d cons_loss / d student logits| per point, for the Figure-3
        gradient render (reference: toy2d_train.py:233-278)."""
        x1 = x + (self._noise(x) if noise is None else noise)
        tea_logits = self.predict(pred_net, x)
        weight = self.dist_weight(x, x1)
        mod_fac = self.conf_factor(F.softmax(tea_logits, dim=1)) * weight
        stu_logits = self.predict(student, x1).requires_grad_(True)
        (g,) = torch.autograd.grad(self.cons_terms(stu_logits, tea_logits, mod_fac, weight),
                                   stu_logits)
        return torch.sqrt((g * g).sum(dim=1))


def train_toy2d(ctx: job.RunContext, dataset, region_erode_radius,
                img_noise_std, n_sup, balance_classes, seed, sup_path, model,
                n_hidden, hidden_size, hidden_act, norm_layer,
                perturb_noise_std, dist_contour_range, conf_thresh, conf_avg,
                cons_weight, cons_loss_fn, cons_no_dropout, learning_rate,
                teacher_alpha, num_epochs, batch_size, render_cons_grad,
                render_pred, save_output, device=None):
    settings = {k: v for k, v in locals().items() if k not in ("ctx", "device")}
    print("Settings:")
    print(", ".join(f"{k}={settings[k]}" for k in sorted(settings)))
    dev = resolve_device(device)

    rng_np = np.random.RandomState(seed)

    # ---- dataset ----
    if dataset.startswith("img:"):
        ds = toy_data.classification_dataset_from_image(
            dataset[4:], region_erode_radius, img_noise_std, n_sup,
            balance_classes, rng_np)
        image = ds.image
    elif dataset == "spiral":
        ds = toy_data.spiral_classification_dataset(n_sup, balance_classes, rng_np)
        image = None
    else:
        print(f"Unknown dataset {dataset}, should be spiral or img:<path>")
        return
    if sup_path is not None:
        ds.load_supervised(sup_path)

    dist_map = None
    if dist_contour_range > 0.0:
        if image is None:
            print("Constraining perturbations to lying on distance map "
                  "contours is only supported for 'image' experiments")
            return
        from scipy.ndimage import distance_transform_edt

        img1 = image >= 0.5
        dist_map = (distance_transform_edt(img1) * img1
                    - distance_transform_edt(~img1) * (~img1))
        dist_map = torch.as_tensor(dist_map, dtype=torch.float32, device=dev)

    try:
        pstd = np.array([float(x.strip()) for x in perturb_noise_std.split(",")])
    except ValueError:
        pstd = np.array([6.0, 6.0])
    if pstd.size == 1:
        pstd = np.repeat(pstd, 2)
    pstd_real = np.float32(pstd / ds.img_scale * 2.0)

    # ---- model / state ----
    gen = torch.Generator().manual_seed(seed)
    student = ToyMLP(n_hidden=n_hidden, hidden_size=hidden_size, hidden_act=hidden_act,
                     norm_layer=norm_layer)
    student.reset_parameters(gen)
    student.to(dev)
    teacher = (copy.deepcopy(student).requires_grad_(False)
               if model == "mean_teacher" else None)
    names = dict(student.named_parameters())
    opt = Optimizer(OptimizerConfig(opt_type="adam", learning_rate=learning_rate), names,
                    {n: "new" for n in names})

    algo = Toy2DAlgo(opt, model=model, cons_weight=cons_weight,
                     cons_loss_fn=cons_loss_fn, cons_no_dropout=cons_no_dropout,
                     conf_thresh=conf_thresh, conf_avg=conf_avg,
                     teacher_alpha=teacher_alpha, pstd_real=pstd_real,
                     dist_contour_range=dist_contour_range, dist_map=dist_map,
                     generator=torch.Generator(device=dev).manual_seed(seed))

    def pred_net():
        return teacher if algo.mean_teacher else student

    # ---- rendering ----
    grid = torch.as_tensor(ds.px_grid_vis, dtype=torch.float32, device=dev)

    def render():
        logits = algo.predict(pred_net(), grid)
        if render_pred == "prob":
            vis = F.softmax(logits, dim=1)[:, 1].cpu().numpy()
        elif render_pred == "class":
            vis = logits.argmax(dim=1).cpu().numpy()
        else:
            raise ValueError(render_pred)
        grad_vis = (algo.cons_grad_mag(pred_net(), student, grid).cpu().numpy()
                    if render_cons_grad else None)
        return ds.semisup_image_plot(vis, grad_vis)

    def save_render(epoch):
        if save_output and ctx.run_dir is not None:
            from PIL import Image

            path = os.path.join(ctx.run_dir, f"epoch_{epoch:05d}.png")
            Image.fromarray(render()).save(path)

    save_render(0)

    # ---- training ----
    print(f"|sup|={len(ds.sup_X)}")
    print(f"|unsup|={len(ds.unsup_X)}")
    print(f"|all|={len(ds.X)}")
    print("Training...")

    sup_X = torch.as_tensor(np.asarray(ds.sup_X, np.float32), device=dev)
    sup_y = torch.as_tensor(np.asarray(ds.sup_y, np.int64), device=dev)
    unsup_X = torch.as_tensor(np.asarray(ds.unsup_X, np.float32), device=dev)
    n_unsup = len(unsup_X)
    iters = max(n_unsup // batch_size, 1)

    for epoch in range(num_epochs):
        t1 = time.time()
        order = rng_np.permutation(n_unsup)
        sums = {"sup_loss": 0.0, "cons_loss": 0.0, "conf_sum": 0.0}
        n_acc = 0
        for it in range(iters):
            u_idx = torch.as_tensor(order[it * batch_size:(it + 1) * batch_size], device=dev)
            s_idx = torch.as_tensor(
                rng_np.randint(0, len(sup_X), size=min(batch_size, len(sup_X))), device=dev)
            metrics = algo.train_step(student, teacher, sup_X[s_idx], sup_y[s_idx],
                                      unsup_X[u_idx])
            # summed on the device, fetched once per epoch
            sums = {k: sums[k] + metrics.get(k, 0.0) for k in sums}
            n_acc += len(s_idx)
        acc = {k: float(v) / n_acc for k, v in sums.items()}

        save_render(epoch + 1)
        t2 = time.time()
        print("Epoch {}: took {:.3f}s: clf loss={:.6f}, conf rate={:.3%}, "
              "cons loss={:.6f}".format(epoch + 1, t2 - t1, acc["sup_loss"],
                                        acc["conf_sum"], acc["cons_loss"]))
        ctx.log_metrics({"epoch": epoch + 1, "sup_loss": acc["sup_loss"],
                         "cons_loss": acc["cons_loss"], "conf_rate": acc["conf_sum"],
                         "epoch_time": t2 - t1})

    # ---- final error over all points ----
    all_X = torch.as_tensor(np.asarray(ds.X, np.float32), device=dev)
    all_pred = torch.cat([algo.predict(pred_net(), all_X[start:start + 16384]).argmax(dim=1)
                          for start in range(0, len(all_X), 16384)]).cpu().numpy()
    err = (all_pred != ds.y).mean()
    print("FINAL RESULT: Error rate={:.6%} (supervised and unsupervised "
          "samples)".format(err))
    return err


@click.command()
@click.option("--job_desc", type=str, default="")
@click.option("--dataset", type=str, default="spiral")
@click.option("--region_erode_radius", type=int, default=35)
@click.option("--img_noise_std", type=float, default=2.0)
@click.option("--n_sup", type=int, default=10)
@click.option("--balance_classes", is_flag=True, default=False)
@click.option("--seed", type=int, default=12345)
@click.option("--sup_path", type=click.Path(dir_okay=False, exists=True))
@click.option("--model", type=click.Choice(["mean_teacher", "pi", "pi_onebatch"]),
              default="mean_teacher")
@click.option("--n_hidden", type=int, default=3)
@click.option("--hidden_size", type=int, default=512)
@click.option("--hidden_act", type=click.Choice(["relu", "lrelu"]), default="relu")
@click.option("--norm_layer", type=click.Choice(
    ["none", "batch_norm", "weight_norm", "spectral_norm", "group_norm"]),
    default="batch_norm")
@click.option("--perturb_noise_std", type=str, default="6.0")
@click.option("--dist_contour_range", type=float, default=0.0)
@click.option("--conf_thresh", type=float, default=0.97)
@click.option("--conf_avg", is_flag=True, default=False)
@click.option("--cons_weight", type=float, default=10.0)
@click.option("--cons_loss_fn", type=click.Choice(["var", "bce", "logits_var"]),
              default="var")
@click.option("--cons_no_dropout", is_flag=True, default=False)
@click.option("--learning_rate", type=float, default=2e-4)
@click.option("--teacher_alpha", type=float, default=0.99)
@click.option("--num_epochs", type=int, default=100)
@click.option("--batch_size", type=int, default=512)
@click.option("--render_cons_grad", is_flag=True, default=False)
@click.option("--render_pred", type=click.Choice(["class", "prob"]),
              default="prob")
@click.option("--save_output", is_flag=True, default=False)
@click.option("--device", type=str, default="cuda",
              help="cuda, or cpu (the plain CPU run)")
def experiment(job_desc, **params):
    job.submit("toy2d_train", job_desc, train_toy2d, params)


if __name__ == "__main__":
    experiment()
