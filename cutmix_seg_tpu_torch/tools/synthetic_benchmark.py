"""Synthetic semi-supervised convergence check of every ported algorithm
(port of cutmix_seg_tpu.tools.synthetic_benchmark):

    python -m cutmix_seg_tpu_torch.tools.synthetic_benchmark --algorithm all
    python -m cutmix_seg_tpu_torch.tools.synthetic_benchmark --algorithm vat_mt --device cpu

A procedurally generated segmentation task (discs and rectangles of 3
classes over textured backgrounds, 64x64, the same numpy draws as the JAX
tool), a small DeepLab v2 (layers 1, 1, 2, 1; float32), Adam 1e-3, and the
validation mIoU of supervised-only training against semi-supervised training
with few labels, for CutMix mean teacher (``mask_mt``), Cutout
(``cutout``), interpolation consistency (``ict``), virtual adversarial
training (``vat_mt``, adaptive radius) and augmentation consistency
(``aug_mt``, translated crop pairs). It prints one JSON line with the JAX
tool's keys plus ``device``. It runs on the GPU unless given ``--device
cpu``; on the GPU, ``mask_mt`` builds and launches the CUDA CutMix kernel.
"""

from __future__ import annotations

import json
import time

import click
import numpy as np
import torch

from cutmix_seg_tpu_torch.aug import affine as host_affine

ALGORITHMS = ("mask_mt", "cutout", "ict", "vat_mt", "aug_mt")


def make_image(rng, hw=(64, 64)):
    h, w = hw
    img = rng.uniform(0.2, 0.5, size=(1, 1, 3)) + rng.uniform(
        -0.08, 0.08, size=(h, w, 3))
    labels = np.zeros((h, w), np.int32)
    ys, xs = np.mgrid[0:h, 0:w]
    for _ in range(rng.randint(2, 5)):
        cls = rng.randint(1, 4)
        colour = np.array([0.9, 0.2, 0.2]) if cls == 1 else (
            np.array([0.2, 0.9, 0.2]) if cls == 2 else np.array([0.3, 0.3, 0.95]))
        colour = colour + rng.uniform(-0.1, 0.1, size=3)
        if rng.randint(2) == 0:
            cy, cx = rng.randint(8, h - 8), rng.randint(8, w - 8)
            r = rng.randint(5, 14)
            mask = (ys - cy) ** 2 + (xs - cx) ** 2 <= r * r
        else:
            y0, x0 = rng.randint(0, h - 12), rng.randint(0, w - 12)
            hh, ww = rng.randint(8, 20), rng.randint(8, 20)
            mask = (ys >= y0) & (ys < y0 + hh) & (xs >= x0) & (xs < x0 + ww)
        img[mask] = colour + rng.uniform(-0.05, 0.05, size=(int(mask.sum()), 3))
        labels[mask] = cls
    img = np.clip(img + rng.normal(0, 0.03, size=img.shape), 0, 1)
    return (img * 255).astype(np.uint8), labels


#: source canvas margin of the aug_mt translated-crop pairs: crop offsets are
#: drawn from [0, _AUG_MARGIN] on each axis
_AUG_MARGIN = 16


def _aug_pair_batch(unsup_src, idx, off_rng, hw):
    """Two translated crops of the same source images and the relative
    grid-space transform xf0->1, composed as the trainer's fetch_aug_pair
    does: crop matrices, composed with the inverse, then cv_to_grid."""
    n = len(idx)
    h, w = hw
    off = off_rng.randint(0, _AUG_MARGIN + 1, size=(n, 2, 2))  # (n, view, yx)
    x0 = np.stack([unsup_src[i, oy:oy + h, ox:ox + w]
                   for i, (oy, ox) in zip(idx, off[:, 0])])
    x1 = np.stack([unsup_src[i, oy:oy + h, ox:ox + w]
                   for i, (oy, ox) in zip(idx, off[:, 1])])
    # crop matrix: source px -> crop px is a translation by -offset
    m = np.tile(np.eye(2, 3, dtype=np.float64), (2, n, 1, 1))
    m[0, :, 0, 2] = -off[:, 0, 1]
    m[0, :, 1, 2] = -off[:, 0, 0]
    m[1, :, 0, 2] = -off[:, 1, 1]
    m[1, :, 1, 2] = -off[:, 1, 0]
    xf_cv = host_affine.compose(m[1], host_affine.invert(m[0]))
    xf_grid = host_affine.cv_to_grid(xf_cv, hw).astype(np.float32)
    return x0, x1, xf_grid


def _make_step(algorithm, model, opt, common):
    from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig
    from cutmix_seg_tpu_torch.semisup.aug_cons import AugConsConfig, make_aug_cons_step
    from cutmix_seg_tpu_torch.semisup.ict import ICTConfig, make_ict_step
    from cutmix_seg_tpu_torch.semisup.mask_mt import MaskConsistencyConfig, make_mask_mt_step
    from cutmix_seg_tpu_torch.semisup.vat import VATConfig, make_vat_step

    if algorithm == "mask_mt":
        return make_mask_mt_step(model, opt, MaskConsistencyConfig(
            mask_mode="mix", box=BoxMaskConfig((0.5, 0.5)), **common))
    if algorithm == "cutout":
        # the paper's Cutout row: box proportion drawn from 0.0:1.0
        # (run_pascal_aug_experiments.sh:20)
        return make_mask_mt_step(model, opt, MaskConsistencyConfig(
            mask_mode="zero", box=BoxMaskConfig((0.0, 1.0)), **common))
    if algorithm == "ict":
        return make_ict_step(model, opt, ICTConfig(ict_alpha=0.1, **common))
    if algorithm == "vat_mt":
        return make_vat_step(model, opt, VATConfig(vat_radius=0.5, adaptive_vat_radius=True,
                                                   **common))
    if algorithm == "aug_mt":
        return make_aug_cons_step(model, opt, AugConsConfig(**common))
    raise ValueError(f"unknown algorithm {algorithm!r}")


def run(iters=400, n_sup=8, n_unsup=256, n_val=64, batch=8, seed=0,
        cons_weight=1.0, algorithm="mask_mt", device=None):
    """Train one algorithm on the synthetic task; (val mIoU of the EMA
    teacher, the last step's sup loss)."""
    from cutmix_seg_tpu_torch.core.schedules import make_lr_schedule
    from cutmix_seg_tpu_torch.core.train_state import OptimizerConfig, create_train_state
    from cutmix_seg_tpu_torch.models.common import SegModel
    from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label
    from cutmix_seg_tpu_torch.ops.iou import EvaluatorIoU, confusion_matrix
    from cutmix_seg_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    hw = (64, 64)
    C = 4

    def gen(n, gen_hw=hw):
        xs, ys = [], []
        for _ in range(n):
            x, y = make_image(rng, gen_hw)
            xs.append(x)
            ys.append(y)
        return (np.stack(xs).astype(np.float32) / 255.0 - 0.5) / 0.25, np.stack(ys)

    # sup and val first, so they are the same for every algorithm; aug_mt
    # crops its two views from larger unsupervised canvases
    sup_x, sup_y = gen(n_sup)
    val_x, val_y = gen(n_val)
    src_hw = (hw[0] + _AUG_MARGIN, hw[1] + _AUG_MARGIN) if algorithm == "aug_mt" else hw
    unsup_x, _ = gen(n_unsup, src_hw)

    model = SegModel("tiny_deeplab_synth", DeepLab2(C, layers=(1, 1, 2, 1)),
                     np.zeros(3), np.ones(3), (1, 1), _param_label)
    opt_cfg = OptimizerConfig(opt_type="adam", learning_rate=1e-3,
                              lr_schedule=make_lr_schedule("none", 1e-3, iters))
    common = dict(cons_weight=cons_weight, conf_thresh=0.8, freeze_bn=True,
                  mean_teacher=True, teacher_alpha=0.99)
    state, opt = create_train_state(model, opt_cfg, seed, device=dev, mean_teacher=True,
                                    pretrained=False)
    step = _make_step(algorithm, model, opt, common)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sup_xd, sup_yd = on_dev(sup_x), on_dev(sup_y).long()
    unsup_d = on_dev(unsup_x) if algorithm != "aug_mt" else None
    ones = torch.ones((batch,) + hw + (1,), device=dev)
    data_rng = np.random.RandomState(seed + 1)
    metrics = None
    for it in range(iters):
        s_idx = data_rng.randint(0, n_sup, size=batch)
        u0 = data_rng.randint(0, n_unsup, size=batch)
        u1 = data_rng.randint(0, n_unsup, size=batch)
        s_t = on_dev(s_idx)
        bt = {"sup_x": sup_xd[s_t], "sup_y": sup_yd[s_t]}
        if algorithm in ("mask_mt", "ict"):
            x0, x1 = unsup_d[on_dev(u0)], unsup_d[on_dev(u1)]
            bt.update(ux0_tea=x0, ux0_stu=x0, um0=ones, ux1_tea=x1, ux1_stu=x1, um1=ones)
        elif algorithm in ("vat_mt", "cutout"):
            x0 = unsup_d[on_dev(u0)]
            bt.update(ux_tea=x0, ux_stu=x0, um=ones)
        else:
            x0, x1, xf = _aug_pair_batch(unsup_x, u0, data_rng, hw)
            bt.update(ux0=on_dev(x0), ux1=on_dev(x1), um0=ones, um1=ones,
                      xf0_to_1=on_dev(xf))
        state, metrics = step(state, bt, min(1.0, it / (iters * 0.3)))
    final_loss = float(metrics["sup_loss"])

    ev = EvaluatorIoU(C)
    with torch.no_grad():
        for s in range(0, n_val, batch):
            pred = state.teacher(on_dev(val_x[s:s + batch])).argmax(dim=-1)
            ev.update_cm(confusion_matrix(pred, on_dev(val_y[s:s + batch]), C))
    return ev.miou(), final_loss


@click.command()
@click.option("--iters", type=int, default=400)
@click.option("--n_sup", type=int, default=8)
@click.option("--seed", type=int, default=0)
@click.option("--algorithm", default="mask_mt", type=click.Choice(list(ALGORITHMS) + ["all"]))
@click.option("--device", default=None, help="torch device; the GPU unless 'cpu'")
def main(iters, n_sup, seed, algorithm, device):
    from cutmix_seg_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    t0 = time.time()
    algos = list(ALGORITHMS) if algorithm == "all" else [algorithm]
    # one supervised baseline serves every algorithm: with cons_weight 0 the
    # step is supervised CE + EMA whatever the algorithm, and the sup/val
    # sets are the same for every algorithm by construction
    miou_sup, _ = run(iters=iters, n_sup=n_sup, seed=seed, cons_weight=0.0, device=dev)
    out = {
        "task": "synthetic shapes, 4 classes, 64x64",
        "n_sup": n_sup, "iters": iters,
        "supervised_miou": round(miou_sup, 4),
    }
    for algo in algos:
        miou_semi, _ = run(iters=iters, n_sup=n_sup, seed=seed, cons_weight=1.0,
                           algorithm=algo, device=dev)
        if algo == "mask_mt":  # the JAX tool's historical keys
            out["cutmix_semisup_miou"] = round(miou_semi, 4)
            out["gain"] = round(miou_semi - miou_sup, 4)
        out[f"{algo}_semisup_miou"] = round(miou_semi, 4)
        out[f"{algo}_gain"] = round(miou_semi - miou_sup, 4)
    out["seconds"] = round(time.time() - t0, 1)
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
