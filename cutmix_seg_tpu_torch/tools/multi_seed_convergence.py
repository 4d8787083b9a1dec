"""Multi-seed algorithm-convergence sweep (port of
cutmix_seg_tpu.tools.multi_seed_convergence):

    python -m cutmix_seg_tpu_torch.tools.multi_seed_convergence --iters 6000 \
        --n_seeds 8 [--out DIR] [--device cpu]

Every consistency algorithm of the package (CutMix ``mask_mt``, Cutout,
ICT, VAT, aug_mt) against a per-seed supervised baseline on a procedurally
generated segmentation task, at n >= 5 seeds, reporting mean +/- std gains
in mIoU. The configurations are the reference sweep's
(run_pascal_aug_experiments.sh:19-25): CutMix prop 0.5, Cutout prop
0.0:1.0, ICT alpha 0.1, VAT adaptive radius 1 with cons_weight 0.1, aug_mt
cons_weight 1.0, all with the confidence gate.

The data, the per-iteration index streams and the aug_mt pair geometry (the
Hung crop-scale pair with flips, sampled on the host by the trainers' own
``aug.params.sample_geom_pair``) are the JAX tool's NumPy draws, bit for
bit. The JAX tool maps its step over a seed axis and scans the iterations;
here each seed keeps its own train state, data and step, and the seeds
advance in turn, one step each per iteration
(``parallel.multi_seed.step_in_turn``), so a seed's run is the run it would
have alone. On the GPU the CutMix arm launches the CUDA CutMix kernel once
per seed per iteration; the supervised arm (cons_weight 0) and the Cutout,
ICT, VAT and aug_mt arms never do. Seed s starts from the weights a
``torch.Generator`` seeded with s draws; the step's own draws (boxes, Beta
lambdas, VAT noise) come from the state's generator, and ``--strong_colour``
draws the student views' jitter from one generator per seed.

It writes ``results.json`` (and, after each arm, ``results_partial.json``)
with the JAX tool's keys; ``device`` names the torch device (the card's
name on the GPU). ``--out`` defaults to ``results/algo_convergence_multiseed``
(the JAX tool's default directory holds its own recorded run). It runs on
the GPU unless given ``--device cpu``.
"""

from __future__ import annotations

import functools
import json
import os
import time

import click
import numpy as np
import torch

from cutmix_seg_tpu_torch.parallel.multi_seed import step_in_turn
from cutmix_seg_tpu_torch.tools.synthetic_benchmark import make_image

HW = (64, 64)
C = 4
AUG_MARGIN = 16
TASK = "shapes"
#: the student views' colour generators are seeded with COLOUR_SEED * 1000 + seed
COLOUR_SEED = 97
ARMS = ("supervised", "mask_mt", "cutout", "ict", "vat_mt", "aug_mt")


def make_image_large(rng, hw):
    """Large-object variant of synthetic_benchmark.make_image: 1-3 shapes
    with radii ~h/5..h/2, so a Cutout box (prop 0.0:1.0) typically erases
    PART of an object while the rest stays visible."""
    h, w = hw
    img = rng.uniform(0.2, 0.5, size=(1, 1, 3)) + rng.uniform(
        -0.08, 0.08, size=(h, w, 3))
    labels = np.zeros((h, w), np.int32)
    ys, xs = np.mgrid[0:h, 0:w]
    for _ in range(rng.randint(1, 4)):
        cls = rng.randint(1, 4)
        colour = np.array([0.9, 0.2, 0.2]) if cls == 1 else (
            np.array([0.2, 0.9, 0.2]) if cls == 2
            else np.array([0.3, 0.3, 0.95]))
        colour = colour + rng.uniform(-0.1, 0.1, size=3)
        if rng.randint(2) == 0:
            cy = rng.randint(h // 6, 5 * h // 6)
            cx = rng.randint(w // 6, 5 * w // 6)
            r = rng.randint(h // 5, h // 2)
            mask = (ys - cy) ** 2 + (xs - cx) ** 2 <= r * r
        else:
            hh, ww = rng.randint(h // 3, 3 * h // 4), rng.randint(
                w // 3, 3 * w // 4)
            y0, x0 = rng.randint(0, h - h // 3), rng.randint(0, w - w // 3)
            mask = (ys >= y0) & (ys < y0 + hh) & (xs >= x0) & (xs < x0 + ww)
        img[mask] = colour + rng.uniform(-0.05, 0.05,
                                         size=(int(mask.sum()), 3))
        labels[mask] = cls
    img = np.clip(img + rng.normal(0, 0.03, size=img.shape), 0, 1)
    return (img * 255).astype(np.uint8), labels


def make_image_context(rng, hw):
    """Context-dependent pixel identity: classes 1 and 2 are discs of the
    SAME colour distribution, distinguished only by size (small vs large);
    class 3 is a colour-anchored rectangle, so a pixel's class cannot be
    read from its local colour alone."""
    h, w = hw
    img = rng.uniform(0.2, 0.5, size=(1, 1, 3)) + rng.uniform(
        -0.08, 0.08, size=(h, w, 3))
    labels = np.zeros((h, w), np.int32)
    ys, xs = np.mgrid[0:h, 0:w]

    def disc(cls, r_lo, r_hi):
        colour = np.array([0.85, 0.3, 0.25]) + rng.uniform(-0.1, 0.1, size=3)
        cy = rng.randint(h // 8, 7 * h // 8)
        cx = rng.randint(w // 8, 7 * w // 8)
        r = rng.randint(r_lo, r_hi)
        m = (ys - cy) ** 2 + (xs - cx) ** 2 <= r * r
        img[m] = colour + rng.uniform(-0.05, 0.05, size=(int(m.sum()), 3))
        labels[m] = cls

    for _ in range(rng.randint(1, 3)):   # large discs first
        disc(2, max(h // 4, 2), max(h // 3, 3))
    for _ in range(rng.randint(2, 6)):   # small discs may overlay
        disc(1, max(h // 16, 1), max(h // 9, 2))
    for _ in range(rng.randint(0, 3)):   # colour-anchored rectangles
        colour = np.array([0.3, 0.3, 0.95]) + rng.uniform(-0.1, 0.1, size=3)
        hh, ww = rng.randint(6, h // 3), rng.randint(6, w // 3)
        y0, x0 = rng.randint(0, h - 6), rng.randint(0, w - 6)
        m = (ys >= y0) & (ys < y0 + hh) & (xs >= x0) & (xs < x0 + ww)
        img[m] = colour + rng.uniform(-0.05, 0.05, size=(int(m.sum()), 3))
        labels[m] = 3
    img = np.clip(img + rng.normal(0, 0.03, size=img.shape), 0, 1)
    return (img * 255).astype(np.uint8), labels


_TASK_GENS = {"shapes": make_image, "large_shapes": make_image_large,
              "context_size": make_image_context}


def _gen_set(rng, n, hw, task=TASK):
    gen = _TASK_GENS[task]
    xs, ys = [], []
    for _ in range(n):
        x, y = gen(rng, hw)
        xs.append(x)
        ys.append(y)
    return ((np.stack(xs).astype(np.float32) / 255.0 - 0.5) / 0.25,
            np.stack(ys))


def build_seed_data(seed, n_sup, n_unsup, n_val, aug_src, hw=HW, task=TASK):
    """Per-seed datasets; sup/val are drawn FIRST so they are identical
    across algorithms (the unsup draw consumes size-dependent randomness)."""
    rng = np.random.RandomState(1000 + seed)
    sup_x, sup_y = _gen_set(rng, n_sup, hw, task)
    val_x, val_y = _gen_set(rng, n_val, hw, task)
    src_hw = (hw[0] + AUG_MARGIN, hw[1] + AUG_MARGIN) if aug_src else hw
    unsup_x, _ = _gen_set(rng, n_unsup, src_hw, task)
    return dict(sup_x=sup_x, sup_y=sup_y, val_x=val_x, val_y=val_y,
                unsup_x=unsup_x)


def index_streams(iters, batch, seeds, n_sup, n_unsup):
    """Per-iteration sample indices, (iters, K, batch) int32 each: ``s``
    into the supervised set, ``u0`` and ``u1`` into the unsupervised set.
    The stream offsets keep u0 and u1 independent (CutMix between two
    identical batches is a no-op) and every seed's streams distinct (seed
    stride 1000 >> the largest offset)."""
    stream = {}
    for name, off, hi in (("s", 0, n_sup), ("u0", 101, n_unsup),
                          ("u1", 203, n_unsup)):
        arr = np.stack([np.random.RandomState(2000 + s * 1000 + off)
                        .randint(0, hi, size=(iters, batch))
                        for s in seeds], axis=1)
        stream[name] = arr.astype(np.int32)
    return stream


def _aug_geometry(iters, batch, seeds, hw=HW):
    """Hung crop-scale PAIR geometry for every (iter, seed, sample): the
    trainers' own host sampler, composed to grid space in one vectorised
    pass. Returns (m0, m1, xf_grid), each (iters, K, batch, 2, 3) float32."""
    from cutmix_seg_tpu_torch.aug import affine as A
    from cutmix_seg_tpu_torch.aug.params import GeomConfig, sample_geom_pair

    geom = GeomConfig(crop_size=hw, mode="crop_scale_hung",
                      crop_offset=(AUG_MARGIN, AUG_MARGIN), hflip=True)
    src_hw = (hw[0] + AUG_MARGIN, hw[1] + AUG_MARGIN)
    K = len(seeds)
    m0 = np.zeros((iters, K, batch, 2, 3), np.float32)
    m1 = np.zeros((iters, K, batch, 2, 3), np.float32)
    for k, seed in enumerate(seeds):
        rng = np.random.RandomState(3000 + seed)
        for it in range(iters):
            for b in range(batch):
                (a0, _i0), (a1, _i1) = sample_geom_pair(
                    geom, src_hw, rng, False)
                m0[it, k, b] = a0
                m1[it, k, b] = a1
    flat0 = m0.reshape(-1, 2, 3).astype(np.float64)
    flat1 = m1.reshape(-1, 2, 3).astype(np.float64)
    xf_cv = A.compose(flat1, A.invert(flat0))
    xf_grid = A.cv_to_grid(xf_cv, hw).astype(np.float32).reshape(m0.shape)
    return m0, m1, xf_grid


def make_model():
    """The sweep's network: DeepLab v2 with layers (1, 1, 2, 1), C classes,
    float32, identity normalisation."""
    from cutmix_seg_tpu_torch.models.common import SegModel
    from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label

    return SegModel("tiny_deeplab_synth", DeepLab2(C, layers=(1, 1, 2, 1)),
                    np.zeros(3), np.ones(3), (1, 1), _param_label)


def arm_configs(conf_thresh):
    """arm -> (config, step factory, algorithm), the reference sweep's."""
    from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig
    from cutmix_seg_tpu_torch.semisup.aug_cons import AugConsConfig, make_aug_cons_step
    from cutmix_seg_tpu_torch.semisup.ict import ICTConfig, make_ict_step
    from cutmix_seg_tpu_torch.semisup.mask_mt import MaskConsistencyConfig, make_mask_mt_step
    from cutmix_seg_tpu_torch.semisup.vat import VATConfig, make_vat_step

    common = dict(conf_thresh=conf_thresh, freeze_bn=True, mean_teacher=True,
                  teacher_alpha=0.99)
    return {
        "supervised": (MaskConsistencyConfig(
            mask_mode="mix", box=BoxMaskConfig((0.5, 0.5)), cons_weight=0.0,
            **common), make_mask_mt_step, "mask_mt"),
        "mask_mt": (MaskConsistencyConfig(
            mask_mode="mix", box=BoxMaskConfig((0.5, 0.5)), cons_weight=1.0,
            **common), make_mask_mt_step, "mask_mt"),
        "cutout": (MaskConsistencyConfig(
            mask_mode="zero", box=BoxMaskConfig((0.0, 1.0)), cons_weight=1.0,
            **common), make_mask_mt_step, "cutout"),
        "ict": (ICTConfig(ict_alpha=0.1, cons_weight=1.0, **common),
                make_ict_step, "ict"),
        "vat_mt": (VATConfig(vat_radius=1.0, adaptive_vat_radius=True,
                             cons_weight=0.1, **common),
                   make_vat_step, "vat_mt"),
        "aug_mt": (AugConsConfig(cons_weight=1.0, **common),
                   make_aug_cons_step, "aug_mt"),
    }


def init_states(seeds, opt_cfg, device):
    """One independent train state per seed, seed s initialised from a
    generator seeded with s; returns ({k: state}, {k: (model, optimiser)})."""
    from cutmix_seg_tpu_torch.core.train_state import create_train_state

    states, models = {}, {}
    for k, s in enumerate(seeds):
        model = make_model()
        states[k], opt = create_train_state(model, opt_cfg, s, device=device,
                                            mean_teacher=True, pretrained=False)
        models[k] = (model, opt)
    return states, models


def make_arm_runner(cfg, make_step, algorithm, models, batch, hw=HW,
                    strong_colour=False, colour_generators=None):
    """``run_arm(states, data, stream, ramps, draws=None) -> (iters, K)
    sup losses``: every iteration steps each seed in turn, updating
    ``states`` in place.

    ``data[k]``: seed k's sup_x, sup_y, unsup_x on the device; ``stream``:
    ``index_streams`` (and, for aug_mt, m0 / m1 / xf from ``_aug_geometry``)
    as device tensors; ``ramps``: (iters,) float32 numpy.

    With ``strong_colour`` the teacher sees the clean views and the student
    the colour-jittered ones (the reference's pair composition: ToPair, then
    the colour transform on the second element), jittered in [0, 1] space
    with draws from ``colour_generators[k]``.

    ``draws(t, k)``, when given, returns the draws of seed k's step t in
    place of the generators': a dict that may hold the step's keyword
    (``rects``, ``lam`` or ``eps0``) and ``colour``, the two student views'
    ColourParams."""
    from cutmix_seg_tpu_torch.aug.device import warp_image_canvas_separable
    from cutmix_seg_tpu_torch.ops.colour import (
        ColourJitterConfig,
        apply_colour_jitter,
        sample_colour_params,
    )

    steps = {k: make_step(model, opt, cfg) for k, (model, opt) in models.items()}
    use_cons = cfg.cons_weight > 0.0
    cj_cfg = ColourJitterConfig()  # the trainers' strong-colour defaults

    def stu_view(x, k, params):
        if not strong_colour:
            return x
        if params is None:
            params = sample_colour_params(colour_generators[k], x.shape[0], cj_cfg)
        x01 = torch.clamp(x * 0.25 + 0.5, 0.0, 1.0)
        return (apply_colour_jitter(x01, params) - 0.5) / 0.25

    def seed_batch(k, data, stream, t, ones, draw):
        s = stream["s"][t, k]
        bt = {"sup_x": data["sup_x"][s], "sup_y": data["sup_y"][s]}
        if not use_cons:
            return bt
        colour = draw.get("colour", (None, None))
        u0 = data["unsup_x"][stream["u0"][t, k]]
        if algorithm in ("mask_mt", "ict"):
            u1 = data["unsup_x"][stream["u1"][t, k]]
            bt.update(ux0_tea=u0, ux0_stu=stu_view(u0, k, colour[0]), um0=ones,
                      ux1_tea=u1, ux1_stu=stu_view(u1, k, colour[1]), um1=ones)
        elif algorithm in ("vat_mt", "cutout"):
            bt.update(ux_tea=u0, ux_stu=stu_view(u0, k, colour[0]), um=ones)
        else:  # aug_mt: the Hung pair geometry, warped on the device
            sizes = torch.full((batch, 2), hw[0] + AUG_MARGIN, dtype=torch.int32,
                               device=u0.device)
            x0, v0 = warp_image_canvas_separable(u0, stream["m0"][t, k], sizes, hw)
            x1, v1 = warp_image_canvas_separable(u0, stream["m1"][t, k], sizes, hw)
            bt.update(ux0=x0, ux1=x1, um0=v0, um1=v1, xf0_to_1=stream["xf"][t, k])
        return bt

    def run_arm(states, data, stream, ramps, draws=None):
        dev = data[0]["sup_x"].device
        ones = torch.ones((batch,) + tuple(hw) + (1,), device=dev)
        losses = []
        for t in range(len(ramps)):
            per_seed = {k: draws(t, k) if draws is not None else {} for k in states}
            batches = {k: seed_batch(k, data[k], stream, t, ones, per_seed[k]) for k in states}
            seed_steps = {k: functools.partial(
                steps[k], **{n: v for n, v in per_seed[k].items() if n != "colour"})
                for k in states}
            metrics = step_in_turn(seed_steps, states, batches, float(ramps[t]))
            losses.append(torch.stack([metrics[k]["sup_loss"] for k in sorted(states)]))
        return torch.stack(losses).cpu().numpy()

    return run_arm


def seed_mious(states, data_np, n_val, batch, device):
    """Each seed's teacher mIoU on its validation set."""
    from cutmix_seg_tpu_torch.eval.evaluator import eval_confusion_normalised
    from cutmix_seg_tpu_torch.ops.iou import EvaluatorIoU

    mious = []
    for k in sorted(states):
        ev = EvaluatorIoU(C)
        for s0 in range(0, n_val, batch):
            x = torch.from_numpy(data_np[k]["val_x"][s0:s0 + batch]).to(device)
            y = torch.from_numpy(data_np[k]["val_y"][s0:s0 + batch]).to(device)
            ev.update_cm(eval_confusion_normalised(states[k].teacher, x, y, C))
        mious.append(ev.miou())
    return mious


def run_sweep(iters, n_seeds, n_sup, n_unsup, n_val, batch, algorithms, hw, task,
              conf_thresh, strong_colour, out, device=None, log=print):
    """The sweep; returns the results document (also written to ``out``)."""
    from cutmix_seg_tpu_torch.core.schedules import make_lr_schedule
    from cutmix_seg_tpu_torch.core.train_state import OptimizerConfig
    from cutmix_seg_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    hw = (hw, hw)
    t_start = time.time()
    seeds = list(range(n_seeds))
    algos = [a.strip() for a in algorithms.split(",") if a.strip()]
    opt_cfg = OptimizerConfig(opt_type="adam", learning_rate=1e-3,
                              lr_schedule=make_lr_schedule("none", 1e-3, iters))
    arm_cfgs = arm_configs(conf_thresh)
    ramps = np.minimum(1.0, np.arange(iters) / (iters * 0.3)).astype(np.float32)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    aug_geom = None
    results = {}
    for arm in ["supervised"] + algos:
        cfg, make_step, algorithm = arm_cfgs[arm]
        t0 = time.time()
        data_np = [build_seed_data(s, n_sup, n_unsup, n_val, aug_src=(algorithm == "aug_mt"),
                                   hw=hw, task=task) for s in seeds]
        data = {k: {"sup_x": on_dev(d["sup_x"]), "sup_y": on_dev(d["sup_y"]).long(),
                    "unsup_x": on_dev(d["unsup_x"])} for k, d in enumerate(data_np)}
        stream = {name: on_dev(a).long()
                  for name, a in index_streams(iters, batch, seeds, n_sup, n_unsup).items()}
        if algorithm == "aug_mt":
            if aug_geom is None:
                log(f"sampling aug_mt pair geometry ({iters}x{n_seeds}x{batch})...")
                aug_geom = _aug_geometry(iters, batch, seeds, hw)
            stream.update(zip(("m0", "m1", "xf"), map(on_dev, aug_geom)))
        states, models = init_states(seeds, opt_cfg, dev)
        colour_generators = {k: torch.Generator(device=dev).manual_seed(COLOUR_SEED * 1000 + s)
                             for k, s in enumerate(seeds)}
        runner = make_arm_runner(cfg, make_step, algorithm, models, batch, hw=hw,
                                 strong_colour=strong_colour,
                                 colour_generators=colour_generators)
        losses = runner(states, data, stream, ramps)
        mious = seed_mious(states, data_np, n_val, batch, dev)
        results[arm] = {
            "miou_per_seed": [round(m, 4) for m in mious],
            "mean": round(float(np.mean(mious)), 4),
            "std": round(float(np.std(mious)), 4),
            "final_sup_loss_mean": round(float(losses[-1].mean()), 4),
            "seconds": round(time.time() - t0, 1),
        }
        log(arm + " " + json.dumps(results[arm]))
        # partial progress: completed arms survive a cutoff
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "results_partial.json"), "w") as f:
            json.dump({"arms": results, "n_seeds": n_seeds, "iters": iters}, f, indent=2)

    sup = np.array(results["supervised"]["miou_per_seed"])
    for arm in algos:
        arr = np.array(results[arm]["miou_per_seed"])
        gains = arr - sup
        results[arm]["gain_per_seed"] = [round(g, 4) for g in gains]
        results[arm]["gain_mean"] = round(float(gains.mean()), 4)
        results[arm]["gain_std"] = round(float(gains.std()), 4)

    out_doc = {
        "task": f"synthetic {task}, {C} classes, {hw[0]}x{hw[1]}",
        "n_seeds": n_seeds, "iters": iters, "n_sup": n_sup,
        "configs": "reference sweep configs "
                   "(run_pascal_aug_experiments.sh:19-25); conf gate "
                   f"{conf_thresh}; strong_colour={strong_colour}; "
                   "aug_mt = full Hung crop-scale pair geometry",
        "arms": results,
        "total_seconds": round(time.time() - t_start, 1),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
    }
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "results.json"), "w") as f:
        json.dump(out_doc, f, indent=2)
    return out_doc


@click.command()
@click.option("--iters", type=int, default=6000)
@click.option("--n_seeds", type=int, default=8)
@click.option("--n_sup", type=int, default=6)
@click.option("--n_unsup", type=int, default=256)
@click.option("--n_val", type=int, default=64)
@click.option("--batch", type=int, default=8)
@click.option("--algorithms", default="mask_mt,cutout,ict,vat_mt,aug_mt")
@click.option("--hw", type=int, default=64, help="square task size")
@click.option("--task", type=click.Choice(
    ["shapes", "large_shapes", "context_size"]), default="shapes")
@click.option("--conf_thresh", type=float, default=0.8)
@click.option("--strong_colour", is_flag=True, default=False,
              help="reference pair composition: student views colour-"
                   "jittered on device, teacher views clean")
@click.option("--out", default="results/algo_convergence_multiseed")
@click.option("--device", default=None, help="torch device; the GPU unless 'cpu'")
def main(iters, n_seeds, n_sup, n_unsup, n_val, batch, algorithms, hw, task,
         conf_thresh, strong_colour, out, device):
    out_doc = run_sweep(iters, n_seeds, n_sup, n_unsup, n_val, batch, algorithms, hw, task,
                        conf_thresh, strong_colour, out, device=device,
                        log=lambda msg: print(msg, flush=True))
    print(json.dumps(out_doc))


if __name__ == "__main__":
    main()
