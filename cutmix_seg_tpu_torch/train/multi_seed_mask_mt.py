"""Multi-seed trainer: K split seeds of any consistency algorithm in one run
(port of cutmix_seg_tpu.train.multi_seed_mask_mt):

    python -m cutmix_seg_tpu_torch.train.multi_seed_mask_mt --algorithm mask_mt \\
        --parallel_split_seeds 12345,23456 ...
    torchrun --nproc_per_node=N -m cutmix_seg_tpu_torch.train.multi_seed_mask_mt ...

``--parallel_split_seeds`` replaces --split_seed; every other flag of the
JAX CLI carries over. Seed k has its own data split, train state (init seed
``seed + k``), host streams (seeds ``ep + 10 + k * 100`` and
``ep + 20 + si * 10 + k * 100``), colour generator and step; the seeds run
in turn on one GPU, or rank r of N trains the seeds r::N
(``parallel.multi_seed``). Seed 0 takes exactly the draws of the
single-seed trainer with its split seed. Each epoch prints one
reference-format line per seed and logs its JSONL record; the run ends with
the ``SEEDS AGGREGATE`` line (mean and sample std of the seeds' last
mIoU). Checkpoints go to ``checkpoints/seed_<k>/``, written by the seed's
owner; ``--resume`` requires every seed at the same step. The options that
change a seed's program, ``--grad_accum`` and ``--spatial_train`` above 1,
are refused as the JAX trainer refuses them.
"""

from __future__ import annotations

import os
import time

import click
import numpy as np
import torch

from cutmix_seg_tpu_torch.core import checkpoint as ckpt
from cutmix_seg_tpu_torch.core import job
from cutmix_seg_tpu_torch.core.train_state import create_train_state
from cutmix_seg_tpu_torch.data import datasets
from cutmix_seg_tpu_torch.data.loader import HostBatchBuilder, train_stream
from cutmix_seg_tpu_torch.parallel import mesh as mesh_mod
from cutmix_seg_tpu_torch.parallel.multi_seed import (
    gather_seed_rows,
    owned_seeds,
    step_in_turn,
)
from cutmix_seg_tpu_torch.semisup.stepcore import accum_zero_metrics
from cutmix_seg_tpu_torch.train import common
from cutmix_seg_tpu_torch.train.cli_common import common_options
from cutmix_seg_tpu_torch.train.engine import check_n_devices
from cutmix_seg_tpu_torch.utils.device import resolve_device
from cutmix_seg_tpu_torch.utils.rampup import sigmoid_rampup

METRICS = ("sup_loss", "cons_loss", "conf_rate")


def _build_spec(p):
    algo = p.get("algorithm", "mask_mt")
    if algo == "mask_mt":
        from cutmix_seg_tpu_torch.train.mask_mt import build_spec
    elif algo == "ict":
        from cutmix_seg_tpu_torch.train.ict import build_spec
    elif algo == "vat_mt":
        from cutmix_seg_tpu_torch.train.vat_mt import build_spec
    elif algo == "aug_mt":
        from cutmix_seg_tpu_torch.train.aug_mt import build_spec
    else:
        raise ValueError(f"unknown algorithm {algo!r}")
    return build_spec(p)


def seed_colour_seed(base_seed: int, epoch_i: int, k: int) -> int:
    """Seed k's colour generator in an epoch (seed 0's is the single-seed
    trainer's)."""
    return common.epoch_colour_seed(base_seed, epoch_i) + k * (1 << 32)


def train_seg_semisup_mask_mt_multiseed(ctx: job.RunContext, device=None, **p):
    """Run the sweep on ``device`` (CUDA unless the caller passes
    ``device="cpu"``); returns {seed index: train state} of this rank's
    seeds."""
    # the seeds are independent programs of one structure: options that
    # change a seed's program are not wired through; refuse them loudly
    # rather than parse and ignore them
    for flag in ("grad_accum", "spatial_train"):
        if int(p.get(flag, 1) or 1) > 1:
            raise ValueError(
                f"--{flag} is not supported by the multi-seed trainer; run "
                "the single-seed CLI per seed instead")
    seeds = [int(s.strip()) for s in p["parallel_split_seeds"].split(",")]
    K = len(seeds)
    device = resolve_device(device)
    mesh_mod.maybe_initialize_distributed(device)
    check_n_devices(p, mesh_mod.world())
    mesh = mesh_mod.data_mesh()
    mine = owned_seeds(K, mesh)
    lead = mesh_mod.is_lead()
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    crop_hw = common.parse_crop_size(p["crop_size"])
    if crop_hw is None:
        raise ValueError("the pipeline requires a crop_size (static shapes)")

    # per-seed data splits (same source; split selection differs per seed)
    ds_dicts = [datasets.load_dataset(
        p["dataset"], p["n_val"], p["val_seed"], p["n_sup"], p["n_unsup"],
        split_seed, p["split_path"]) for split_seed in seeds]
    ds = ds_dicts[0]["ds_src"]
    n_classes = ds.num_classes
    val_ndx = ds_dicts[0]["val_ndx_tgt"]
    print("Loaded data")
    for k, d in enumerate(ds_dicts):
        print(f"seed {seeds[k]}: len(sup_ndx)={len(d['sup_ndx'])} "
              f"len(unsup_ndx)={len(d['unsup_ndx'])}")

    if p["iters_per_epoch"] == -1:
        p["iters_per_epoch"] = len(ds_dicts[0]["unsup_ndx"]) // p["batch_size"]
    total_iters = p["iters_per_epoch"] * p["num_epochs"]
    opt_cfg = common.build_optimizer_config(
        p["opt_type"], p["learning_rate"], p["lr_sched"], p["lr_step_epochs"],
        p["lr_step_gamma"], p["lr_poly_power"], total_iters,
        p["iters_per_epoch"], p["sgd_momentum"], p["sgd_nesterov"],
        p["sgd_weight_decay"])

    mean_teacher = p["model"] == "mean_teacher"
    spec, cfg = _build_spec(p)
    models, states, steps = {}, {}, {}
    for k in mine:
        models[k] = common.build_model(p["arch"], n_classes, p.get("compute_dtype", "bfloat16"))
        states[k], opt = create_train_state(
            models[k], opt_cfg, p.get("seed", 0) + k, device=device,
            mean_teacher=mean_teacher, pretrained=not p.get("no_pretrained", False))
        steps[k] = spec.make_step(models[k], opt)
    print("Built networks")
    model = models[mine[0]] if mine else common.build_model(p["arch"], n_classes)
    mean, std = common.resolve_mean_std(model, ds)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(std, dtype=torch.float32, device=device)

    geom = common.build_geom(p, crop_hw, pair=spec.pair_geom and "aug_offset_range" in p)
    augmentor = common.DeviceAugmentor(mean, std, crop_hw, geom.mode, common.build_colour(p),
                                       separable=common.separable_for_geom(geom))
    use_cons = p["cons_weight"] > 0.0
    sup_builder = HostBatchBuilder(ds, geom, with_labels=True, n_threads=p["num_workers"])
    unsup_builder = HostBatchBuilder(ds, geom, with_labels=False, pair_geom=spec.pair_geom,
                                     n_threads=p["num_workers"])
    base = p.get("seed", 0)
    streams = {}  # seed index -> (sup stream, [unsup streams])
    colour_gens = {}

    def close_streams():
        for sup, unsup in streams.values():
            for s in [sup] + unsup:
                s.close()
        streams.clear()

    def open_epoch_streams(epoch_i):
        """Epoch-folded stream and colour seeds: the engine's exact-resume
        contract (train/engine.py::_open_epoch_streams), per seed."""
        close_streams()
        ep = common.epoch_stream_seed(base, epoch_i)
        for k in mine:
            sup = train_stream(sup_builder, ds_dicts[k]["sup_ndx"], p["batch_size"],
                               seed=ep + 10 + k * 100)
            unsup = []
            if use_cons:
                ub = p["batch_size"] * p["unsup_batch_ratio"]
                unsup = [train_stream(unsup_builder, ds_dicts[k]["unsup_ndx"], ub,
                                      seed=ep + 20 + si * 10 + k * 100)
                         for si in range(spec.unsup_streams)]
            streams[k] = (sup, unsup)
            colour_gens[k] = torch.Generator(device=device).manual_seed(
                seed_colour_seed(base, epoch_i, k))

    def seed_dir(k):
        return os.path.join(ctx.checkpoint_dir, f"seed_{k}")

    start_epoch = 0
    if p.get("resume"):
        for k in mine:
            latest = ckpt.latest_checkpoint(seed_dir(k))
            if latest is not None:
                ckpt.restore_checkpoint(latest, states[k])
                print(f"Resumed seed {seeds[k]} from {latest}")
        at = gather_seed_rows({k: [states[k].step] for k in mine}, K, 1)[:, 0]
        if len(set(at.tolist())) != 1:
            raise RuntimeError(f"--resume requires every seed at the same step; got "
                               f"{[int(s) for s in at]}")
        start_epoch = int(at[0]) // max(p["iters_per_epoch"], 1)
        print(f"Resumed at epoch {start_epoch}")

    # spec.fetch reads engine.crop_hw only (aug_mt's host-side pair affine)
    shim = type("EngineShim", (), {"crop_hw": crop_hw})()

    def seed_batch(k):
        sup_stream, unsup = streams[k]
        raw = {"sup": next(sup_stream)}
        if use_cons:
            raw.update(spec.fetch(shim, unsup))
        raw = {name: common.to_device(v, device) for name, v in raw.items()}
        sup = augmentor.sup(raw["sup"])
        batch = {"sup_x": sup["image"], "sup_y": sup["labels"]}
        if use_cons:
            batch.update(spec.compose(augmentor, raw, colour_gens[k]))
        return batch

    print("Training...")
    epoch_mious = []
    try:
        for epoch_i in range(start_epoch, p["num_epochs"]):
            t1 = time.time()
            open_epoch_streams(epoch_i)
            ramp = sigmoid_rampup(epoch_i, p["rampup"]) if p["rampup"] > 0 else 1.0
            msum = {k: accum_zero_metrics(use_cons, device) for k in mine}
            for _ in range(p["iters_per_epoch"]):
                metrics = step_in_turn(steps, states, {k: seed_batch(k) for k in mine}, ramp)
                for k in mine:
                    msum[k] = {name: msum[k][name] + v for name, v in metrics[k].items()}
            # one fetch of the metric sums per epoch, every seed's on every rank
            n = max(p["iters_per_epoch"], 1)
            m = gather_seed_rows({k: [float(msum[k][name]) / n if name in msum[k] else 0.0
                                      for name in METRICS] for k in mine}, K, len(METRICS))
            if common.check_nan(float(m[:, 0].sum())):
                return states
            t2 = time.time()
            ious = {}
            for k in mine:
                eval_net = states[k].teacher if mean_teacher else states[k].student
                ious[k] = common.evaluate(
                    eval_net, ds, val_ndx, p["batch_size"], n_classes, mean, std,
                    model.block_size, device, p["bin_fill_holes"])
            ious = gather_seed_rows(ious, K, n_classes)
            epoch_mious = [float(iou.mean()) for iou in ious]
            for k in range(K):
                print("Epoch {} [seed {}]: took {:.3f}s, TRAIN clf loss={:.6f}, "
                      "consistency loss={:.6f}, conf rate={:.3%}, VAL mIoU={:.3%}"
                      .format(epoch_i + 1, seeds[k], t2 - t1, m[k, 0], m[k, 1], m[k, 2],
                              epoch_mious[k]))
                if lead:
                    ctx.log_metrics({"epoch": epoch_i + 1, "seed": seeds[k],
                                     "sup_loss": float(m[k, 0]),
                                     "val_miou": epoch_mious[k]})
            ci = max(1, int(p.get("checkpoint_interval", 1)))
            if (epoch_i + 1) % ci == 0 or epoch_i + 1 == p["num_epochs"]:
                for k in mine:
                    ckpt.save_checkpoint(seed_dir(k), states[k], states[k].step)
    finally:
        close_streams()

    # the paper-table aggregate: mean +/- std over the split seeds
    # (reference README.md reports 5-seed mean/stddev rows)
    arr = np.asarray(epoch_mious)
    if arr.size:
        # the sample std needs n > 1; a single seed reports 0 (a bare NaN
        # in the metrics JSONL breaks strict JSON parsers)
        std_miou = float(arr.std(ddof=1)) if arr.size > 1 else 0.0
        print("SEEDS AGGREGATE ({}): VAL mIoU mean={:.3%} std={:.3%} n={}"
              .format(",".join(str(s) for s in seeds), arr.mean(), std_miou, K))
        if lead:
            ctx.log_metrics({"final_seed_mious": epoch_mious,
                             "final_miou_mean": float(arr.mean()),
                             "final_miou_std": std_miou})
    return states


@click.command()
@common_options(with_geom_pair_opts=True)
@click.option("--algorithm", type=click.Choice(
    ["mask_mt", "ict", "vat_mt", "aug_mt"]), default="mask_mt",
    help="which consistency algorithm the sweep trains")
@click.option("--mask_mode", type=click.Choice(["zero", "mix"]), default="mix")
@click.option("--mask_prop_range", type=str, default="0.5")
@click.option("--boxmask_n_boxes", type=int, default=1)
@click.option("--boxmask_fixed_aspect_ratio", is_flag=True, default=False)
@click.option("--boxmask_by_size", is_flag=True, default=False)
@click.option("--boxmask_outside_bounds", is_flag=True, default=False)
@click.option("--boxmask_no_invert", is_flag=True, default=False)
@click.option("--ict_alpha", type=float, default=0.1)
@click.option("--vat_radius", type=float, default=0.5)
@click.option("--adaptive_vat_radius", is_flag=True, default=False)
@click.option("--vat_dir_from_student", is_flag=True, default=False)
@click.option("--parallel_split_seeds", type=str,
              default="12345,23456,34567,45678,56789",
              help="comma-separated split seeds trained in one run: in turn "
                   "on one GPU, split over the ranks of several")
def experiment(job_desc, **params):
    job.submit("train_seg_semisup_mask_mt_multiseed", job_desc,
               train_seg_semisup_mask_mt_multiseed, params)


if __name__ == "__main__":
    experiment()
