"""Shared click options of the trainers: a copy of
cutmix_seg_tpu.train.cli_common, so the port's CLI has exactly the JAX
CLI's flags and defaults (the reference's surface, catalogued in
CMDLINE_OPTIONS.md, plus the JAX package's extras). Help texts say what the
port does with each extra; the values the port does not run yet are
refused at setup (train/engine.py)."""

from __future__ import annotations

import click


def common_options(with_geom_pair_opts: bool = False):
    opts = [
        click.option("--job_desc", type=str, default=""),
        click.option("--dataset", type=click.Choice(
            ["camvid", "cityscapes", "pascal", "pascal_aug", "isic2017"]),
            default="pascal_aug"),
        click.option("--model", type=click.Choice(["mean_teacher", "pi"]),
                     default="mean_teacher"),
        click.option("--arch", type=str, default="resnet101_deeplab_imagenet"),
        click.option("--freeze_bn", is_flag=True, default=False),
        click.option("--opt_type", type=click.Choice(["adam", "sgd"]),
                     default="adam"),
        click.option("--sgd_momentum", type=float, default=0.9),
        click.option("--sgd_nesterov", is_flag=True, default=False),
        click.option("--sgd_weight_decay", type=float, default=5e-4),
        click.option("--learning_rate", type=float, default=1e-4),
        click.option("--lr_sched", type=click.Choice(
            ["none", "stepped", "cosine", "poly"]), default="none"),
        click.option("--lr_step_epochs", type=str, default=""),
        click.option("--lr_step_gamma", type=float, default=0.1),
        click.option("--lr_poly_power", type=float, default=0.9),
        click.option("--teacher_alpha", type=float, default=0.99),
        click.option("--bin_fill_holes", is_flag=True, default=False),
        click.option("--crop_size", type=str, default="321,321"),
        click.option("--aug_hflip", is_flag=True, default=False),
        click.option("--aug_vflip", is_flag=True, default=False),
        click.option("--aug_hvflip", is_flag=True, default=False),
        click.option("--aug_scale_hung", is_flag=True, default=False),
        click.option("--aug_max_scale", type=float, default=1.0),
        click.option("--aug_scale_non_uniform", is_flag=True, default=False),
        click.option("--aug_rot_mag", type=float, default=0.0),
        click.option("--aug_strong_colour", is_flag=True, default=False),
        click.option("--aug_colour_brightness", type=float, default=0.4),
        click.option("--aug_colour_contrast", type=float, default=0.4),
        click.option("--aug_colour_saturation", type=float, default=0.4),
        click.option("--aug_colour_hue", type=float, default=0.1),
        click.option("--aug_colour_prob", type=float, default=0.8),
        click.option("--aug_colour_greyscale_prob", type=float, default=0.2),
        click.option("--cons_loss_fn", type=click.Choice(
            ["var", "bce", "kld", "logits_var", "logits_smoothl1"]),
            default="var"),
        click.option("--cons_weight", type=float, default=1.0),
        click.option("--conf_thresh", type=float, default=0.97),
        click.option("--conf_per_pixel", is_flag=True, default=False),
        click.option("--rampup", type=int, default=-1),
        click.option("--unsup_batch_ratio", type=int, default=1),
        click.option("--num_epochs", type=int, default=300),
        click.option("--iters_per_epoch", type=int, default=-1),
        click.option("--batch_size", type=int, default=10),
        click.option("--n_sup", type=int, default=100),
        click.option("--n_unsup", type=int, default=-1),
        click.option("--n_val", type=int, default=-1),
        click.option("--split_seed", type=int, default=12345),
        click.option("--split_path", type=click.Path(readable=True, exists=True)),
        click.option("--val_seed", type=int, default=131),
        click.option("--save_preds", is_flag=True, default=False),
        click.option("--save_model", is_flag=True, default=False),
        click.option("--num_workers", type=int, default=4),
        # extras of the JAX package
        click.option("--compute_dtype", type=click.Choice(
            ["bfloat16", "float32"]), default="bfloat16"),
        click.option("--n_devices", type=int, default=-1,
                     help="JAX-package extra: the data-parallel width; -1 is "
                          "every process of the run (one GPU each, torchrun "
                          "--nproc_per_node=N), any other value must equal it"),
        click.option("--resume", is_flag=True, default=False),
        click.option("--nan_check_interval", type=int, default=100),
        click.option("--checkpoint_interval", type=int, default=1,
                     help="save a resume checkpoint every N epochs (the "
                          "final epoch always saves). The full train state "
                          "is hundreds of MB for R101-scale models; on "
                          "short-epoch runs a per-epoch save can dominate "
                          "wall-clock — raise N to amortise it"),
        click.option("--seed", type=int, default=0),
        click.option("--profile_dir", type=click.Path(), default=None,
                     help="capture a torch.profiler trace of a few first-epoch "
                          "steps into this directory"),
        click.option("--eval_spatial", is_flag=True, default=False,
                     help="JAX-package extra: eval with the image H axis "
                          "split over the ranks (over the --spatial_train "
                          "ranks when set); with one process the plain "
                          "eval"),
        click.option("--spatial_train", type=int, default=1,
                     help="JAX-package extra: split each crop's H axis over "
                          "N ranks in training (batch over the world / N "
                          "others); crop height and world must divide by N"),
        click.option("--data_on_device", type=click.Choice(
            ["auto", "on", "off"]), default="auto",
            help="JAX-package extra: keep the training canvases in device "
                 "memory and ship only indices and matrices each iteration. "
                 "'on' stages them, 'off' streams them from the host, 'auto' "
                 "stages them when they fit in 1 GiB (the same samples and "
                 "geometry either way)"),
        click.option("--no_pretrained", is_flag=True, default=False,
                     help="skip loading pretrained backbone weights (random "
                          "init; for machines without the weight files)"),
        click.option("--grad_accum", type=int, default=1,
                     help="JAX-package extra: the batch as K sequential "
                          "strided micro-chunks, one optimiser/EMA update "
                          "(lower peak activation memory; with training BN "
                          "the statistics update per chunk)"),
    ]
    if with_geom_pair_opts:
        opts += [
            click.option("--aug_offset_range", type=float, default=16.0),
            click.option("--aug_free_scale_rot", is_flag=True, default=False),
        ]

    def deco(fn):
        for opt in reversed(opts):
            fn = opt(fn)
        return fn

    return deco
