"""Mask-driven semi-supervised trainer (CutMix / Cutout mean-teacher), the
headline experiment, on one GPU (port of cutmix_seg_tpu.train.mask_mt):

    python -m cutmix_seg_tpu_torch.train.mask_mt --dataset pascal --freeze_bn ...

The same flags and printed epoch line as the JAX trainer (and the
reference, flags catalogued in CMDLINE_OPTIONS.md). The loop lives in
``train.engine``; the step is ``semisup.mask_mt``, whose CutMix blend is the
CUDA kernel ``csrc/cutmix_blend.cu``. Over several GPUs (``torchrun
--nproc_per_node=N``) it runs data-parallel, and with ``--spatial_train S``
each image's rows split over S ranks. The JAX trainer's refusals raise at
setup (``engine.check_ported``).
"""

from __future__ import annotations

import click

from cutmix_seg_tpu_torch.core import job
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig
from cutmix_seg_tpu_torch.semisup.mask_mt import MaskConsistencyConfig, make_mask_mt_step
from cutmix_seg_tpu_torch.train import common
from cutmix_seg_tpu_torch.train.cli_common import common_options
from cutmix_seg_tpu_torch.train.engine import (
    AlgorithmSpec,
    TrainEngine,
    compose_mask_pair,
    compose_mask_single,
    fetch_one_stream,
    fetch_two_streams,
)


def build_spec(p):
    """(AlgorithmSpec, cfg) for these CLI params."""
    if p["mask_mode"] not in ("mix", "zero"):
        raise ValueError(f"unknown mask_mode {p['mask_mode']}")
    mask_mix = p["mask_mode"] == "mix"
    cfg = MaskConsistencyConfig(
        mask_mode=p["mask_mode"],
        box=BoxMaskConfig(
            prop_range=common.parse_prop_range(p["mask_prop_range"]),
            n_boxes=p["boxmask_n_boxes"],
            random_aspect_ratio=not p["boxmask_fixed_aspect_ratio"],
            prop_by_area=not p["boxmask_by_size"],
            within_bounds=not p["boxmask_outside_bounds"],
            invert=not p["boxmask_no_invert"],
        ),
        cons_loss_fn=p["cons_loss_fn"],
        cons_weight=p["cons_weight"],
        conf_thresh=p["conf_thresh"],
        conf_per_pixel=p["conf_per_pixel"],
        freeze_bn=p["freeze_bn"],
        mean_teacher=p["model"] == "mean_teacher",
        teacher_alpha=p["teacher_alpha"],
        unsup_batch_ratio=p["unsup_batch_ratio"],
        grad_accum=p.get("grad_accum", 1),
        loss_softmax_dtype=p.get("loss_softmax_dtype", "float32"),
    )
    spec = AlgorithmSpec(
        make_step=lambda model, opt, mesh=None: make_mask_mt_step(model, opt, cfg, mesh),
        unsup_streams=2 if mask_mix else 1,
        pair_geom=False,
        fetch=fetch_two_streams if mask_mix else fetch_one_stream,
        compose=compose_mask_pair if mask_mix else compose_mask_single,
    )
    return spec, cfg


def train_seg_semisup_mask_mt(ctx: job.RunContext, device=None, **p):
    """Run the trainer on ``device`` (CUDA unless the caller passes
    ``device="cpu"``); returns the engine, whose state is the trained one."""
    spec, cfg = build_spec(p)
    engine = TrainEngine(ctx, spec, cfg, p, device=device)
    engine.run()
    return engine


@click.command()
@common_options()
@click.option("--mask_mode", type=click.Choice(["zero", "mix"]), default="mix")
@click.option("--mask_prop_range", type=str, default="0.5")
@click.option("--boxmask_n_boxes", type=int, default=1)
@click.option("--boxmask_fixed_aspect_ratio", is_flag=True, default=False)
@click.option("--boxmask_by_size", is_flag=True, default=False)
@click.option("--boxmask_outside_bounds", is_flag=True, default=False)
@click.option("--boxmask_no_invert", is_flag=True, default=False)
@click.option("--loss_softmax_dtype",
              type=click.Choice(["float32", "bfloat16"]), default="float32",
              help="dtype of the loss-side softmax chains (sup log-softmax, "
                   "consistency softmax/diff, confidence softmax-max); pixel "
                   "sums always accumulate f32. float32 = reference parity.")
def experiment(job_desc, **params):
    job.submit("train_seg_semisup_mask_mt", job_desc,
               train_seg_semisup_mask_mt, params)


if __name__ == "__main__":
    experiment()
