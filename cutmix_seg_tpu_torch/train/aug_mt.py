"""Augmentation-driven consistency trainer on one GPU (port of
cutmix_seg_tpu.train.aug_mt):

    python -m cutmix_seg_tpu_torch.train.aug_mt --dataset pascal --freeze_bn ...

Each unsupervised image is cropped twice with different geometry (pair
mode: ``--aug_offset_range`` keeps the crops overlapping,
``--aug_free_scale_rot`` unconstrains the pair's rotation and scale); the
teacher's prediction on crop 0 is warped into crop 1's frame for the
consistency loss (reference: train_seg_semisup_aug_mt.py), with the JAX
trainer's flags and epoch line. The loop lives in ``train.engine``; the step
is ``semisup.aug_cons``. Options the port does not run yet are refused at
setup (``engine.check_ported``).
"""

from __future__ import annotations

import click

from cutmix_seg_tpu_torch.core import job
from cutmix_seg_tpu_torch.semisup.aug_cons import AugConsConfig, make_aug_cons_step
from cutmix_seg_tpu_torch.train.cli_common import common_options
from cutmix_seg_tpu_torch.train.engine import (
    AlgorithmSpec,
    TrainEngine,
    compose_aug_pair,
    fetch_aug_pair,
)


def build_spec(p):
    """(AlgorithmSpec, cfg) for these CLI params."""
    cfg = AugConsConfig(
        cons_loss_fn=p["cons_loss_fn"],
        cons_weight=p["cons_weight"],
        conf_thresh=p["conf_thresh"],
        conf_per_pixel=p["conf_per_pixel"],
        freeze_bn=p["freeze_bn"],
        mean_teacher=p["model"] == "mean_teacher",
        teacher_alpha=p["teacher_alpha"],
        unsup_batch_ratio=p["unsup_batch_ratio"],
        grad_accum=p.get("grad_accum", 1),
    )
    spec = AlgorithmSpec(
        make_step=lambda model, opt, mesh=None: make_aug_cons_step(model, opt, cfg, mesh),
        unsup_streams=1,
        pair_geom=True,
        fetch=fetch_aug_pair,
        compose=compose_aug_pair,
    )
    return spec, cfg


def train_seg_semisup_aug_mt(ctx: job.RunContext, device=None, **p):
    """Run the trainer on ``device`` (CUDA unless the caller passes
    ``device="cpu"``); returns the engine, whose state is the trained one."""
    spec, cfg = build_spec(p)
    engine = TrainEngine(ctx, spec, cfg, p, device=device)
    engine.run()
    return engine


@click.command()
@common_options(with_geom_pair_opts=True)
def experiment(job_desc, **params):
    job.submit("train_seg_semisup_aug_mt", job_desc,
               train_seg_semisup_aug_mt, params)


if __name__ == "__main__":
    experiment()
