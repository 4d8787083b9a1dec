"""ICT (Interpolation Consistency Training) baseline trainer on one GPU
(port of cutmix_seg_tpu.train.ict):

    python -m cutmix_seg_tpu_torch.train.ict --dataset pascal --freeze_bn ...

Whole-image per-sample Beta(ict_alpha, ict_alpha) mixup consistency between
two draws from one unsupervised stream (reference:
train_seg_semisup_ict.py), with the JAX trainer's flags and epoch line. The
loop lives in ``train.engine``; the step is ``semisup.ict``. Options the
port does not run yet are refused at setup (``engine.check_ported``).
"""

from __future__ import annotations

import click

from cutmix_seg_tpu_torch.core import job
from cutmix_seg_tpu_torch.semisup.ict import ICTConfig, make_ict_step
from cutmix_seg_tpu_torch.train.cli_common import common_options
from cutmix_seg_tpu_torch.train.engine import (
    AlgorithmSpec,
    TrainEngine,
    compose_mask_pair,
    fetch_ict,
)


def build_spec(p):
    """(AlgorithmSpec, cfg) for these CLI params."""
    cfg = ICTConfig(
        ict_alpha=p["ict_alpha"],
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
        make_step=lambda model, opt, mesh=None: make_ict_step(model, opt, cfg, mesh),
        unsup_streams=1,
        pair_geom=False,
        fetch=fetch_ict,
        compose=compose_mask_pair,
    )
    return spec, cfg


def train_seg_semisup_ict(ctx: job.RunContext, device=None, **p):
    """Run the trainer on ``device`` (CUDA unless the caller passes
    ``device="cpu"``); returns the engine, whose state is the trained one."""
    spec, cfg = build_spec(p)
    engine = TrainEngine(ctx, spec, cfg, p, device=device)
    engine.run()
    return engine


@click.command()
@common_options()
@click.option("--ict_alpha", type=float, default=0.1)
def experiment(job_desc, **params):
    job.submit("train_seg_semisup_ict", job_desc, train_seg_semisup_ict, params)


if __name__ == "__main__":
    experiment()
