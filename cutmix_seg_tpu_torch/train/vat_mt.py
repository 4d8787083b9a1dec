"""VAT (Virtual Adversarial Training) baseline trainer on one GPU (port of
cutmix_seg_tpu.train.vat_mt):

    python -m cutmix_seg_tpu_torch.train.vat_mt --dataset pascal --freeze_bn ...

A one-step power-iteration adversarial perturbation of the student's input,
with a fixed or adaptive (image-Jacobian) radius and the direction from the
teacher or the student (reference: train_seg_semisup_vat_mt.py), with the
JAX trainer's flags and epoch line. The loop lives in ``train.engine``; the
step is ``semisup.vat``. Options the port does not run yet are refused at
setup (``engine.check_ported``).
"""

from __future__ import annotations

import click

from cutmix_seg_tpu_torch.core import job
from cutmix_seg_tpu_torch.semisup.vat import VATConfig, make_vat_step
from cutmix_seg_tpu_torch.train.cli_common import common_options
from cutmix_seg_tpu_torch.train.engine import (
    AlgorithmSpec,
    TrainEngine,
    compose_mask_single,
    fetch_one_stream,
)


def build_spec(p):
    """(AlgorithmSpec, cfg) for these CLI params."""
    cfg = VATConfig(
        vat_radius=p["vat_radius"],
        adaptive_vat_radius=p["adaptive_vat_radius"],
        vat_dir_from_student=p["vat_dir_from_student"],
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
        make_step=lambda model, opt, mesh=None: make_vat_step(model, opt, cfg, mesh),
        unsup_streams=1,
        pair_geom=False,
        fetch=fetch_one_stream,
        compose=compose_mask_single,
    )
    return spec, cfg


def train_seg_semisup_vat_mt(ctx: job.RunContext, device=None, **p):
    """Run the trainer on ``device`` (CUDA unless the caller passes
    ``device="cpu"``); returns the engine, whose state is the trained one."""
    spec, cfg = build_spec(p)
    engine = TrainEngine(ctx, spec, cfg, p, device=device)
    engine.run()
    return engine


@click.command()
@common_options()
@click.option("--vat_radius", type=float, default=0.5)
@click.option("--adaptive_vat_radius", is_flag=True, default=False)
@click.option("--vat_dir_from_student", is_flag=True, default=False)
def experiment(job_desc, **params):
    job.submit("train_seg_semisup_vat_mt", job_desc,
               train_seg_semisup_vat_mt, params)


if __name__ == "__main__":
    experiment()
