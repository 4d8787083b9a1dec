"""Export a trained model as a self-contained serving artifact (port of
cutmix_seg_tpu.tools.export_model).

A ``torch.export`` program of ``uint8 image -> labels`` (serve/export.py):
weights inside, symbolic batch dimension, static H, W, run on the device it
was exported on (``--device``, CUDA by default), loadable with torch alone.

Typical use, after a run with ``--save_model``::

    python -m cutmix_seg_tpu_torch.tools.export_model \
        --arch resnet101_deeplab_imagenet --num_classes 21 \
        --params results/<job>/<desc>/model.pt \
        --hw 321,321 --out model_321.pt2
"""

from __future__ import annotations

import os

import click
import torch

from cutmix_seg_tpu_torch.models import registry
from cutmix_seg_tpu_torch.models.common import init_weights
from cutmix_seg_tpu_torch.serve.export import export_serving_artifact
from cutmix_seg_tpu_torch.utils.device import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def build_net(arch: str, num_classes: int, params_path, dtype: str):
    """The SegModel of ``arch`` with the weights of ``params_path`` (a
    ``model.pt`` from ``core.checkpoint.export_params``), or freshly
    initialised from seed 0 without one."""
    model = registry.get(arch)(num_classes, dtype=DTYPES[dtype], pretrained=False)
    if params_path is None:
        init_weights(model.module, torch.Generator().manual_seed(0))
    else:
        model.module.load_state_dict(torch.load(params_path, map_location="cpu",
                                                weights_only=True))
    return model


@click.command()
@click.option("--arch", type=str, required=True,
              help="architecture registry name (same values as --arch in the trainers)")
@click.option("--num_classes", type=int, required=True)
@click.option("--params", "params_path", type=click.Path(exists=True, dir_okay=False),
              default=None, help="model.pt from a --save_model run "
              "(core.checkpoint.export_params); omitted = fresh init (smoke use)")
@click.option("--hw", type=str, default="321,321",
              help="served input resolution H,W (static; batch is symbolic)")
@click.option("--out", "out_path", type=click.Path(dir_okay=False), required=True)
@click.option("--output", type=click.Choice(["argmax", "logits"]), default="argmax")
@click.option("--device", type=str, default="cuda",
              help="the device the artifact runs on (cuda, or cpu)")
@click.option("--dtype", type=click.Choice(["bfloat16", "float32"]),
              default="bfloat16", help="compute dtype of the exported forward")
def main(arch, num_classes, params_path, hw, out_path, output, device, dtype):
    dev = resolve_device(device)
    h, w = (int(v) for v in hw.split(","))
    model = build_net(arch, num_classes, params_path, dtype)
    if params_path is None:
        click.echo("export_model: no --params given; exporting FRESH weights", err=True)
    path = export_serving_artifact(model, (h, w), out_path, output=output, device=dev,
                                   num_classes=num_classes)
    size = round(os.path.getsize(path) / 1e6, 1)
    click.echo(f"export_model: wrote {path} ({size} MB) + {path}.json")


if __name__ == "__main__":
    main()
