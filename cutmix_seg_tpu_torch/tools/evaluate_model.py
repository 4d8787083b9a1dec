"""Standalone model evaluation: saved weights -> per-class IoU / mIoU (port
of cutmix_seg_tpu.tools.evaluate_model).

Evaluates a trained network (the trainer's final ``model.pt`` from
``--save_model``, or the student or teacher of a checkpoint from
``checkpoints/``) on a dataset's val or test split with the trainers' own
eval pass (``train.common.evaluate``: integer confusion matrices, the
reference's IoU, 2-class hole filling), on the GPU unless given
``--device cpu``. Under torchrun the ranks split each eval batch as the
trainers do; ``--eval_spatial`` over several ranks splits rows too, on
every architecture, as in the trainers.

    python -m cutmix_seg_tpu_torch.tools.evaluate_model \
        --dataset pascal_aug --arch resnet101_deeplab_imagenet \
        --model_path results/train_seg_semisup_mask_mt/run/model.pt

    python -m cutmix_seg_tpu_torch.tools.evaluate_model ... \
        --checkpoint results/.../checkpoints --net teacher --split test
"""

from __future__ import annotations

import os

import click
import torch

from cutmix_seg_tpu_torch.core import checkpoint as ckpt
from cutmix_seg_tpu_torch.data import datasets
from cutmix_seg_tpu_torch.parallel import mesh as mesh_mod
from cutmix_seg_tpu_torch.train import common
from cutmix_seg_tpu_torch.train.engine import check_ported
from cutmix_seg_tpu_torch.utils.device import resolve_device


def load_net_weights(model_path, checkpoint, net):
    """(state_dict, description) of a ``model.pt`` or of the ``net``
    ("student" / "teacher") of a checkpoint file or the newest one in a
    ``checkpoints/`` directory."""
    if model_path is not None:
        return torch.load(model_path, map_location="cpu", weights_only=True), model_path
    path = ckpt.latest_checkpoint(checkpoint) if os.path.isdir(checkpoint) else checkpoint
    if path is None:
        raise click.UsageError(f"no checkpoints under {checkpoint!r}")
    sd = torch.load(path, map_location="cpu", weights_only=True)[net]
    if sd is None:
        raise click.UsageError(
            f"checkpoint {path!r} has no {net} network (pi-model runs "
            "keep no separate teacher; use --net student)")
    return sd, f"{path} ({net})"


@click.command()
@click.option("--dataset", type=str, required=True)
@click.option("--arch", type=str, required=True)
@click.option("--model_path", type=str, default=None,
              help="model.pt from --save_model (the eval net's state_dict)")
@click.option("--checkpoint", type=str, default=None,
              help="checkpoint file or checkpoints/ dir (full train state)")
@click.option("--net", type=click.Choice(["teacher", "student"]),
              default="teacher",
              help="which network to evaluate from a full checkpoint")
@click.option("--split", type=click.Choice(["val", "test"]), default="val")
@click.option("--batch_size", type=int, default=8)
@click.option("--n_val", type=int, default=-1)
@click.option("--val_seed", type=int, default=131)
@click.option("--split_seed", type=int, default=12345)
@click.option("--split_path", type=str, default=None)
@click.option("--bin_fill_holes", is_flag=True, default=False)
@click.option("--eval_spatial", is_flag=True, default=False)
@click.option("--compute_dtype", type=str, default="bfloat16")
@click.option("--n_devices", type=int, default=-1)
@click.option("--device", type=str, default="cuda",
              help="cuda (under torchrun: this rank's card), or cpu")
def main(dataset, arch, model_path, checkpoint, net, split, batch_size,
         n_val, val_seed, split_seed, split_path, bin_fill_holes,
         eval_spatial, compute_dtype, n_devices, device):
    """Prints the mIoU and the per-class IoU; returns the per-class IoU."""
    if (model_path is None) == (checkpoint is None):
        raise click.UsageError("pass exactly one of --model_path / --checkpoint")
    dev = resolve_device(None if device == "cuda" else device)
    mesh_mod.maybe_initialize_distributed(dev)
    # the trainers' refusals at this world size, before the data loads
    check_ported({"arch": arch, "crop_size": "", "n_devices": n_devices,
                  "eval_spatial": eval_spatial})
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True  # as the trainers evaluate

    ds_dict = datasets.load_dataset(dataset, n_val, val_seed, n_sup=-1, n_unsup=-1,
                                    split_seed=split_seed, split_path=split_path)
    ds = ds_dict["ds_src"]
    ndx = ds_dict["test_ndx_tgt"] if split == "test" else ds_dict["val_ndx_tgt"]
    if ndx is None:
        raise click.UsageError(f"dataset {dataset!r} has no {split} split")

    model = common.build_model(arch, ds.num_classes, compute_dtype, pretrained=False)
    sd, src = load_net_weights(model_path, checkpoint, net)
    module = model.module
    module.load_state_dict(sd)
    module.to(dev, memory_format=torch.channels_last)
    mean, std = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                 for v in common.resolve_mean_std(model, ds))

    mesh = mesh_mod.data_mesh()
    lead = mesh_mod.is_lead()
    if lead:
        print(f"Evaluating {src} on {dataset}/{split} ({len(ndx)} images, "
              f"{mesh_mod.world()} devices{', spatial' if eval_spatial else ''})")
    iou = common.evaluate(module, ds, ndx, batch_size, ds.num_classes, mean, std,
                          model.block_size, dev, bin_fill_holes, mesh, spatial=eval_spatial)
    if lead:
        print("{} mIoU={:.3%}".format(split.upper(), iou.mean()))
        print("-- {}".format(", ".join(f"{x:.3%}" for x in iou)))
    return iou


if __name__ == "__main__":
    main()
