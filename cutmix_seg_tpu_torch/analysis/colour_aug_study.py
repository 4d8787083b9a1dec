"""Colour-augmentation study (port of cutmix_seg_tpu.analysis.colour_aug_study):

    python -m cutmix_seg_tpu_torch.analysis.colour_aug_study OUT_DIR \
        [--dataset pascal_aug] [--n_variants 6] [--device cpu]

What the strong colour augmentation does to images and to the input
distribution: a grid of jittered variants of sample images, and per channel
value histograms before and after. It runs the trainers' own colour
pipeline (``ops.colour``, every jitter applied, greyscale with p 0.2), so
what it shows is what the student trains on. The draws come from a
``torch.Generator`` seeded with ``--seed``. The jitter runs on the GPU
unless given ``--device cpu``; the figures need matplotlib.
"""

from __future__ import annotations

import os

import click
import numpy as np
import torch

from cutmix_seg_tpu_torch.data import datasets
from cutmix_seg_tpu_torch.ops.colour import (
    ColourJitterConfig,
    apply_colour_jitter,
    sample_colour_params,
)

BINS = 50


def study_config(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1):
    return ColourJitterConfig(brightness=brightness, contrast=contrast,
                              saturation=saturation, hue=hue,
                              apply_prob=1.0, greyscale_prob=0.2)


def load_originals(ds, n_images, seed):
    """``n_images`` training images drawn with ``seed``, in [0, 1] float32,
    cut to multiples of 8 on each side."""
    picks = np.random.RandomState(seed).choice(ds.train_ndx, size=n_images, replace=False)
    out = []
    for idx in picks:
        img = ds.get_image(int(idx)).astype(np.float32) / 255.0
        out.append(img[:(img.shape[0] // 8) * 8, :(img.shape[1] // 8) * 8])
    return out


def jittered_variants(originals, n_variants, cfg, generator, params=None):
    """``n_variants`` jittered copies of each image (float32 numpy, image
    by image), drawn from ``generator`` on its device, or from
    ``params[r]``, the ColourParams of image r's variants."""
    out = []
    for r, img in enumerate(originals):
        x = torch.from_numpy(img).to(generator.device)[None].expand(n_variants, -1, -1, -1)
        p = params[r] if params is not None else sample_colour_params(generator, n_variants, cfg)
        out.extend(apply_colour_jitter(x, p).cpu().numpy())
    return out


def channel_histograms(originals, augmented, bins=BINS):
    """Per channel (R, G, B): the density histograms (counts, edges) of the
    original and of the augmented pixel values, as the figure bins them."""
    orig_px = np.concatenate([o.reshape(-1, 3) for o in originals])
    aug_px = np.concatenate([a.reshape(-1, 3) for a in augmented])
    return {name: (np.histogram(orig_px[:, c], bins=bins, density=True),
                   np.histogram(aug_px[:, c], bins=bins, density=True))
            for c, name in enumerate("RGB")}


@click.command()
@click.argument("out_dir", type=click.Path())
@click.option("--dataset", type=click.Choice(
    ["camvid", "cityscapes", "pascal", "pascal_aug", "isic2017"]),
    default="pascal_aug")
@click.option("--n_images", type=int, default=4)
@click.option("--n_variants", type=int, default=6)
@click.option("--brightness", type=float, default=0.4)
@click.option("--contrast", type=float, default=0.4)
@click.option("--saturation", type=float, default=0.4)
@click.option("--hue", type=float, default=0.1)
@click.option("--seed", type=int, default=0)
@click.option("--device", default=None, help="torch device; the GPU unless 'cpu'")
def main(out_dir, dataset, n_images, n_variants, brightness, contrast,
         saturation, hue, seed, device):
    from cutmix_seg_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    ds = datasets.load_dataset(dataset, n_val=-1, val_seed=131, n_sup=-1,
                               n_unsup=-1, split_seed=12345,
                               split_path=None)["ds_src"]
    cfg = study_config(brightness, contrast, saturation, hue)
    originals = load_originals(ds, n_images, seed)
    augmented = jittered_variants(originals, n_variants, cfg,
                                  torch.Generator(device=dev).manual_seed(seed))

    fig, axes = plt.subplots(n_images, n_variants + 1,
                             figsize=(2.2 * (n_variants + 1), 2.2 * n_images),
                             squeeze=False)
    for r, img in enumerate(originals):
        axes[r, 0].imshow(img)
        axes[r, 0].set_title("original" if r == 0 else "")
        axes[r, 0].axis("off")
        for v in range(n_variants):
            axes[r, v + 1].imshow(augmented[r * n_variants + v])
            axes[r, v + 1].axis("off")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "colour_aug_grid.png"), dpi=120)
    plt.close(fig)

    # channel histograms before/after
    fig, axes = plt.subplots(1, 3, figsize=(12, 3))
    hists = channel_histograms(originals, augmented)
    for c, name in enumerate("RGB"):
        for (counts, edges), label in zip(hists[name], ("original", "augmented")):
            axes[c].stairs(counts, edges, fill=True, alpha=0.5, label=label)
        axes[c].set_title(name)
        axes[c].legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "colour_aug_histograms.png"), dpi=120)
    print(f"Wrote colour_aug_grid.png and colour_aug_histograms.png to {out_dir}")


if __name__ == "__main__":
    main()
