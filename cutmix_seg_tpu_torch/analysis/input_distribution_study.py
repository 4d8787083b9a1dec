"""Input-distribution / cluster-assumption study (port of
cutmix_seg_tpu.analysis.input_distribution_study):

    python -m cutmix_seg_tpu_torch.analysis.input_distribution_study OUT_DIR \
        [--dataset cityscapes] [--patch_size 15] [--device cpu]

For sample images, the ground-truth class-boundary pixels and the average
patch distance between neighbouring pixels, showing that patch distance
does NOT rise at class boundaries: the cluster assumption fails in input
space for segmentation (the paper's Figure-1 argument). The statistic is the
mean neighbour-patch distance at boundary pixels over that at the other
labelled pixels, per image (``boundary_ratio``). The distance maps run on
the GPU unless given ``--device cpu``; the figures need matplotlib.
"""

from __future__ import annotations

import os

import click
import numpy as np

from cutmix_seg_tpu_torch.analysis import patch_dist
from cutmix_seg_tpu_torch.data import datasets


def pick_images(ds, n_images, seed):
    """The training indices the study draws."""
    rng = np.random.RandomState(seed)
    return rng.choice(ds.train_ndx, size=min(n_images, len(ds.train_ndx)), replace=False)


def image_stats(ds, idx, patch_size, device):
    """(image in [0, 1], boundary map, average neighbour-patch distance map
    as float32 numpy, boundary / non-boundary ratio of its means) of one
    image; the ratio is NaN where either set is empty."""
    img = ds.get_image(int(idx)).astype(np.float64) / 255.0
    y = ds.get_labels(int(idx))
    boundary = patch_dist.boundary_pixels(y)
    avg_d = patch_dist.patch_average_distance_map(
        img, (patch_size, patch_size), device).cpu().numpy()
    b_mean = avg_d[boundary].mean() if boundary.any() else np.nan
    nb = (~boundary) & (y != 255)
    nb_mean = avg_d[nb].mean() if nb.any() else np.nan
    return img, boundary, avg_d, b_mean / nb_mean


def boundary_ratios(ds, picks, patch_size, device) -> np.ndarray:
    """The boundary / non-boundary ratio of each picked image."""
    return np.asarray([image_stats(ds, idx, patch_size, device)[3] for idx in picks])


@click.command()
@click.argument("out_dir", type=click.Path())
@click.option("--dataset", type=click.Choice(
    ["camvid", "cityscapes", "pascal", "pascal_aug", "isic2017"]),
    default="cityscapes")
@click.option("--patch_size", type=int, default=15)
@click.option("--n_images", type=int, default=8)
@click.option("--seed", type=int, default=12345)
@click.option("--device", default=None, help="torch device; the GPU unless 'cpu'")
def main(out_dir, dataset, patch_size, n_images, seed, device):
    from cutmix_seg_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    ds = datasets.load_dataset(dataset, n_val=0, val_seed=0, n_sup=-1,
                               n_unsup=-1, split_seed=12345,
                               split_path=None)["ds_src"]
    ratios = []
    for k, idx in enumerate(pick_images(ds, n_images, seed)):
        img, boundary, avg_d, ratio = image_stats(ds, idx, patch_size, dev)
        ratios.append(ratio)

        fig, axes = plt.subplots(1, 3, figsize=(15, 4.5))
        axes[0].imshow(img)
        axes[0].set_title("image")
        axes[1].imshow(boundary, cmap="gray")
        axes[1].set_title("class boundaries")
        im = axes[2].imshow(avg_d, cmap="viridis")
        axes[2].set_title(
            f"avg neighbour patch distance ({patch_size}x{patch_size})")
        fig.colorbar(im, ax=axes[2], fraction=0.046)
        for ax in axes:
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"input_dist_{k:02d}.png"), dpi=110)
        plt.close(fig)

    ratios = np.asarray(ratios)
    print(f"boundary / non-boundary mean patch-distance ratio over "
          f"{len(ratios)} images: median={np.nanmedian(ratios):.3f} "
          f"mean={np.nanmean(ratios):.3f}")
    print("A ratio near (or below) 1 shows patch distance does not spike at "
          "class boundaries: low-density separation does not hold in input "
          "space.")
    print(f"Wrote {len(ratios)} figures to {out_dir}")


if __name__ == "__main__":
    main()
