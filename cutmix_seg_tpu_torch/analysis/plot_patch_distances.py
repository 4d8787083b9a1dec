"""Plot inter-class against intra-class patch distances (port of
cutmix_seg_tpu.analysis.plot_patch_distances), from the pickles that
``analysis.intra_inter_class_patch_dist`` writes:

    python -m cutmix_seg_tpu_torch.analysis.plot_patch_distances 'OUT*.pkl' FIG.png

For each anchor patch, the distance to its negative neighbour just across
the class boundary against the nearest intra-class and inter-class patch
distances: the paper's Figure-1/2 evidence that the cluster assumption does
NOT hold in input space for segmentation. Host NumPy only; the figure needs
matplotlib.
"""

from __future__ import annotations

import glob
import pickle

import click
import numpy as np


def load_results(paths):
    merged = None
    for path in paths:
        with open(path, "rb") as f:
            res = pickle.load(f)
        if merged is None:
            merged = {k: list(v) if isinstance(v, list) else [v]
                      for k, v in res.items()}
        else:
            for k, v in res.items():
                if isinstance(v, list):
                    merged[k].extend(v)
                else:
                    merged[k].append(v)
    for k in ("boundary_dists", "anchor_negative_img_dir_y_x_cls"):
        if k in merged:
            merged[k] = np.concatenate(merged[k], axis=0)
    return merged


def k_mean(dist_lists, k_nearest):
    """Per anchor, the mean of its ``k_nearest`` smallest distances (NaN
    where it has none)."""
    return np.array([
        d[:k_nearest].mean() if d is not None and len(d) else np.nan
        for d in dist_lists
    ])


def distance_summary(res, k_nearest):
    """The figure's series: the k-nearest means of the four neighbour sets,
    the across-boundary distances, and the fraction of anchors whose
    across-boundary neighbour is farther than the mean of its k nearest
    intra-class patches of the same image."""
    out = {name: k_mean(res[f"{name}_class_dists"], k_nearest)
           for name in ("same_image_intra", "same_image_inter",
                        "other_image_intra", "other_image_inter")}
    out["boundary"] = res["boundary_dists"]
    out["frac_boundary_farther"] = float(np.nanmean(out["boundary"] > out["same_image_intra"]))
    return out


@click.command()
@click.argument("result_glob", type=str)
@click.argument("out_path", type=click.Path())
@click.option("--k_nearest", type=int, default=10,
              help="use the mean of the k nearest neighbours per anchor")
def main(result_glob, out_path, k_nearest):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    paths = sorted(glob.glob(result_glob))
    if not paths:
        raise SystemExit(f"no result files match {result_glob}")
    summary = distance_summary(load_results(paths), k_nearest)
    intra_same, inter_same = summary["same_image_intra"], summary["same_image_inter"]
    intra_other, inter_other = summary["other_image_intra"], summary["other_image_inter"]
    boundary = summary["boundary"]

    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    bins = 50
    axes[0].hist(intra_same, bins=bins, alpha=0.5, label="intra-class (same image)")
    axes[0].hist(inter_same, bins=bins, alpha=0.5, label="inter-class (same image)")
    axes[0].hist(boundary, bins=bins, alpha=0.5,
                 label="across-boundary neighbour")
    axes[0].set_xlabel("patch distance")
    axes[0].set_title("Same image")
    axes[0].legend()
    axes[1].hist(intra_other, bins=bins, alpha=0.5, label="intra-class (other images)")
    axes[1].hist(inter_other, bins=bins, alpha=0.5, label="inter-class (other images)")
    axes[1].set_xlabel("patch distance")
    axes[1].set_title("Other images")
    axes[1].legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)

    def s(x):
        x = x[np.isfinite(x)]
        return f"median={np.median(x):.4f} mean={x.mean():.4f}"

    print(f"across-boundary: {s(boundary)}")
    print(f"intra same-image: {s(intra_same)}   inter same-image: {s(inter_same)}")
    print(f"intra other-image: {s(intra_other)}   inter other-image: {s(inter_other)}")
    print(f"fraction of anchors whose across-boundary neighbour is farther "
          f"than the mean of its {k_nearest} nearest intra-class patches: "
          f"{summary['frac_boundary_farther']:.3f}")
    print(f"Wrote {out_path}")


if __name__ == "__main__":
    main()
