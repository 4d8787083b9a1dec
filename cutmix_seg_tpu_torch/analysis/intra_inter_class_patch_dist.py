"""Intra/inter-class patch-distance study (the paper's Figures 1/2; port of
cutmix_seg_tpu.analysis.intra_inter_class_patch_dist):

    python -m cutmix_seg_tpu_torch.analysis.intra_inter_class_patch_dist \
        OUT.pkl [--dataset cityscapes] [--n_patches 1000] [--device cpu]

Chooses anchor patches centred on class-boundary pixels with negatives just
across the boundary, then for every training image ranks all same-size
windows by distance to each anchor, keeping the nearest intra-class and
inter-class neighbours; writes the JAX tool's pickle. The device computes
the distance maps (``analysis.patch_dist``); the ranking stays a host NumPy
``argsort``, so ties break as they do in the JAX tool. Runs on the GPU
unless given ``--device cpu``.
"""

from __future__ import annotations

import pickle

import click
import numpy as np

from cutmix_seg_tpu_torch.analysis import patch_dist
from cutmix_seg_tpu_torch.data import datasets

NEIGHBOUR_OFFSETS = np.array([[0, -1], [0, 1], [-1, 0], [1, 0]])


def choose_anchors_and_negatives(ds, sample_indices, n_patches, patch_hw, rng,
                                 progress=lambda x: x):
    """(N, [img_i, dir_i, y, x, cls]) anchor choices on class boundaries."""
    patch_hw = np.asarray(patch_hw)
    border = (patch_hw - 1) // 2 + 1

    rows = []
    for img_i in progress(sample_indices):
        y = ds.get_labels(int(img_i))
        for dir_i, chg in enumerate(patch_dist.neighbouring_pixels_class_change(y)):
            i, j = np.where(chg)
            ok = ((i > border[0]) & (i < y.shape[0] - border[0])
                  & (j > border[1]) & (j < y.shape[1] - border[1]))
            i, j = i[ok], j[ok]
            rows.append(np.stack([np.full_like(i, img_i),
                                  np.full_like(i, dir_i), i, j, y[i, j]], axis=1))
    rows = np.concatenate(rows, axis=0)
    choice = rng.permutation(len(rows))[:n_patches]
    return rows[choice]


def extract_anchor_and_negative_patches(ds, ids, patch_hw,
                                        progress=lambda x: x):
    anchors, negatives = [], []
    for row in progress(ids):
        q_ij = row[2:4]
        q_n_ij = q_ij + NEIGHBOUR_OFFSETS[row[1]]
        y = ds.get_labels(int(row[0]))
        if y[q_ij[0], q_ij[1]] != row[4] or y[q_n_ij[0], q_n_ij[1]] == row[4]:
            raise ValueError(f"anchor row {row} does not lie on a class boundary of "
                             f"image {row[0]}")
        x = ds.get_image(int(row[0])).astype(np.float64) / 255.0
        anchors.append(patch_dist.extract_patch(x, patch_hw, q_ij))
        negatives.append(patch_dist.extract_patch(x, patch_hw, q_n_ij))
    return np.stack(anchors), np.stack(negatives)


def class_distances(ds, ids, anchor_patches, n_neighbours, device,
                    progress=lambda x: x):
    """For each anchor, the nearest intra- and inter-class windows of its own
    image and of the other training images (distances and (img, y, x))."""
    n_patches = len(anchor_patches)
    res = {
        "same_image_intra_class_dists": [None] * n_patches,
        "same_image_intra_class_coords": [None] * n_patches,
        "same_image_inter_class_dists": [None] * n_patches,
        "same_image_inter_class_coords": [None] * n_patches,
        "other_image_intra_class_dists": [np.zeros((0,))] * n_patches,
        "other_image_intra_class_coords": [np.zeros((0, 3), int)] * n_patches,
        "other_image_inter_class_dists": [np.zeros((0,))] * n_patches,
        "other_image_inter_class_coords": [np.zeros((0, 3), int)] * n_patches,
    }

    for img_i in progress(ds.train_ndx):
        image = ds.get_image(int(img_i)).astype(np.float64) / 255.0
        y = ds.get_labels(int(img_i))
        dist_maps = patch_dist.sliding_window_distance_to_patches(
            image, anchor_patches, device)

        for patch_i in range(n_patches):
            dist_map = dist_maps[patch_i]
            row = ids[patch_i]
            intra = (y == row[4]).flatten()
            inter = ((y != row[4]) & (y != 255)).flatten()
            flat = dist_map.flatten()
            order = np.argsort(flat)
            intra_order = order[intra[order]][:n_neighbours]
            inter_order = order[inter[order]][:n_neighbours]

            def pack(order_sel):
                dists = flat[order_sel]
                coords = np.stack(np.unravel_index(order_sel, dist_map.shape),
                                  axis=1)
                coords = np.concatenate(
                    [np.full((len(coords), 1), img_i, int), coords], axis=1)
                return dists, coords

            intra_d, intra_c = pack(intra_order)
            inter_d, inter_c = pack(inter_order)

            if img_i == row[0]:
                res["same_image_intra_class_dists"][patch_i] = intra_d
                res["same_image_intra_class_coords"][patch_i] = intra_c
                res["same_image_inter_class_dists"][patch_i] = inter_d
                res["same_image_inter_class_coords"][patch_i] = inter_c
            else:
                for key, d, c in (("intra", intra_d, intra_c),
                                  ("inter", inter_d, inter_c)):
                    dk = f"other_image_{key}_class_dists"
                    ck = f"other_image_{key}_class_coords"
                    d_all = np.append(res[dk][patch_i], d, axis=0)
                    c_all = np.append(res[ck][patch_i], c, axis=0)
                    order = np.argsort(d_all)[:n_neighbours]
                    res[dk][patch_i] = d_all[order]
                    res[ck][patch_i] = c_all[order]
    return res


@click.command()
@click.argument("out_path", type=click.Path(writable=True))
@click.option("--dataset", type=click.Choice(
    ["camvid", "cityscapes", "pascal", "pascal_aug", "isic2017"]),
    default="cityscapes")
@click.option("--patch_size", type=int, default=225)
@click.option("--n_patches", type=int, default=1000)
@click.option("--n_neighbours", type=int, default=1000)
@click.option("--batch_size", type=int, default=-1)
@click.option("--batch", type=int, default=0)
@click.option("--show_progress", is_flag=True, default=False)
@click.option("--batch_index_one_based", is_flag=True, default=False)
@click.option("--load_choice", type=click.Path(readable=True, exists=True))
@click.option("--save_choice", type=click.Path(writable=True))
@click.option("--seed", type=int, default=12345)
@click.option("--device", default=None, help="torch device; the GPU unless 'cpu'")
def main(out_path, dataset, patch_size, n_patches, n_neighbours, batch_size,
         batch, show_progress, batch_index_one_based, load_choice,
         save_choice, seed, device):
    from cutmix_seg_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if batch_index_one_based:
        batch -= 1
    progress = (lambda x: x)
    if show_progress:
        try:
            import tqdm

            progress = tqdm.tqdm
        except ImportError:
            pass

    print("Loading dataset...", flush=True)
    ds = datasets.load_dataset(dataset, n_val=0, val_seed=0, n_sup=-1,
                               n_unsup=-1, split_seed=12345,
                               split_path=None)["ds_src"]
    rng = np.random.RandomState(seed)
    patch_hw = (patch_size, patch_size)

    if load_choice is not None:
        with open(load_choice, "rb") as f:
            ids = pickle.load(f)
    else:
        print("Choosing anchor and negative patches...", flush=True)
        ids = choose_anchors_and_negatives(ds, ds.train_ndx, n_patches,
                                           patch_hw, rng, progress)
        if save_choice is not None:
            with open(save_choice, "wb") as f:
                pickle.dump(ids, f)

    if batch_size == -1:
        batch_size = len(ids)
    ids = ids[batch * batch_size: (batch + 1) * batch_size]

    print("Extracting anchor and negative patches...", flush=True)
    anchors, negatives = extract_anchor_and_negative_patches(
        ds, ids, patch_hw, progress)
    boundary_dists = np.sqrt(((anchors - negatives) ** 2).sum(axis=(1, 2, 3)))

    print("Computing distances...", flush=True)
    results = class_distances(ds, ids, anchors, n_neighbours, dev, progress)
    results["anchor_negative_img_dir_y_x_cls"] = ids
    results["boundary_dists"] = boundary_dists
    with open(out_path, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main()
