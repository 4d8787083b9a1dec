"""Toy 2D classification datasets: spiral, image-derived, cross-hatch (a
copy of cutmix_seg_tpu.toy2d.data, which the port does not import).

Re-derivation of the reference's toy2d/generate_data.py (reference:
toy2d/generate_data.py:20-262): 2D point clouds in [-1, 1]^2 with a small
supervised subset, plus the density-image visualisation used for the paper's
Figure-3 decision-boundary renders. skimage dependencies are replaced with
NumPy equivalents (luma grayscale, Roberts cross edges, block-mean
downscaling); drawing uses PIL. The unbalanced split is a NumPy copy of
scikit-learn's ``StratifiedShuffleSplit`` (one split, an integer test size),
which draws from the same RandomState in the same order, so the port needs
no scikit-learn.
"""

from __future__ import annotations

import pickle
from typing import Tuple

import numpy as np
from PIL import Image, ImageDraw
from scipy.ndimage import binary_erosion


def _blend(a, b, t):
    return a + (b - a) * t


def _rgb2grey(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img.astype(np.float64)
    img = img[..., :3].astype(np.float64)
    return img @ np.array([0.2125, 0.7154, 0.0721])


def _roberts(img: np.ndarray) -> np.ndarray:
    """Roberts cross edge magnitude (skimage.filters.roberts equivalent)."""
    out = np.zeros_like(img, dtype=np.float64)
    d1 = img[:-1, :-1] - img[1:, 1:]
    d2 = img[:-1, 1:] - img[1:, :-1]
    out[:-1, :-1] = np.sqrt(d1 * d1 + d2 * d2)
    return out


def _downscale_mean(img: np.ndarray, factors: Tuple[int, int]) -> np.ndarray:
    """Block-mean downscale, zero-padding up to a factor multiple (matching
    skimage.transform.downscale_local_mean's cval=0 padding)."""
    fy, fx = factors
    h = -(-img.shape[0] // fy) * fy
    w = -(-img.shape[1] // fx) * fx
    padded = np.zeros((h, w), dtype=img.dtype)
    padded[: img.shape[0], : img.shape[1]] = img
    return padded.reshape(h // fy, fy, w // fx, fx).mean(axis=(1, 3))


class Dataset2D:
    def __init__(self, X, y, img_size):
        self.img_size = tuple(img_size)
        self.img_scale = np.array(img_size, dtype=float)
        self.X = X
        self.y = y
        gx, gy = np.meshgrid(np.arange(self.img_size[1]), np.arange(self.img_size[0]))
        self.px_grid = np.stack([gy, gx], axis=2) + 0.5

    def img_to_real(self, x):
        return (x / self.img_scale) * 2.0 - 1.0

    def real_to_img(self, x):
        return (x + 1.0) * 0.5 * self.img_scale


class ClassificationDataset2D(Dataset2D):
    def __init__(self, X, y, img_size, sup_indices, unsup_indices):
        super().__init__(X, y, img_size)
        self.sup_X = self.X[sup_indices]
        self.sup_y = self.y[sup_indices]
        self.unsup_X = self.X[unsup_indices]
        self.unsup_y = self.y[unsup_indices]
        self.sup_X_img = self.real_to_img(self.sup_X)
        self.unsup_X_img = self.real_to_img(self.unsup_X)

        X_img = self.real_to_img(X)
        bins = np.arange(self.img_size[0] * 16) / 16.0
        dens, _, _ = np.histogram2d(X_img[:, 0], X_img[:, 1], bins=(bins, bins))
        dens = _downscale_mean(dens.astype(float), (16, 16)) * 256.0
        self.dens_img = 1.0 - (0.75 ** dens)
        self.px_grid_vis = self.img_to_real(self.px_grid.reshape((-1, 2)))
        self.image_edges = None

    def load_supervised(self, path):
        with open(path, "rb") as f:
            data = pickle.load(f)
        self.sup_X = data["clf_sup_X"]
        self.sup_y = data["clf_sup_y"]
        self.sup_X_img = self.real_to_img(self.sup_X)

    def semisup_image_plot(self, pred_y1, pred_grad=None) -> np.ndarray:
        """Decision-boundary render (uint8 RGB), matching the reference's
        visual encoding: density shading, green prediction tint, optional
        blue consistency-gradient tint, magenta class-boundary edges, and
        circled supervised points."""
        h, w = self.img_size
        vis = np.zeros((h, w, 3), dtype=float)
        vis += 1.0 - self.dens_img[:, :, None]
        if pred_y1.ndim < 2:
            pred_y1 = pred_y1.reshape(self.img_size)
        vis = _blend(vis, np.array([[[0.0, 0.75, 0.0]]]), pred_y1[:, :, None] * 0.3)
        if pred_grad is not None:
            if pred_grad.ndim < 2:
                pred_grad = pred_grad.reshape(self.img_size)
            pred_grad = pred_grad / max(abs(pred_grad).max(), 1e-30)
            pred_grad = np.sqrt(pred_grad)
            vis = _blend(vis, np.array([[[0.0, 0.0, 1.0]]]), pred_grad[:, :, None] * 0.5)
        if self.image_edges is not None:
            vis = _blend(vis, np.array([[[1.0, 0.0, 1.0]]]),
                         self.image_edges[:, :, None] * 0.5)
        vis = (np.clip(vis, 0.0, 1.0) * 255.0).astype(np.uint8)

        pil = Image.fromarray(vis)
        draw = ImageDraw.Draw(pil)
        for i in range(len(self.sup_y)):
            cy, cx = self.sup_X_img[i, 0], self.sup_X_img[i, 1]
            colour = (255, 128, 0) if self.sup_y[i] == 0 else (0, 0, 255)
            draw.ellipse([cx - 5, cy - 5, cx + 5, cy + 5], outline=colour, width=2)
        return np.array(pil)


def _approximate_mode(class_counts, n_draws, rng):
    """sklearn.utils.extmath._approximate_mode: the counts per class of
    ``n_draws`` draws, ties in the remainders broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            floored[rng.choice(inds, size=add_now, replace=False)] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_shuffle_split(y, n_test: int, rng):
    """(train, test) indices of ``StratifiedShuffleSplit(n_splits=1,
    test_size=n_test, random_state=rng).split(y, y)``: the same draws from
    ``rng`` in the same order (scikit-learn 1.x)."""
    n_train = len(y) - n_test
    classes, y_indices, class_counts = np.unique(y, return_inverse=True,
                                                 return_counts=True)
    if class_counts.min() < 2 or min(n_train, n_test) < len(classes):
        raise ValueError(f"cannot split {len(y)} samples of {len(classes)} classes "
                         f"into {n_test} stratified test samples")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


class SplitClassificationDataset2D(ClassificationDataset2D):
    def __init__(self, X, y, img_size, n_sup, balance_classes, rng):
        if balance_classes:
            n_classes = y.max() + 1
            sup, unsup = [], []
            n_per = n_sup // n_classes
            for c in range(n_classes):
                cls_ndx = np.arange(len(y))[y == c]
                rng.shuffle(cls_ndx)
                sup.append(cls_ndx[:n_per])
                unsup.append(cls_ndx)
            sup_indices = np.concatenate(sup)
            unsup_indices = np.concatenate(unsup)
        else:
            _, sup_indices = _stratified_shuffle_split(y, n_sup, rng)
            unsup_indices = np.arange(len(y))
        super().__init__(X, y, img_size, sup_indices, unsup_indices)


def classification_dataset_from_image(image_path, region_erode_radius,
                                      img_noise_std, n_sup, balance_classes,
                                      rng):
    """Two-class point dataset from a black/white image: sample class regions
    (optionally eroded away from the boundary), add positional noise
    (reference: generate_data.py:171-200)."""
    img = np.array(Image.open(image_path))
    img = _rgb2grey(img)
    if img.max() > 1.0:
        img = img / 255.0
    img_bin = img >= 0.5
    img_size = img_bin.shape

    if region_erode_radius > 0:
        cls1 = binary_erosion(img_bin, iterations=region_erode_radius)
        cls0 = binary_erosion(~img_bin, iterations=region_erode_radius)
    else:
        cls1, cls0 = img_bin, ~img_bin

    y0, x0 = np.where(cls0)
    y1, x1 = np.where(cls1)
    X_img = np.concatenate(
        [np.stack([y0, x0], axis=1), np.stack([y1, x1], axis=1)])
    y = np.concatenate([np.zeros(len(y0), int), np.ones(len(y1), int)])
    X_img = X_img + rng.normal(0, img_noise_std, size=X_img.shape)
    X_real = (X_img / np.array(img_size)) * 2 - 1

    ds = SplitClassificationDataset2D(X_real, y, img_size, n_sup,
                                      balance_classes, rng)
    ds.image = img
    ds.image_edges = _roberts(img)
    return ds


def spiral_classification_dataset(n_sup, balance_classes, rng, N=5000,
                                  spiral_radius=20.0, img_size=(256, 256)):
    """Two interleaved spirals (reference: generate_data.py:203-221)."""
    r0 = np.sqrt(rng.uniform(1.0, spiral_radius ** 2, size=(N,)))
    r1 = np.sqrt(rng.uniform(1.0, spiral_radius ** 2, size=(N,)))
    t0 = r0 * 0.5
    t1 = r1 * 0.5 + np.pi
    radius = np.concatenate([r0, r1])
    theta = np.concatenate([t0, t1])
    X = np.stack([np.sin(theta) * radius, np.cos(theta) * radius], axis=1)
    y = np.concatenate([np.zeros(N, int), np.ones(N, int)])
    X = (X + rng.normal(size=X.shape) * 0.2) / spiral_radius
    ds = SplitClassificationDataset2D(X, y, img_size, n_sup, balance_classes, rng)
    ds.image = None
    return ds


def crosshatch_classification_dataset(rng, grid_size, points_per_cell,
                                      cell_off_std=0.05, n_sup=2,
                                      img_size=(256, 256)):
    """Cross-hatch lattice dataset (reference: generate_data.py:224-262)."""
    cell = 2.0 / grid_size
    std = cell_off_std * cell
    g = np.linspace(-1, 1, grid_size + 1)
    x0, y0 = np.meshgrid(g, g)
    X0 = np.repeat(np.stack([y0, x0], axis=2).reshape(-1, 2), points_per_cell, axis=0)
    x1, y1 = np.meshgrid(g[:-1] + cell * 0.5, g[:-1] + cell * 0.5)
    X1 = np.repeat(np.stack([y1, x1], axis=2).reshape(-1, 2), points_per_cell, axis=0)
    X = np.concatenate([X0, X1]) + rng.normal(size=(len(X0) + len(X1), 2)) * std
    y = np.concatenate([np.zeros(len(X0), int), np.ones(len(X1), int)])

    sup_X = np.array([[0.0, 0.0], [cell * 0.5, cell * 0.5]])
    sup_y = np.array([0, 1])
    if n_sup == -1:
        sup_indices = np.arange(len(y))
        unsup_indices = np.arange(2) + len(y)
    else:
        unsup_indices = np.arange(len(y))
        sup_indices = np.arange(2) + len(y)
    X = np.concatenate([X, sup_X])
    y = np.concatenate([y, sup_y])
    ds = ClassificationDataset2D(X, y, img_size, sup_indices, unsup_indices)
    ds.cell_size = cell
    ds.cell_off_std = std
    ds.image = None
    return ds


def save_supervised_split(out_path, ds):
    """Pickle the sup/unsup split (the generate_data CLI contract;
    reference: generate_data.py:279-292)."""
    data = dict(clf_sup_X=ds.sup_X, clf_unsup_X=ds.unsup_X,
                clf_sup_y=ds.sup_y, clf_unsup_y=ds.unsup_y)
    with open(out_path, "wb") as f:
        pickle.dump(data, f)
