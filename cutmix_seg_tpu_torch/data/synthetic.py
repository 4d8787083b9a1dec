"""Synthetic datasets, made from a seed, for runs of the trainers on
machines without the data (``chip_smoke.py``, tests):

* a loose-file Pascal VOC2012 tree in the layout
  ``data.sources.PascalVOCDataSource`` reads: JPEGImages/<name>.jpg,
  SegmentationClass/<name>.png (21 classes, 255 on a border band, as VOC's
  object outlines) and ImageSets/Segmentation/{train,val}.txt;
* an ISIC-2017 zip in the layout ``data.sources.ISIC2017DataSource`` reads
  (the converter's output): {train,val}/<name>_x.png and _y.png at 248x248,
  and rgb_mean_std.pkl with the train images' RGB mean and std.
"""

from __future__ import annotations

import io
import os
import pickle
import zipfile
from typing import Optional, Tuple

import numpy as np
from PIL import Image


def write_voc_tree(root: str, n_train: int, n_val: int,
                   size_range: Tuple[int, int] = (300, 500), seed: int = 0) -> str:
    """Write the tree under ``root``; returns ``root``. Image sides are
    drawn from ``size_range`` (inclusive); labels are blocks of random
    classes with a 255 band between them."""
    rng = np.random.RandomState(seed)
    for sub in ("JPEGImages", "SegmentationClass", os.path.join("ImageSets", "Segmentation")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = [f"2007_{i:06d}" for i in range(n_train + n_val)]
    for name in names:
        h, w = rng.randint(size_range[0], size_range[1] + 1, size=2)
        img = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "JPEGImages", f"{name}.jpg"), quality=90)
        block = max(min(h, w) // 4, 2)
        classes = rng.randint(0, 21, size=(-(-h // block), -(-w // block))).astype(np.uint8)
        lab = np.kron(classes, np.ones((block, block), np.uint8))[:h, :w]
        ys, xs = np.arange(h)[:, None] % block, np.arange(w)[None, :] % block
        lab[(ys < 1) | (xs < 1)] = 255
        Image.fromarray(lab).save(os.path.join(root, "SegmentationClass", f"{name}.png"))
    sets = os.path.join(root, "ImageSets", "Segmentation")
    with open(os.path.join(sets, "train.txt"), "w") as f:
        f.write("\n".join(names[:n_train]) + "\n")
    with open(os.path.join(sets, "val.txt"), "w") as f:
        f.write("\n".join(names[n_train:]) + "\n")
    return root


def write_isic_zip(path: str, n_train: int, n_val: int, size: int = 248,
                   seed: int = 0) -> str:
    """Write the zip to ``path``; returns ``path``. Each image is noise with
    a brighter elliptical lesion, its label 255 inside the ellipse and 0
    outside (the source thresholds at 127)."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[:size, :size].astype(np.float64)
    rgb_sum, rgb2_sum, rgb_n = np.zeros(3), np.zeros(3), 0
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(n_train + n_val):
            split = "train" if i < n_train else "val"
            cy, cx = rng.uniform(0.3, 0.7, 2) * size
            ry, rx = rng.uniform(0.1, 0.3, 2) * size
            lesion = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 <= 1.0
            img = rng.randint(0, 160, size=(size, size, 3))
            img[lesion] += 90
            img = img.astype(np.uint8)
            for suffix, arr in (("x", img), ("y", lesion.astype(np.uint8) * 255)):
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "PNG")
                zf.writestr(f"{split}/ISIC_{i:07d}_{suffix}.png", buf.getvalue())
            if split == "train":
                rgb = img.astype(np.float64) / 255.0
                rgb_sum += rgb.sum(axis=(0, 1))
                rgb2_sum += (rgb ** 2).sum(axis=(0, 1))
                rgb_n += size * size
        mean = rgb_sum / rgb_n
        zf.writestr("rgb_mean_std.pkl", pickle.dumps(
            dict(rgb_mean=mean, rgb_std=np.sqrt(rgb2_sum / rgb_n - mean ** 2))))
    return path


def write_config(path: str, voc_root: Optional[str] = None,
                 isic_zip: Optional[str] = None) -> str:
    """A ``semantic_segmentation.cfg`` naming ``voc_root`` as pascal_voc and
    ``isic_zip`` as isic2017; point ``$CUTMIX_SEG_CONFIG`` at it."""
    with open(path, "w") as f:
        f.write("[paths]\n")
        if voc_root is not None:
            f.write(f"pascal_voc = {voc_root}\n")
        if isic_zip is not None:
            f.write(f"isic2017 = {isic_zip}\n")
    return path
