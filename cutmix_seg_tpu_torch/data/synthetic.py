"""A synthetic loose-file Pascal VOC2012 tree, made from a seed, for runs of
the trainer on machines without the dataset (``chip_smoke.py``, tests).

The layout is the one ``data.sources.PascalVOCDataSource`` reads:
JPEGImages/<name>.jpg, SegmentationClass/<name>.png (21 classes, 255 on a
border band, as VOC's object outlines) and ImageSets/Segmentation/
{train,val}.txt.
"""

from __future__ import annotations

import os
from typing import Tuple

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


def write_config(path: str, voc_root: str) -> str:
    """A ``semantic_segmentation.cfg`` naming ``voc_root`` as pascal_voc;
    point ``$CUTMIX_SEG_CONFIG`` at it."""
    with open(path, "w") as f:
        f.write(f"[paths]\npascal_voc = {voc_root}\n")
    return path
