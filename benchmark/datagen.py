"""The one generator of the benchmark's data: a configuration's ``data``
block names a writer and its sizes, and the run's seed makes the files.

* ``voc_sbd``: a Pascal VOC2012 tree with the SBD-augmented split, as the
  recipe's ``--dataset=pascal_aug --split_path=...split_0.pkl`` reads it:
  ``written`` JPEG / PNG pairs with sides drawn from ``size_range`` (one
  set of sides for every seed, which the seed orders: the decode work of a
  run does not depend on its seed), labels
  in blocks of the 21 classes with a 255 band between them, and the 10,582
  train_aug names linked to the written pairs in turn;
* ``isic_zip``: an ISIC 2017 zip in the converter's layout (248 x 248
  PNGs, noise with a brighter elliptical lesion labelled 255) with
  ``train`` + ``val`` images and the train RGB statistics; ``distinct``
  train images are drawn and the ``train`` entries hold them in turn.

The writers are copies of the program's ``data/synthetic.py``
(``write_voc_tree``, ``write_isic_zip``), frozen here so that the program
can change without changing the benchmark's inputs.
"""

from __future__ import annotations

import io
import os
import pickle
import zipfile
from typing import Tuple

import numpy as np
from PIL import Image


def _link(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        os.symlink(os.path.abspath(src), dst)


# the generator of the image sides: every seed writes the same set of sides
SIDES_SEED = 20170


def write_voc_tree(root: str, n_train: int, n_val: int, size_range: Tuple[int, int],
                   seed: int, sbd_train: int) -> str:
    rng = np.random.RandomState(seed)
    for sub in ("JPEGImages", "SegmentationClass", os.path.join("ImageSets", "Segmentation")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = [f"2007_{i:06d}" for i in range(n_train + n_val)]
    sides = np.random.RandomState(SIDES_SEED).randint(
        size_range[0], size_range[1] + 1, size=(n_train + n_val, 2))
    order = np.concatenate([rng.permutation(n_train), n_train + rng.permutation(n_val)])
    for name, (h, w) in zip(names, sides[order]):
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
    aug_sets = os.path.join(root, "ImageSets", "SegmentationAug")
    aug_labels = os.path.join(root, "SegmentationClassAug")
    os.makedirs(aug_sets, exist_ok=True)
    os.makedirs(aug_labels, exist_ok=True)
    train_aug = [f"2011_{i:06d}" for i in range(sbd_train)]
    for i, name in enumerate(train_aug):
        src = names[i % n_train]
        _link(os.path.join(root, "JPEGImages", f"{src}.jpg"),
              os.path.join(root, "JPEGImages", f"{name}.jpg"))
        _link(os.path.join(root, "SegmentationClass", f"{src}.png"),
              os.path.join(aug_labels, f"{name}.png"))
    for name in names[n_train:]:
        _link(os.path.join(root, "SegmentationClass", f"{name}.png"),
              os.path.join(aug_labels, f"{name}.png"))
    with open(os.path.join(aug_sets, "train_aug.txt"), "w") as f:
        f.write("\n".join(train_aug) + "\n")
    with open(os.path.join(aug_sets, "val.txt"), "w") as f:
        f.write("\n".join(names[n_train:]) + "\n")
    return root


def write_isic_zip(path: str, n_train: int, n_val: int, size: int, seed: int,
                   distinct: int = 0) -> str:
    """``distinct`` (0: all) train images are drawn and encoded; the
    ``n_train`` train entries hold them in turn."""
    rng = np.random.RandomState(seed)
    distinct = min(distinct or n_train, n_train)
    ys, xs = np.mgrid[:size, :size].astype(np.float64)
    rgb_sum, rgb2_sum, rgb_n = np.zeros(3), np.zeros(3), 0
    drawn = []
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(distinct + n_val):
            cy, cx = rng.uniform(0.3, 0.7, 2) * size
            ry, rx = rng.uniform(0.1, 0.3, 2) * size
            lesion = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 <= 1.0
            img = rng.randint(0, 160, size=(size, size, 3))
            img[lesion] += 90
            img = img.astype(np.uint8)
            pngs = []
            for arr in (img, lesion.astype(np.uint8) * 255):
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "PNG")
                pngs.append(buf.getvalue())
            if i < distinct:
                rgb = img.astype(np.float64) / 255.0
                drawn.append((pngs, rgb.sum(axis=(0, 1)), (rgb ** 2).sum(axis=(0, 1))))
            else:
                for suffix, png in zip("xy", pngs):
                    zf.writestr(f"val/ISIC_{n_train + i - distinct:07d}_{suffix}.png", png)
        for i in range(n_train):
            pngs, s1, s2 = drawn[i % distinct]
            for suffix, png in zip("xy", pngs):
                zf.writestr(f"train/ISIC_{i:07d}_{suffix}.png", png)
            rgb_sum += s1
            rgb2_sum += s2
            rgb_n += size * size
        mean = rgb_sum / rgb_n
        zf.writestr("rgb_mean_std.pkl", pickle.dumps(
            dict(rgb_mean=mean, rgb_std=np.sqrt(rgb2_sum / rgb_n - mean ** 2))))
    return path


def write(data: dict, root: str, seed: int) -> dict:
    """Write a configuration's data under ``root`` from ``seed``; returns
    {'kind', 'path', 'config_name'} (the program's config-file entry)."""
    seed = seed % (1 << 32)
    if data["kind"] == "voc_sbd":
        path = write_voc_tree(os.path.join(root, "VOC2012"), data["written"], data["val"],
                              tuple(data["size_range"]), seed, data["sbd_train"])
        return {"kind": "voc_sbd", "path": path, "config_name": "pascal_voc"}
    if data["kind"] == "isic_zip":
        path = write_isic_zip(os.path.join(root, "isic2017.zip"), data["train"], data["val"],
                              data["size"], seed, data.get("distinct", 0))
        return {"kind": "isic_zip", "path": path, "config_name": "isic2017"}
    raise ValueError(f"unknown data kind {data['kind']!r}")


def write_paths_config(path: str, written: dict) -> str:
    """The program's dataset-path file naming the written data."""
    with open(path, "w") as f:
        f.write(f"[paths]\n{written['config_name']} = {written['path']}\n")
    return path
