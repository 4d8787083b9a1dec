"""The ``voc_sbd`` data kind: a Pascal VOC2012 tree with the SBD-augmented
split, as the recipe's ``--dataset=pascal_aug --split_path=...split_0.pkl``
reads it.

``write``: ``written`` JPEG / PNG pairs with sides drawn from ``size_range``
(one set of sides for every seed, which the seed orders: the decode work of
a run does not depend on its seed), labels in blocks of the 21 classes with
a 255 band between them, and the 10,582 train_aug names linked to the
written pairs in turn. A frozen copy of the program's
``data/synthetic.py::write_voc_tree``.

``Reader``: the tree as the reference reads it (train_aug.txt and val.txt,
names sorted, the train names permuted by the split pickle; the first n_sup
are labelled, every train name is unlabelled); JPEG images, PNG labels from
SegmentationClassAug.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np
from PIL import Image


def write(data: dict, root: str, seed: int) -> dict:
    path = write_voc_tree(os.path.join(root, "VOC2012"), data["written"], data["val"],
                          tuple(data["size_range"]), seed, data["sbd_train"])
    return {"kind": "voc_sbd", "path": path, "config_name": "pascal_voc"}


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


class Reader:
    def __init__(self, path: str):
        self.path = path

    def split(self, n_sup: int, split_path: str, split_seed: int):
        sets = os.path.join(self.path, "ImageSets", "SegmentationAug")
        train = _lines(os.path.join(sets, "train_aug.txt"))
        val = _lines(os.path.join(sets, "val.txt"))
        names = sorted(set(train + val))
        pos = {n: i for i, n in enumerate(names)}
        train_ndx = np.array([pos[n] for n in train])
        with open(split_path, "rb") as f:
            train_ndx = train_ndx[pickle.load(f)]
        return names, train_ndx[:n_sup], train_ndx

    def image(self, name: str) -> np.ndarray:
        return _decode_file(os.path.join(self.path, "JPEGImages", f"{name}.jpg"))

    def labels(self, name: str) -> np.ndarray:
        return _decode_file(os.path.join(
            self.path, "SegmentationClassAug", f"{name}.png")).astype(np.int64)


def _lines(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _decode_file(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.array(im)
