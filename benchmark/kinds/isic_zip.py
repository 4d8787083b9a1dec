"""The ``isic_zip`` data kind: ISIC 2017 in the converter's zip.

``write``: 248 x 248 PNGs, noise with a brighter elliptical lesion labelled
255, ``train`` + ``val`` images and the train RGB statistics; ``distinct``
train images are drawn and the ``train`` entries hold them in turn. A
frozen copy of the program's ``data/synthetic.py::write_isic_zip``.

``Reader``: the zip as the reference reads it (the zip's train names,
permuted by ``RandomState(split_seed)``; the first n_sup are labelled,
every train name is unlabelled); PNG images, PNG masks labelled where they
read 127 or more.
"""

from __future__ import annotations

import io
import os
import pickle
import zipfile

import numpy as np
from PIL import Image


def write(data: dict, root: str, seed: int) -> dict:
    path = write_isic_zip(os.path.join(root, "isic2017.zip"), data["train"], data["val"],
                          data["size"], seed, data.get("distinct", 0))
    return {"kind": "isic_zip", "path": path, "config_name": "isic2017"}


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


class Reader:
    def __init__(self, path: str):
        self.path = path
        self._zip = None

    def split(self, n_sup: int, split_path: str, split_seed: int):
        with zipfile.ZipFile(self.path) as zf:
            stems = [os.path.splitext(n)[0] for n in zf.namelist()]
        names = sorted(s[:-2] for s in stems if s.endswith("_x"))
        train_ndx = np.array([i for i, n in enumerate(names) if n.startswith("train/")])
        perm = np.random.RandomState(split_seed).permutation(len(train_ndx))
        return names, train_ndx[perm[:n_sup]], train_ndx[perm]

    def image(self, name: str) -> np.ndarray:
        return _decode_bytes(self._zf().read(f"{name}_x.png"))

    def labels(self, name: str) -> np.ndarray:
        return (_decode_bytes(self._zf().read(f"{name}_y.png")) >= 127).astype(np.int64)

    def _zf(self) -> zipfile.ZipFile:
        if self._zip is None:
            self._zip = zipfile.ZipFile(self.path)
        return self._zip


def _decode_bytes(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.array(im)
