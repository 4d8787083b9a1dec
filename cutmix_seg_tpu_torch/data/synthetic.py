"""Synthetic datasets, made from a seed, for runs of the trainers on
machines without the data (``chip_smoke.py``, tests):

* a loose-file Pascal VOC2012 tree in the layout
  ``data.sources.PascalVOCDataSource`` reads: JPEGImages/<name>.jpg,
  SegmentationClass/<name>.png (21 classes, 255 on a border band, as VOC's
  object outlines) and ImageSets/Segmentation/{train,val}.txt; optionally
  with the SBD-augmented split (``pascal_aug``): ImageSets/SegmentationAug/
  {train_aug,val}.txt and SegmentationClassAug/<name>.png;
* an ISIC-2017 zip in the layout ``data.sources.ISIC2017DataSource`` reads
  (the converter's output): {train,val}/<name>_x.png and _y.png at 248x248,
  and rgb_mean_std.pkl with the train images' RGB mean and std;
* the two official Cityscapes zips that ``tools/convert_cityscapes.py``
  reads (leftImg8bit/<split>/<city>/<name>_leftImg8bit.png and
  gtFine/<split>/<city>/<name>_gtFine_labelIds.png);
* a CamVid zip in the layout ``data.sources.CamVidDataSource`` reads
  (CamVid/{train,val,test}/<name>.png and CamVid/{train,val,test}annot/).
"""

from __future__ import annotations

import io
import os
import pickle
import zipfile
from typing import Optional, Tuple

import numpy as np
from PIL import Image


# the SBD train_aug list has as many names as the pascal_aug split pickle
# (data/splits/pascal_aug/split_0.pkl) permutes
SBD_TRAIN_AUG = 10582


def _link(src: str, dst: str) -> None:
    """A hard link, or a symbolic one where the file system has none."""
    try:
        os.link(src, dst)
    except OSError:
        os.symlink(os.path.abspath(src), dst)


def write_voc_tree(root: str, n_train: int, n_val: int,
                   size_range: Tuple[int, int] = (300, 500), seed: int = 0,
                   sbd_train: int = 0) -> str:
    """Write the tree under ``root``; returns ``root``. Image sides are
    drawn from ``size_range`` (inclusive); labels are blocks of random
    classes with a 255 band between them.

    ``sbd_train`` > 0 adds the SBD-augmented split: ``sbd_train`` train_aug
    names (``SBD_TRAIN_AUG`` for the recipes' split pickle) and the val
    names, their images and labels linked to the n_train + n_val written
    pairs in turn, so the tree is written in seconds."""
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
    if sbd_train > 0:
        _write_sbd_split(root, names, n_train, sbd_train)
    return root


def _write_sbd_split(root: str, names, n_train: int, sbd_train: int) -> None:
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


def _png(arr: np.ndarray, level: int = 6) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG", compress_level=level)
    return buf.getvalue()


def _scene(rng, h: int, w: int, n_ids: int, block: int):
    """A smooth RGB image and a label map of random ids in blocks of
    ``block`` px, whose block edges the image follows."""
    ids = rng.randint(0, n_ids, size=(-(-h // block), -(-w // block))).astype(np.uint8)
    lab = ids.repeat(block, axis=0).repeat(block, axis=1)[:h, :w]
    # speckle: a tenth of the pixels take another id, so a downsampling
    # block can hold several ids, ties included
    speckle = rng.rand(h, w) < 0.1
    lab[speckle] = rng.randint(0, n_ids, size=int(speckle.sum()))
    palette = rng.randint(0, 192, size=(n_ids, 3)).astype(np.uint8)
    ramp = (np.arange(w) * 64 // max(w, 1)).astype(np.uint8)
    return palette[lab] + ramp[None, :, None], lab


# a few of Cityscapes' 50 cities; names <city>_<sequence>_<frame>
_CITIES = {"train": ("aachen", "bochum", "zurich"), "val": ("frankfurt", "lindau")}


def write_cityscapes_zips(out_dir: str, n_train: int, n_val: int,
                          size: Tuple[int, int] = (1024, 2048), seed: int = 0):
    """The official ``leftImg8bit_trainvaltest.zip`` and
    ``gtFine_trainvaltest.zip`` under ``out_dir`` at ``size`` (H, W; the
    real frames are 1024x2048), with label ids drawn from all 34 of
    Cityscapes' ids, so the converter's void remap is exercised. Returns the
    two paths. PNGs are written at zlib level 1 (the converter reads any)."""
    rng = np.random.RandomState(seed)
    x_path = os.path.join(out_dir, "leftImg8bit_trainvaltest.zip")
    y_path = os.path.join(out_dir, "gtFine_trainvaltest.zip")
    h, w = size
    with zipfile.ZipFile(x_path, "w") as xz, zipfile.ZipFile(y_path, "w") as yz:
        for split, n in (("train", n_train), ("val", n_val)):
            for i in range(n):
                city = _CITIES[split][i % len(_CITIES[split])]
                stem = f"{split}/{city}/{city}_{i:06d}_000019"
                img, lab = _scene(rng, h, w, 34, max(h // 8, 2))
                xz.writestr(f"leftImg8bit/{stem}_leftImg8bit.png", _png(img, 1))
                yz.writestr(f"gtFine/{stem}_gtFine_labelIds.png", _png(lab, 1))
    return x_path, y_path


def write_camvid_zip(path: str, n_train: int, n_val: int, n_test: int,
                     size: Tuple[int, int] = (360, 480), seed: int = 0) -> str:
    """A CamVid zip (SegNet's layout, 360x480 frames): CamVid/<split>/<name>.png
    and the labels, ids 0-11 (11 is void), in CamVid/<split>annot/."""
    rng = np.random.RandomState(seed)
    h, w = size
    with zipfile.ZipFile(path, "w") as zf:
        for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
            for i in range(n):
                img, lab = _scene(rng, h, w, 12, max(h // 6, 2))
                name = f"0001TP_{split}_{i:06d}.png"
                zf.writestr(f"CamVid/{split}/{name}", _png(img))
                zf.writestr(f"CamVid/{split}annot/{name}", _png(lab))
    return path


def write_config(path: str, voc_root: Optional[str] = None,
                 isic_zip: Optional[str] = None, cityscapes_zip: Optional[str] = None,
                 camvid_zip: Optional[str] = None) -> str:
    """A ``semantic_segmentation.cfg`` naming ``voc_root`` as pascal_voc,
    ``isic_zip`` as isic2017, ``cityscapes_zip`` (the converter's output) as
    cityscapes and ``camvid_zip`` as camvid; point ``$CUTMIX_SEG_CONFIG``
    at it."""
    paths = {"pascal_voc": voc_root, "isic2017": isic_zip, "cityscapes": cityscapes_zip,
             "camvid": camvid_zip}
    with open(path, "w") as f:
        f.write("[paths]\n")
        for name, value in paths.items():
            if value is not None:
                f.write(f"{name} = {value}\n")
    return path
