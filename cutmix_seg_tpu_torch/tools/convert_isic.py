"""ISIC-2017 converter: official data/ground-truth zips -> the framework's
{split}/{name}_x.png / _y.png zip (resized, default 248x248) plus the
dataset RGB mean/std pickle (a copy of cutmix_seg_tpu.tools.convert_isic).

    python -m cutmix_seg_tpu_torch.tools.convert_isic <dir of the four ISIC-2017 zips>

Same output contract as the reference converter (reference:
convert_isic.py:7-102); area-averaging resize is PIL's BOX filter
(cv2.INTER_AREA equivalent for downscaling).
"""

from __future__ import annotations

import os
import pickle
import zipfile

import click
import numpy as np
from PIL import Image


def _resize_area(img: Image.Image, out_hw) -> np.ndarray:
    return np.array(img.resize((out_hw[1], out_hw[0]), Image.BOX))


def _resize_min_side(img: Image.Image, out_size: int) -> np.ndarray:
    w, h = img.size
    scale = float(out_size) / float(min(h, w))
    return np.array(img.resize((round(w * scale), round(h * scale)), Image.BOX))


def process_zip_pair(out_zip, out_folder, in_x_zip, in_y_zip, y_folder,
                     out_size, progress=True):
    paths = []
    for x_path in in_x_zip.namelist():
        name, ext = os.path.splitext(x_path)
        if ext.lower() == ".jpg" and not name.lower().endswith("_superpixels"):
            paths.append(x_path)
    if progress:
        try:
            import tqdm

            paths = tqdm.tqdm(paths)
        except ImportError:
            pass

    rgb_sum = np.zeros(3)
    rgb2_sum = np.zeros(3)
    rgb_n = 0
    for x_path in paths:
        x_name = os.path.splitext(os.path.split(x_path)[1])[0]
        y_path = f"{y_folder}/{x_name}_segmentation.png"

        x_img = Image.open(in_x_zip.open(x_path, "r"))
        y_img = Image.open(in_y_zip.open(y_path, "r"))
        if out_size is None:
            x_arr, y_arr = np.array(x_img), np.array(y_img)
        elif isinstance(out_size, int):
            x_arr = _resize_min_side(x_img, out_size)
            y_arr = _resize_min_side(y_img, out_size)
        else:
            x_arr = _resize_area(x_img, out_size)
            y_arr = _resize_area(y_img, out_size)

        with out_zip.open(f"{out_folder}/{x_name}_x.png", "w") as f:
            Image.fromarray(x_arr).save(f, "PNG")
        with out_zip.open(f"{out_folder}/{x_name}_y.png", "w") as f:
            Image.fromarray(y_arr).save(f, "PNG")

        rgb = x_arr.astype(np.float64) / 255.0
        rgb_sum += rgb.sum(axis=(0, 1))
        rgb2_sum += (rgb ** 2).sum(axis=(0, 1))
        rgb_n += rgb.shape[0] * rgb.shape[1]

    rgb_mean = rgb_sum / rgb_n
    rgb_std = np.sqrt(rgb2_sum / rgb_n - rgb_mean ** 2)
    return rgb_mean, rgb_std


def convert_isic(isic_zips_dir, out_path, out_size=(248, 248)):
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tz = zipfile.ZipFile(os.path.join(isic_zips_dir, "ISIC-2017_Training_Data.zip"))
    ty = zipfile.ZipFile(os.path.join(
        isic_zips_dir, "ISIC-2017_Training_Part1_GroundTruth.zip"))
    vz = zipfile.ZipFile(os.path.join(isic_zips_dir, "ISIC-2017_Validation_Data.zip"))
    vy = zipfile.ZipFile(os.path.join(
        isic_zips_dir, "ISIC-2017_Validation_Part1_GroundTruth.zip"))
    out_zip = zipfile.ZipFile(out_path, "w")

    print("Processing training set...")
    rgb_mean, rgb_std = process_zip_pair(
        out_zip, "train", tz, ty, "ISIC-2017_Training_Part1_GroundTruth", out_size)
    print("Processing validation set...")
    process_zip_pair(
        out_zip, "val", vz, vy, "ISIC-2017_Validation_Part1_GroundTruth", out_size)

    print("Writing mean and std-dev...")
    with out_zip.open("rgb_mean_std.pkl", "w") as f:
        pickle.dump(dict(rgb_mean=rgb_mean, rgb_std=rgb_std), f)
    out_zip.close()


@click.command()
@click.argument("isic_zips_dir", type=click.Path(readable=True))
@click.option("--out_size", type=str, default="248,248")
@click.option("--out_path", type=click.Path(), default=None)
def cli(isic_zips_dir, out_size, out_path):
    if "," in out_size:
        h, w = out_size.split(",")
        size = (int(h.strip()), int(w.strip()))
    elif out_size.strip():
        size = int(out_size.strip())
    else:
        size = None
    if out_path is None:
        from cutmix_seg_tpu_torch.data import settings

        out_path = settings.get_data_path("isic2017", exists=False)
    print(f"Writing data to {out_path}")
    convert_isic(isic_zips_dir, out_path, size)


if __name__ == "__main__":
    cli()
