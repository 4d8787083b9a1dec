"""Cityscapes converter: official leftImg8bit/gtFine zips -> the framework's
{split}/{name}_x.png / _y.png zip, x2-downsampled (a copy of
cutmix_seg_tpu.tools.convert_cityscapes).

    python -m cutmix_seg_tpu_torch.tools.convert_cityscapes \
        leftImg8bit_trainvaltest.zip gtFine_trainvaltest.zip [--out_path PATH]

Same output format and downsampling semantics as the reference converter
(reference: convert_cityscapes.py:8-52): images are block-mean downsampled;
label maps are downsampled by majority vote, the lowest id winning a tie
(what the JAX package's tool computes as the argmax of one-hot block sums,
here without a 34-channel one-hot array of the 1024x2048 frame).
"""

from __future__ import annotations

import os
import zipfile

import click
import numpy as np
from PIL import Image


def downsample_label_img(y: np.ndarray, downsample: int) -> np.ndarray:
    """Majority-vote label downsampling: per block, the id with the most
    pixels, the lowest such id on a tie. Each of a block's pixels counts
    the block's pixels that share its id, so the work is downsample^4
    compares per block whatever the number of ids."""
    h, w = y.shape
    cand = (y.reshape(h // downsample, downsample, w // downsample, downsample)
            .transpose(0, 2, 1, 3).reshape(h // downsample, w // downsample, -1))
    count = (cand[..., :, None] == cand[..., None, :]).sum(axis=-1, dtype=np.int64)
    top = int(cand.max()) + 1
    # most pixels first, then the lowest id
    pick = np.argmax(count * top + (top - 1 - cand.astype(np.int64)), axis=-1)
    return np.take_along_axis(cand, pick[..., None], axis=-1)[..., 0].astype(np.int64)


def downsample_image(x: np.ndarray, downsample: int) -> np.ndarray:
    """Block-mean image downsampling (skimage downscale_local_mean
    equivalent), truncated to uint8: the block's integer sum divided by
    its size, rounded down, as the float64 mean truncates."""
    h = x.shape[0] - x.shape[0] % downsample
    w = x.shape[1] - x.shape[1] % downsample
    x = x.reshape(x.shape[0], x.shape[1], -1)  # (H, W, C); a 2-D image gets C = 1
    total = sum(x[i:h:downsample, j:w:downsample].astype(np.uint32)
                for i in range(downsample) for j in range(downsample))
    return (total // (downsample * downsample)).astype(np.uint8)


def convert_cityscapes(leftimg_zip_path, gtfine_zip_path, out_path,
                       downsample: int = 2, progress=True):
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    x_zip = zipfile.ZipFile(leftimg_zip_path, "r")
    y_zip = zipfile.ZipFile(gtfine_zip_path, "r")
    out_zip = zipfile.ZipFile(out_path, "w")

    names = [n for n in x_zip.namelist()
             if os.path.splitext(n)[1].lower() == ".png"
             and not n.startswith("leftImg8bit/test")]
    if progress:
        try:
            import tqdm

            names = tqdm.tqdm(names)
        except ImportError:
            pass

    for name in names:
        sample = (os.path.splitext(name)[0]
                  .replace("_leftImg8bit", "").replace("leftImg8bit/", ""))
        gt_name = f"gtFine/{sample}_gtFine_labelIds.png"
        x_img = np.array(Image.open(x_zip.open(name, "r")))
        y_img = np.array(Image.open(y_zip.open(gt_name, "r")))
        if downsample != 1:
            x_img = downsample_image(x_img, downsample)
            y_img = downsample_label_img(y_img, downsample)
        with out_zip.open(f"{sample}_x.png", "w") as f:
            Image.fromarray(x_img).save(f, "PNG")
        with out_zip.open(f"{sample}_y.png", "w") as f:
            Image.fromarray(y_img.astype(np.uint8)).save(f, "PNG")
    out_zip.close()


@click.command()
@click.argument("leftimg8bit_trainvaltest_zip_path", type=click.Path(readable=True))
@click.argument("gtfine_trainvaltest_zip_path", type=click.Path(readable=True))
@click.option("--downsample", type=int, default=2)
@click.option("--out_path", type=click.Path(), default=None,
              help="defaults to the configured cityscapes path")
def convert(leftimg8bit_trainvaltest_zip_path, gtfine_trainvaltest_zip_path,
            downsample, out_path):
    if out_path is None:
        from cutmix_seg_tpu_torch.data import settings

        out_path = settings.get_data_path("cityscapes", exists=False)
    print(f"Writing data to {out_path}")
    convert_cityscapes(leftimg8bit_trainvaltest_zip_path,
                       gtfine_trainvaltest_zip_path, out_path, downsample)


if __name__ == "__main__":
    convert()
