"""Fetch (or install from local files) the Hung et al. Pascal-aug name lists
(a copy of cutmix_seg_tpu.tools.download_pascal_aug_names).

    python -m cutmix_seg_tpu_torch.tools.download_pascal_aug_names [--from_dir DIR]

The reference downloads train_aug.txt / val.txt from the AdvSemiSeg repo into
VOC2012/ImageSets/SegmentationAug (reference: download_pascal_aug_names.py).
This tool does the same when the network is reachable and otherwise accepts
local copies via --from_dir (for machines without network access).
"""

from __future__ import annotations

import os
import shutil

import click

URLS = {
    "train_aug.txt": "https://raw.githubusercontent.com/hfslyc/AdvSemiSeg/master/dataset/voc_list/train_aug.txt",
    "val.txt": "https://raw.githubusercontent.com/hfslyc/AdvSemiSeg/master/dataset/voc_list/val.txt",
}


@click.command()
@click.option("--from_dir", type=click.Path(exists=True), default=None,
              help="copy the name lists from a local directory instead of "
                   "downloading")
def main(from_dir):
    from cutmix_seg_tpu_torch.data import settings

    pascal_path = settings.get_data_path("pascal_voc")
    out_dir = os.path.join(pascal_path, "ImageSets", "SegmentationAug")
    os.makedirs(out_dir, exist_ok=True)

    for filename, url in URLS.items():
        out_path = os.path.join(out_dir, filename)
        if from_dir is not None:
            shutil.copyfile(os.path.join(from_dir, filename), out_path)
            print(f"Copied {filename} -> {out_path}")
        else:
            import urllib.request

            print(f"Downloading {url}")
            urllib.request.urlretrieve(url, out_path)
            print(f"Saved {out_path}")


if __name__ == "__main__":
    main()
