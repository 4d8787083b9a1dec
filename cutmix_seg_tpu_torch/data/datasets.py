"""Dataset registry and deterministic sup/unsup/val split selection.

Bit-compatible with the reference's ``datasets.load_dataset``
(reference: datapipe/datasets.py:11-86): identical RandomState seeding and
call order for val_seed / split_seed, identical split_path (pickled
permutation) handling — the chosen label subset defines the task, so this
must match exactly.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np

from cutmix_seg_tpu_torch.data import sources


def load_dataset(dataset: str, n_val: int, val_seed: int, n_sup: int,
                 n_unsup: int, split_seed: int, split_path: Optional[str],
                 **source_kwargs):
    val_rng = np.random.RandomState(val_seed)

    if split_path is not None:
        with open(split_path, "rb") as f:
            trainval_perm = pickle.load(f)
    else:
        trainval_perm = None

    if dataset == "pascal":
        ds_src = sources.PascalVOCDataSource(
            n_val=n_val, val_rng=val_rng, trainval_perm=trainval_perm,
            **source_kwargs)
    elif dataset == "pascal_aug":
        ds_src = sources.PascalVOCDataSource(
            n_val=n_val, val_rng=val_rng, trainval_perm=trainval_perm,
            augmented=True, **source_kwargs)
    elif dataset == "camvid":
        ds_src = sources.CamVidDataSource(
            n_val=n_val, val_rng=val_rng, trainval_perm=trainval_perm,
            **source_kwargs)
    elif dataset == "cityscapes":
        ds_src = sources.CityscapesDataSource(
            n_val=n_val, val_rng=val_rng, trainval_perm=trainval_perm,
            **source_kwargs)
    elif dataset == "isic2017":
        ds_src = sources.ISIC2017DataSource(
            n_val=n_val, val_rng=val_rng, trainval_perm=trainval_perm,
            **source_kwargs)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")

    ds_tgt = ds_src
    val_ndx_tgt = val_ndx_src = ds_src.val_ndx
    test_ndx_tgt = ds_src.test_ndx

    # sup/unsup selection (reference: datasets.py:47-70, src==tgt branch)
    split_rng = np.random.RandomState(split_seed)
    if split_path is not None:
        train_perm = np.arange(len(ds_src.train_ndx))
    else:
        train_perm = split_rng.permutation(len(ds_src.train_ndx))

    if n_sup != -1:
        sup_ndx = ds_src.train_ndx[train_perm[:n_sup]]
        if n_unsup != -1:
            unsup_ndx = ds_src.train_ndx[train_perm[n_sup:n_sup + n_unsup]]
        else:
            unsup_ndx = ds_src.train_ndx[train_perm]
    else:
        sup_ndx = ds_src.train_ndx
        if n_unsup != -1:
            unsup_ndx = ds_src.train_ndx[train_perm[:n_unsup]]
        else:
            unsup_ndx = ds_src.train_ndx

    return dict(
        ds_src=ds_src,
        ds_tgt=ds_tgt,
        val_ndx_tgt=val_ndx_tgt,
        val_ndx_src=val_ndx_src,
        test_ndx_tgt=test_ndx_tgt,
        sup_ndx=sup_ndx,
        unsup_ndx=unsup_ndx,
    )
