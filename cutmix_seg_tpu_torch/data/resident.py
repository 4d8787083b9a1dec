"""Device-resident training store (port of cutmix_seg_tpu.data.resident): the
decoded uint8 canvases (and labels) of the training indices are staged in
device memory once, and each iteration ships only row indices, true sizes
and the sampled matrices; the trainer gathers its canvases on the device
(``gather_part``: ``index_select`` on the leading axis) before the device
augmentation.

The host still samples the same geometry with the same RNG draws in the same
order (``HostBatchBuilder`` index mode), so a run with the store sees the
same sample indices and transforms as a streaming run. Labels warp bit-equal;
images agree to float32 rounding (~1e-5), because the streaming path
re-anchors its matrices to the transfer window while the resident path warps
from the full canvas.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

# the budget under which ``--data_on_device auto`` stages the store (uint8
# canvases + labels), the JAX package's, so both decide alike
DEFAULT_MAX_BYTES = 1 << 30


def resident_nbytes(source, n_images: int, with_labels: bool) -> int:
    ch, cw = source.canvas_hw
    per = ch * cw * 3 + (ch * cw if with_labels else 0) + 8
    return n_images * per


class ResidentDataset:
    """Decode once, keep on ``device``: the canvases of a subset of a
    source's indices, zero-filled beyond each image (labels 255-filled), as
    ``data`` {'canvas': (R, H, W, 3) uint8, 'labels': (R, H, W) uint8}."""

    def __init__(self, source, indices: Sequence[int], device, with_labels: bool = True):
        idx = np.unique(np.asarray(indices, np.int64))
        self.row_of = np.full(int(idx.max()) + 1, -1, np.int64)
        self.row_of[idx] = np.arange(len(idx))
        ch, cw = source.canvas_hw
        canvas = np.zeros((len(idx), ch, cw, 3), np.uint8)
        labels = np.full((len(idx), ch, cw), 255, np.uint8) if with_labels else None
        sizes = np.zeros((len(idx), 2), np.int32)
        for row, i in enumerate(idx):
            img = source.get_image(int(i))
            h, w = img.shape[:2]
            if h > ch or w > cw:
                raise ValueError(f"image {i} ({h}x{w}) exceeds canvas {(ch, cw)}")
            canvas[row, :h, :w] = img
            if with_labels:
                labels[row, :h, :w] = source.get_labels(int(i))
            sizes[row] = (h, w)
        self.sizes_host = sizes
        self.data = {"canvas": torch.from_numpy(canvas).to(device)}
        if with_labels:
            self.data["labels"] = torch.from_numpy(labels).to(device)

    def rows(self, indices: np.ndarray) -> np.ndarray:
        idx = np.asarray(indices, np.int64)
        oob = (idx < 0) | (idx >= len(self.row_of))
        rows = self.row_of[np.where(oob, 0, idx)]
        bad = oob | (rows < 0)
        if bad.any():
            raise KeyError(f"indices not staged on device: {idx[bad][:8]}")
        return rows.astype(np.int32)

    def sizes_of(self, indices: np.ndarray) -> np.ndarray:
        return self.sizes_host[self.rows(indices)]


def gather_part(data: Dict[str, torch.Tensor], part: Dict[str, torch.Tensor],
                with_labels: bool) -> Dict[str, torch.Tensor]:
    """One raw stream part from the store: ``part`` is an index-mode host
    batch on the device ({'idx', 'sizes', matrices}); its canvases (and, for
    the supervised stream, labels) are gathered from ``data``."""
    out = {k: v for k, v in part.items() if k != "idx"}
    idx = part["idx"].long()
    out["canvas"] = data["canvas"].index_select(0, idx)
    if with_labels:
        out["labels"] = data["labels"].index_select(0, idx)
    return out
