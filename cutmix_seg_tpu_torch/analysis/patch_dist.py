"""Patch-distance analysis (paper Figures 1/2; port of
cutmix_seg_tpu.analysis.patch_dist).

The hot operation, the Euclidean distance from N query patches to every
same-size window of an image, is one batched convolution:

    ||P - Q||^2 = box_sum(P^2) + sum(Q^2) - 2 (P * Q)

where the cross term for all N patches is ``F.conv2d`` with the patch stack
(N, C, p, q) as the weight: a cross-correlation with no flip, as JAX's
``lax.conv_general_dilated``. Everything is float32, as in JAX (64-bit
inputs are rounded to float32 first). The cross term runs without TF32 by
default: ``p_sqr + q_sqr - 2 cross`` cancels for near matches, which are
the ones the study ranks.

Boundary detection and patch extraction stay NumPy; the box sums are an
integral image (a float32 double cumsum), and the neighbour maps pad with
``np.pad``'s 'symmetric' mode (the edge sample repeated), built from an
index map because ``F.pad``'s 'reflect' is reflect-101.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.nn import functional as F

#: query patches per convolution in ``sliding_distances``: bounds the
#: conv's output and workspace; the per-patch result does not depend on it
PATCH_CHUNK = 64


def neighbouring_pixels_class_change(y: np.ndarray):
    """Four (H, W) boolean maps: does the left/right/up/down neighbour have a
    different (non-ignore) class (reference: patch_dist.py:5-24)."""
    y_cen = y[1:-1, 1:-1]
    left = (y_cen != y[1:-1, :-2]) & (y[1:-1, :-2] != 255)
    right = (y_cen != y[1:-1, 2:]) & (y[1:-1, 2:] != 255)
    up = (y_cen != y[:-2, 1:-1]) & (y[:-2, 1:-1] != 255)
    down = (y_cen != y[2:, 1:-1]) & (y[2:, 1:-1] != 255)
    valid = y_cen != 255
    pad = lambda a: np.pad(valid & a, [[1, 1], [1, 1]], mode="constant")  # noqa: E731
    return pad(left), pad(right), pad(up), pad(down)


def boundary_pixels(y: np.ndarray) -> np.ndarray:
    left, right, up, down = neighbouring_pixels_class_change(y)
    return left | right | up | down


def extract_patch(image: np.ndarray, patch_hw, yx) -> np.ndarray:
    """Patch of ``patch_hw`` centred at (y, x) (reference: patch_dist.py:157-168)."""
    patch_hw = np.asarray(patch_hw)
    pad = (patch_hw - 1) // 2
    row, col = yx
    return image[row - pad[0]: row + pad[0] + 1,
                 col - pad[1]: col + pad[1] + 1, ...]


def as_f32(x, device) -> torch.Tensor:
    """``x`` (numpy or tensor, any float dtype) as float32 on ``device``."""
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def _symmetric_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source index of each position of an axis of length n padded in
    'symmetric' mode: the signal mirrored about its edges, edge sample
    included, repeating for pads longer than n."""
    i = torch.arange(-before, n + after, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def symmetric_pad(x: torch.Tensor, pads) -> torch.Tensor:
    """``np.pad(x, pads, mode='symmetric')`` over the leading axes of ``x``
    (one (before, after) pair per padded axis)."""
    for axis, (before, after) in enumerate(pads):
        if before or after:
            x = x.index_select(axis, _symmetric_index(x.shape[axis], before, after, x.device))
    return x


def box_sum(x: torch.Tensor, box_hw) -> torch.Tensor:
    """Sliding-window box sum via integral image: (H+1-bh, W+1-bw)."""
    s = torch.cumsum(torch.cumsum(x, dim=1), dim=0)
    s = F.pad(s, (1, 0, 1, 0))
    bh, bw = box_hw
    return s[bh:, bw:] - s[:-bh, bw:] - s[bh:, :-bw] + s[:-bh, :-bw]


def neighbouring_patch_distance_maps(x: torch.Tensor, patch_hw):
    """Per-pixel Euclidean distances between the patch centred on each pixel
    and the patches centred on its 4 neighbours (reference:
    patch_dist.py:57-87). ``x``: (H, W, C) float32."""
    pad = (np.asarray(patch_hw) - 1) // 2
    x = symmetric_pad(x, [(pad[0] + 1, pad[0] + 1), (pad[1] + 1, pad[1] + 1)])
    cen = x[1:-1, 1:-1, :]

    def d(grad):
        return torch.sqrt(box_sum((grad ** 2).sum(dim=2), patch_hw))

    return (
        d(cen - x[1:-1, :-2, :]),
        d(x[1:-1, 2:, :] - cen),
        d(cen - x[:-2, 1:-1, :]),
        d(x[2:, 1:-1, :] - cen),
    )


def patch_average_distance_map(x, patch_hw, device) -> torch.Tensor:
    """The mean of the four neighbour distance maps of ``x`` ((H, W, C),
    numpy or tensor, cast to float32 on ``device``)."""
    l, r, u, d = neighbouring_patch_distance_maps(as_f32(x, device), patch_hw)
    return (l + r + u + d) * 0.25


@contextlib.contextmanager
def conv_tf32(allow: bool):
    """cuDNN convolutions with or without TF32 inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _sliding_distances(image: torch.Tensor, patches: torch.Tensor, tf32: bool = False,
                       chunk: int = PATCH_CHUNK) -> torch.Tensor:
    """(N, H, W) distances from N patches to every same-size window of a
    symmetric-padded image. image: already padded (H', W', C) float32;
    patches: (N, p, q, C) float32, on the image's device. The cross term
    runs ``chunk`` patches per convolution, without TF32 unless ``tf32``."""
    n, p, q, _ = patches.shape
    p_sqr = box_sum((image * image).sum(dim=2), (p, q))  # (H, W)
    q_sqr = (patches * patches).sum(dim=(1, 2, 3))  # (N,)
    img = image.permute(2, 0, 1)[None]  # (1, C, H', W')
    out = torch.empty((n,) + tuple(p_sqr.shape), dtype=torch.float32, device=image.device)
    with conv_tf32(tf32):
        for s in range(0, n, chunk):
            w = patches[s:s + chunk].permute(0, 3, 1, 2)  # (n_c, C, p, q)
            cross = F.conv2d(img, w)[0]  # (n_c, H, W), valid padding
            sqr = p_sqr[None] + q_sqr[s:s + chunk, None, None] - 2.0 * cross
            out[s:s + chunk] = torch.sqrt(torch.clamp_min(sqr, 0.0))
    return out


def sliding_window_distance_to_patches(image: np.ndarray, patches: np.ndarray,
                                       device) -> np.ndarray:
    """Distances from each query patch to all windows of ``image``: (N, H, W)
    float32 numpy, the cross term on ``device`` (reference: the per-patch FFT
    generator, patch_dist.py:130-154)."""
    patch_hw = np.asarray(patches.shape[1:3])
    pad = (patch_hw - 1) // 2
    padded = np.pad(image, [[pad[0], pad[0]], [pad[1], pad[1]], [0, 0]],
                    mode="symmetric")
    out = _sliding_distances(as_f32(padded, device), as_f32(patches, device))
    return out.cpu().numpy()


def sliding_window_distance_to_patch(image: np.ndarray, patch: np.ndarray,
                                     device) -> np.ndarray:
    return sliding_window_distance_to_patches(image, patch[None], device)[0]
