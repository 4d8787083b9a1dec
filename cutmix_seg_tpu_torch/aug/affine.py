"""Batched 2x3 affine matrix algebra (host-side, NumPy); a copy of
cutmix_seg_tpu.aug.affine.

Re-derivation of the affine bookkeeping the reference keeps in
``datapipe/affine.py`` (reference: datapipe/affine.py:1-288). Matrices
act on (x, y) pixel coordinates in the OpenCV convention: the matrix maps
*source* coordinates to *destination* coordinates; warping an image samples the
source at ``inv(M) @ dst``.

These run on the host when composing per-sample transform matrices; the actual
pixel work happens on the device (see cutmix_seg_tpu_torch.aug.device).

Conventions:
  * All functions are batched: matrices are (N, 2, 3) float arrays.
  * ``grid`` space refers to the torch/JAX grid-sample convention where the
    sample domain is [-1, 1] with align_corners=True pixel-corner anchoring —
    kept for parity with the reference's consistency bookkeeping
    (reference: datapipe/affine.py:185-232 `cv_to_torch`).
"""

from __future__ import annotations

import numpy as np


def identity(n: int) -> np.ndarray:
    """N stacked 2x3 identity transforms."""
    m = np.zeros((n, 2, 3), dtype=np.float32)
    m[:, 0, 0] = 1.0
    m[:, 1, 1] = 1.0
    return m


def invert(m: np.ndarray) -> np.ndarray:
    """Invert N affine transforms given as (N,2,3)."""
    a = m[:, :, :2]
    t = m[:, :, 2:]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    inv_a = np.empty_like(a)
    inv_a[:, 0, 0] = a[:, 1, 1]
    inv_a[:, 1, 1] = a[:, 0, 0]
    inv_a[:, 0, 1] = -a[:, 0, 1]
    inv_a[:, 1, 0] = -a[:, 1, 0]
    inv_a = inv_a / det[:, None, None]
    inv_t = -np.matmul(inv_a, t)
    return np.concatenate([inv_a, inv_t], axis=2).astype(m.dtype)


def compose2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose two batches: result applies ``b`` first, then ``a`` (i.e. a @ b)."""
    a2, at = a[:, :, :2], a[:, :, 2:]
    b2, bt = b[:, :, :2], b[:, :, 2:]
    out2 = np.matmul(a2, b2)
    outt = at + np.matmul(a2, bt)
    return np.concatenate([out2, outt], axis=2)


def compose(*ms: np.ndarray) -> np.ndarray:
    """Compose any number of batched transforms, applied right-to-left."""
    out = ms[0]
    for m in ms[1:]:
        out = compose2(out, m)
    return out


def translation(txy: np.ndarray) -> np.ndarray:
    """(N,2) array of (x, y) translations -> (N,2,3) matrices."""
    txy = np.asarray(txy, dtype=np.float32)
    m = identity(len(txy))
    m[:, :, 2] = txy
    return m


def scale(sxy: np.ndarray) -> np.ndarray:
    """(N,2) array of (x, y) scale factors -> (N,2,3) matrices."""
    sxy = np.asarray(sxy, dtype=np.float32)
    m = np.zeros((len(sxy), 2, 3), dtype=np.float32)
    m[:, 0, 0] = sxy[:, 0]
    m[:, 1, 1] = sxy[:, 1]
    return m


def rotation(thetas: np.ndarray) -> np.ndarray:
    """(N,) rotation angles (radians, counter-clockwise with +y down) -> (N,2,3).

    Matches the reference's convention (datapipe/affine.py:98-120):
        [[ c,  s, 0],
         [-s,  c, 0]]
    """
    thetas = np.asarray(thetas, dtype=np.float64)
    c = np.cos(thetas).astype(np.float32)
    s = np.sin(thetas).astype(np.float32)
    m = np.zeros((len(thetas), 2, 3), dtype=np.float32)
    m[:, 0, 0] = c
    m[:, 1, 1] = c
    m[:, 0, 1] = s
    m[:, 1, 0] = -s
    return m


def flip_xyd(flags_xyd: np.ndarray, image_hw) -> np.ndarray:
    """Flip matrices from per-sample (x_flip, y_flip, diag_swap) boolean flags.

    ``x`` flips horizontally, ``y`` vertically, ``d`` swaps the two axes.
    A flip with negative scale is paired with a translation of (size - 1) so the
    image stays in-frame (reference: datapipe/affine.py:122-154).

    :param flags_xyd: (N, 3) boolean array
    :param image_hw: (height, width) of the image the flips apply to
    """
    flags_xyd = np.asarray(flags_xyd)
    if flags_xyd.ndim != 2 or flags_xyd.shape[1] != 3:
        raise ValueError(f"flags_xyd must be (N, 3), got {flags_xyd.shape}")
    n = len(flags_xyd)
    neg = flags_xyd[:, :2] * -2 + 1  # True -> -1, False -> 1
    # width-1 pairs with x, height-1 with y
    wh = np.array([image_hw[1], image_hw[0]], dtype=np.float64) - 1.0
    xlat = flags_xyd[:, :2] * wh

    swap = identity(n)
    d = flags_xyd[:, 2].astype(bool)
    swap[d] = swap[d][:, ::-1, :]

    return compose(swap, translation(xlat), scale(neg))


def centre(m: np.ndarray, size_hw) -> np.ndarray:
    """Re-anchor transforms so they act about the centre of a (H, W) image."""
    h, w = float(size_hw[0]), float(size_hw[1])
    n = len(m)
    to_origin = translation(np.tile([[-w * 0.5, -h * 0.5]], (n, 1)))
    out = compose(m, to_origin)
    out[:, 0, 2] += w * 0.5
    out[:, 1, 2] += h * 0.5
    return out


def cv_to_grid(m: np.ndarray, dst_hw, src_hw=None) -> np.ndarray:
    """Convert pixel-space (OpenCV-style) matrices to grid-sample matrices.

    Grid-sample (torch F.affine_grid / our ops.resample.grid_sample with
    align_corners=True) transforms *sample locations* in [-1, 1]; pixel-space
    warps transform the image. The conversion therefore inverts the matrix and
    conjugates by the [-1,1] <-> pixel coordinate maps
    (reference semantics: datapipe/affine.py:185-232).

    :param m: (N,2,3) pixel-space matrices
    :param dst_hw: output image size (H, W)
    :param src_hw: input image size (H, W); defaults to dst_hw
    """
    dsx = (dst_hw[1] - 1) / 2.0
    dsy = (dst_hw[0] - 1) / 2.0
    if src_hw is None:
        ssx, ssy = dsx, dsy
    else:
        ssx = (src_hw[1] - 1) / 2.0
        ssy = (src_hw[0] - 1) / 2.0

    n = len(m)
    m = invert(m)

    grid_to_px = identity(n)
    grid_to_px[:, 0, 0] = dsx
    grid_to_px[:, 1, 1] = dsy
    grid_to_px[:, 0, 2] = dsx
    grid_to_px[:, 1, 2] = dsy

    px_to_grid = identity(n)
    px_to_grid[:, 0, 0] = 1.0 / ssx
    px_to_grid[:, 1, 1] = 1.0 / ssy
    px_to_grid[:, 0, 2] = -1.0
    px_to_grid[:, 1, 2] = -1.0

    return compose(px_to_grid, m, grid_to_px)
