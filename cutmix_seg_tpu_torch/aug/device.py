"""Augmentation on the device: one batched warp per sample family + colour
jitter + normalisation (port of cutmix_seg_tpu.aug.device).

The host ships fixed-size uint8 canvases (decoded images placed at the canvas
origin, zero-filled beyond their true extent) plus per-sample affine matrices
and true (h, w) extents. On the device:

  1. the image canvas is warped to the crop with the per-sample matrix —
     sampling coordinates outside the TRUE image extent reflect about the
     image edges (cv2 BORDER_REFLECT_101, the reference's crop-rotate-scale)
     or read 0 — with per-sample bilinear/nearest selection;
  2. labels are warped with nearest + constant 255 outside the extent;
  3. the valid mask is the bilinear coverage of the image-extent rectangle
     (computed, not warped);
  4. the student copy is optionally colour-jittered;
  5. images are normalised with the reference's alpha-channel semantics:
     out = (img/255 - mean * valid) / std.

The separable path (diagonal affines: 'crop' and 'crop_scale_hung' without
the diagonal flip) runs each warp as two batched matrix products. They run in
full float32 whatever the process's TF32 setting (``_exact_matmul``): TF32
would move the image crops by about 1e-3 relative.

Every function takes tensors on one device (CPU or CUDA) and returns tensors
on it; nothing here moves data between devices.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from cutmix_seg_tpu_torch.ops.colour import ColourParams, apply_colour_jitter


def _invert_nx2x3(m: torch.Tensor) -> torch.Tensor:
    """(N, 2, 3) affines -> their inverses, in the JAX version's operation
    order (the nearest-tap choice depends on the last ulp)."""
    a = m[:, :, :2]
    t = m[:, :, 2:]
    det = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    inv_a = torch.stack(
        [
            torch.stack([a[:, 1, 1], -a[:, 0, 1]], dim=-1),
            torch.stack([-a[:, 1, 0], a[:, 0, 0]], dim=-1),
        ],
        dim=-2,
    ) / det[:, None, None]
    # -(inv_a @ t), the 2-term dot written out
    inv_t = -(inv_a[:, :, 0:1] * t[:, 0:1, :] + inv_a[:, :, 1:2] * t[:, 1:2, :])
    return torch.cat([inv_a, inv_t], dim=2)


def _source_coords(m: torch.Tensor, out_hw: Tuple[int, int], n: int):
    inv = _invert_nx2x3(m.float())
    ys = torch.arange(out_hw[0], dtype=torch.float32, device=m.device)[:, None]
    xs = torch.arange(out_hw[1], dtype=torch.float32, device=m.device)[None, :]
    sx = inv[:, 0, 0, None, None] * xs + inv[:, 0, 1, None, None] * ys + inv[:, 0, 2, None, None]
    sy = inv[:, 1, 0, None, None] * xs + inv[:, 1, 1, None, None] * ys + inv[:, 1, 2, None, None]
    return sx.expand((n,) + tuple(out_hw)), sy.expand((n,) + tuple(out_hw))


def _reflect101_dyn(coord: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Reflect integer taps about [0, size) per sample (size: (N, 1, 1))."""
    period = torch.clamp_min(2 * (size - 1), 1)
    c = torch.remainder(torch.abs(coord), period)
    return torch.where(c >= size, period - c, c)


def _round_half_up(coord: torch.Tensor, canvas_n: int) -> torch.Tensor:
    """Nearest-tap rounding with the JAX version's scale-aware bias of 4
    ulps at the canvas magnitude (``aug/device.py::_round_half_up`` there
    says why): source coordinates that land exactly on half-integers round
    up in every program, other coordinates keep their nearest tap. The bias
    is a Python float added to the float32 tensor, as JAX adds it."""
    return torch.floor(coord + (0.5 + canvas_n * (2.0 ** -21)))


def _gather_nhwc(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    n, h, w, c = img.shape
    flat = img.reshape(n, h * w, c)
    idx = (iy.long() * w + ix.long()).reshape(n, -1)
    out = torch.gather(flat, 1, idx[:, :, None].expand(-1, -1, c))
    return out.reshape(n, iy.shape[1], iy.shape[2], c)


def _coverage(sx: torch.Tensor, sy: torch.Tensor, sizes_wh: torch.Tensor) -> torch.Tensor:
    """Bilinear coverage in [0, 1] of the rect [0, w-1] x [0, h-1]: the value
    of bilinearly sampling an all-ones image of that extent with a constant-0
    border."""
    w = sizes_wh[:, 0][:, None, None]
    h = sizes_wh[:, 1][:, None, None]
    cx = torch.clamp(1.0 - torch.maximum(-sx, sx - (w - 1.0)), 0.0, 1.0)
    cy = torch.clamp(1.0 - torch.maximum(-sy, sy - (h - 1.0)), 0.0, 1.0)
    return (cx * cy)[..., None]


def warp_image_canvas(canvas: torch.Tensor, m: torch.Tensor, sizes_hw: torch.Tensor,
                      interp: torch.Tensor, out_hw: Tuple[int, int],
                      border: str = "constant"):
    """Warp uint8 image canvases to float crops in [0, 255].

    :param canvas: (N, CH, CW, 3) uint8, image at origin, zeros beyond extent
    :param m: (N, 2, 3) original-image px -> crop px
    :param sizes_hw: (N, 2) int true (h, w) extents
    :param interp: (N,) int; 0 nearest, 1 bilinear (per sample)
    :param out_hw: crop size
    :param border: 'constant' (taps outside the true extent read 0) or
        'reflect101' (taps reflect about the true extent)
    :return: (crop (N, oh, ow, 3) float32 in [0, 255], valid (N, oh, ow, 1))
    """
    n = canvas.shape[0]
    sx, sy = _source_coords(m, out_hw, n)
    h_i = sizes_hw[:, 0].int()[:, None, None]
    w_i = sizes_hw[:, 1].int()[:, None, None]
    img = canvas.float()

    def tap(yi, xi):
        if border == "reflect101":
            yr = _reflect101_dyn(yi, h_i).clamp(0, canvas.shape[1] - 1)
            xr = _reflect101_dyn(xi, w_i).clamp(0, canvas.shape[2] - 1)
            return _gather_nhwc(img, yr, xr)
        # constant 0 outside the true extent (taps past the canvas edge must
        # not replicate edge pixels)
        yc = yi.clamp(0, canvas.shape[1] - 1)
        xc = xi.clamp(0, canvas.shape[2] - 1)
        vals = _gather_nhwc(img, yc, xc)
        inb = ((yi >= 0) & (yi < h_i) & (xi >= 0) & (xi < w_i))[..., None]
        return torch.where(inb, vals, 0.0)

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i = x0.int()
    y0i = y0.int()
    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    bil = (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy

    xn = _round_half_up(sx, canvas.shape[2]).int()
    yn = _round_half_up(sy, canvas.shape[1]).int()
    near = tap(yn, xn)

    use_bil = (interp.int() == 1)[:, None, None, None]
    crop = torch.where(use_bil, bil, near)

    sizes_wh = torch.stack([sizes_hw[:, 1], sizes_hw[:, 0]], dim=1).float()
    cov_bil = _coverage(sx, sy, sizes_wh)
    inb = ((xn >= 0) & (xn < w_i) & (yn >= 0) & (yn < h_i))[..., None].float()
    valid = torch.where(use_bil, cov_bil, inb)
    return crop, valid


def warp_labels_canvas(labels_canvas: torch.Tensor, m: torch.Tensor,
                       sizes_hw: torch.Tensor, out_hw: Tuple[int, int],
                       ignore_value: int = 255) -> torch.Tensor:
    """Nearest warp of integer label canvases (N, CH, CW); outside the true
    extent -> ``ignore_value``. Returns (N, oh, ow) int64."""
    n = labels_canvas.shape[0]
    sx, sy = _source_coords(m, out_hw, n)
    xn = _round_half_up(sx, labels_canvas.shape[2]).int()
    yn = _round_half_up(sy, labels_canvas.shape[1]).int()
    h_i = sizes_hw[:, 0].int()[:, None, None]
    w_i = sizes_hw[:, 1].int()[:, None, None]
    inb = (xn >= 0) & (xn < w_i) & (yn >= 0) & (yn < h_i)
    yc = yn.clamp(0, labels_canvas.shape[1] - 1)
    xc = xn.clamp(0, labels_canvas.shape[2] - 1)
    vals = _gather_nhwc(labels_canvas.long()[..., None], yc, xc)[..., 0]
    return torch.where(inb, vals, ignore_value)


def _axis_weights(coord: torch.Tensor, extent: torch.Tensor, canvas_n: int,
                  bilinear: bool):
    """Per-axis interpolation weights of a separable (axis-aligned) warp: a
    dense (N, canvas_n, O) matrix with at most two non-zeros per output
    column (the bilinear taps, or a one-hot at the nearest tap), zero beyond
    the true extent, and the per-axis coverage (N, O)."""
    w_iota = torch.arange(canvas_n, dtype=torch.float32, device=coord.device)[None, :, None]
    c = coord[:, None, :]
    ext = extent.float()[:, None, None]
    if bilinear:
        wt = torch.clamp(1.0 - torch.abs(c - w_iota), 0.0, 1.0)
    else:
        wt = (w_iota == _round_half_up(c, canvas_n)).float()
    wt = torch.where(w_iota < ext, wt, 0.0)
    ext1 = extent.float()[:, None]
    if bilinear:
        cov = torch.clamp(1.0 - torch.maximum(-coord, coord - (ext1 - 1.0)), 0.0, 1.0)
    else:
        r = _round_half_up(coord, canvas_n)
        cov = ((r >= 0) & (r < ext1)).float()
    return wt, cov


def _source_coords_1d(m: torch.Tensor, out_hw: Tuple[int, int]):
    """Per-axis source coords for diagonal matrices: sx(x), sy(y)."""
    inv = _invert_nx2x3(m.float())
    xs = torch.arange(out_hw[1], dtype=torch.float32, device=m.device)[None, :]
    ys = torch.arange(out_hw[0], dtype=torch.float32, device=m.device)[None, :]
    sx = inv[:, 0, 0, None] * xs + inv[:, 0, 2, None]
    sy = inv[:, 1, 1, None] * ys + inv[:, 1, 2, None]
    return sx, sy


@contextlib.contextmanager
def _exact_matmul():
    """float32 matrix products without TF32 inside the block, whatever the
    process set elsewhere (the JAX version's ``Precision.HIGHEST``)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def warp_image_canvas_separable(canvas: torch.Tensor, m: torch.Tensor,
                                sizes_hw: torch.Tensor, out_hw: Tuple[int, int]):
    """Axis-aligned (diagonal-affine) bilinear warp as two batched matrix
    products: a y-resample, then an x-resample. Border semantics are the
    gather path's 'constant'; results match ``warp_image_canvas`` to f32
    rounding."""
    n, chh, cww, c = canvas.shape
    sx, sy = _source_coords_1d(m, out_hw)
    wy, covy = _axis_weights(sy, sizes_hw[:, 0], chh, bilinear=True)
    wx, covx = _axis_weights(sx, sizes_hw[:, 1], cww, bilinear=True)
    img = canvas.float()
    with _exact_matmul():
        rows = torch.einsum("nhwc,nhy->nywc", img, wy)
        crop = torch.einsum("nywc,nwx->nyxc", rows, wx)
    valid = (covy[:, :, None] * covx[:, None, :])[..., None]
    return crop, valid


def warp_labels_canvas_separable(labels_canvas: torch.Tensor, m: torch.Tensor,
                                 sizes_hw: torch.Tensor, out_hw: Tuple[int, int],
                                 ignore_value: int = 255) -> torch.Tensor:
    """Nearest label warp for diagonal matrices through one-hot matrix
    products: each output selects one integer label (exact in float32 for
    labels up to 255); outside the true extent -> ``ignore_value``. Returns
    (N, oh, ow) int64, equal to ``warp_labels_canvas``."""
    sx, sy = _source_coords_1d(m, out_hw)
    chh, cww = labels_canvas.shape[1], labels_canvas.shape[2]
    wy, iny = _axis_weights(sy, sizes_hw[:, 0], chh, bilinear=False)
    wx, inx = _axis_weights(sx, sizes_hw[:, 1], cww, bilinear=False)
    lab = labels_canvas.float()
    with _exact_matmul():
        rows = torch.einsum("nhw,nhy->nyw", lab, wy)
        vals = torch.einsum("nyw,nwx->nyx", rows, wx)
    inb = (iny[:, :, None] * inx[:, None, :]) > 0.0
    return torch.where(inb, torch.round(vals).long(), ignore_value)


def _as_stat(v, device) -> torch.Tensor:
    """Per-channel statistics as float32 on ``device`` (no copy when they
    already are)."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def normalise(img_255: torch.Tensor, valid: torch.Tensor, mean, std) -> torch.Tensor:
    """Alpha-aware standardisation: (img/255 - mean * valid) / std."""
    mean = _as_stat(mean, img_255.device)[None, None, None, :]
    std = _as_stat(std, img_255.device)[None, None, None, :]
    return (img_255 / 255.0 - mean * valid) / std


def border_for_mode(geom_mode: str) -> str:
    """Reference border semantics per transform family: pad-with-zeros for
    crop / Hung crop-scale, reflect for crop-rotate-scale."""
    return "reflect101" if geom_mode == "crop_rotate_scale" else "constant"


def augment_batch(canvas: torch.Tensor, labels_canvas: Optional[torch.Tensor],
                  m: torch.Tensor, sizes_hw: torch.Tensor, interp: torch.Tensor,
                  mean, std, colour: Optional[ColourParams],
                  out_hw: Tuple[int, int], with_labels: bool,
                  ignore_value: int = 255, border: str = "constant",
                  separable: bool = False):
    """Warp + (optional) colour jitter + normalise.

    Returns a dict with 'image' (N, oh, ow, 3 float32), 'mask' (N, oh, ow, 1)
    and, with ``with_labels``, 'labels' (N, oh, ow int64). With ``colour``
    (the draws of ``ops.colour.sample_colour_params``) it also returns
    'image_stu', the colour-jittered copy (same geometry, other colour).

    With 'constant' borders the alpha trick applies (out-of-image pixels are
    exactly 0 after normalisation); with 'reflect101' the reflected content
    is standardised plainly and only the valid mask marks the outside.
    """
    if separable:
        # axis-aligned families sample bilinearly: interp is not read
        crop, valid = warp_image_canvas_separable(canvas, m, sizes_hw, out_hw)
    else:
        crop, valid = warp_image_canvas(canvas, m, sizes_hw, interp, out_hw, border)
    out = {"mask": valid}
    mean = _as_stat(mean, canvas.device)
    std = _as_stat(std, canvas.device)
    alpha = valid if border == "constant" else 1.0
    img01 = crop / 255.0
    if colour is not None:
        stu01 = apply_colour_jitter(img01, colour)
        out["image_stu"] = (stu01 - mean * alpha) / std
    out["image"] = (img01 - mean * alpha) / std
    if with_labels:
        if separable:
            out["labels"] = warp_labels_canvas_separable(
                labels_canvas, m, sizes_hw, out_hw, ignore_value)
        else:
            out["labels"] = warp_labels_canvas(
                labels_canvas, m, sizes_hw, out_hw, ignore_value)
    return out
