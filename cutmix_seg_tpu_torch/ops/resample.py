"""Affine grid sampling with torch ``grid_sample`` semantics, NHWC (port of
``grid_sample_affine`` in cutmix_seg_tpu.ops.resample).

aug_mt warps the teacher's logits, probabilities and valid mask from one
crop of an image into the other crop's frame with the pair's relative
transform (reference: train_seg_semisup_aug_mt.py:302-312, which calls
``F.grid_sample``). The semantics are ``F.grid_sample(img,
F.affine_grid(theta, size, align_corners=True), align_corners=True,
padding_mode='zeros')``; the arithmetic is the JAX function's, step by step:

* the output grid is ``linspace(-1, 1)`` as XLA computes it inside a jitted
  program (``start * (1 - step) + stop * step`` with ``step = i * (1/div)``),
  not ``torch.linspace``, which differs in the last bit on most widths;
* source pixel coordinates are ``(g + 1) * ((size - 1) / 2)``, where
  ``grid_sample`` computes ``(g + 1) / 2 * (size - 1)``;
* nearest rounds ``floor(x + 0.5)`` (half up), where ``grid_sample`` rounds
  half to even: the two differ at exact half-pixel coordinates.

So the port keeps the JAX gathers instead of calling ``F.grid_sample``: its
bilinear output agrees with the JAX function to float32 rounding of the
same operations. The rest of the JAX module (``warp_affine``,
``resize_*``) waits until a path of the port needs it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cutmix_seg_tpu_torch.aug.device import _gather_nhwc


def _grid_linspace(n: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` in float32 as a jitted XLA program
    computes it."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    div = n - 1
    # a Python scalar enters the product as float32, as XLA's reciprocal
    # does, and makes no host-to-device copy (which would wait for the card)
    step = torch.arange(div, dtype=torch.float32, device=device) * (1.0 / div)
    out = step - (1.0 - step)  # -1 * (1 - step) + 1 * step, exactly
    return torch.cat([out, torch.ones(1, device=device)])


def _taps(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img[n, yi, xi, :], 0 where the tap lies outside the image."""
    _, h, w, _ = img.shape
    vals = _gather_nhwc(img, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
    inb = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
    return torch.where(inb, vals, 0.0)


def grid_sample_affine(img: torch.Tensor, theta: torch.Tensor,
                       out_hw: Tuple[int, int], mode: str = "bilinear") -> torch.Tensor:
    """Affine grid sampling, align_corners=True, zeros outside the image.

    :param img: (N, H, W, C) float
    :param theta: (N, 2, 3) grid-space matrices: output grid coordinates in
        [-1, 1] to input grid coordinates in [-1, 1]
    :param out_hw: output (H, W)
    :param mode: 'bilinear' or 'nearest'
    :return: (N, out_h, out_w, C) in float32 (or img's dtype if wider)
    """
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unknown mode {mode!r}")
    _, h, w, _ = img.shape
    oh, ow = out_hw
    ctype = torch.promote_types(img.dtype, torch.float32)
    theta = theta.to(ctype)
    gx = _grid_linspace(ow, img.device).to(ctype)[None, :].expand(oh, ow)
    gy = _grid_linspace(oh, img.device).to(ctype)[:, None].expand(oh, ow)

    ix = theta[:, 0, 0, None, None] * gx + theta[:, 0, 1, None, None] * gy \
        + theta[:, 0, 2, None, None]
    iy = theta[:, 1, 0, None, None] * gx + theta[:, 1, 1, None, None] * gy \
        + theta[:, 1, 2, None, None]
    sx = (ix + 1.0) * ((w - 1) / 2.0)
    sy = (iy + 1.0) * ((h - 1) / 2.0)

    imgf = img.to(ctype)
    if mode == "nearest":
        return _taps(imgf, torch.floor(sy + 0.5).int(), torch.floor(sx + 0.5).int())
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i, y0i = x0.int(), y0.int()
    top = _taps(imgf, y0i, x0i) * (1.0 - fx) + _taps(imgf, y0i, x0i + 1) * fx
    bot = _taps(imgf, y0i + 1, x0i) * (1.0 - fx) + _taps(imgf, y0i + 1, x0i + 1) * fx
    return top * (1.0 - fy) + bot * fy
