"""CutMix / Cutout box masks (port of cutmix_seg_tpu.masks.box_mask).

* ``sample_box_rects_np``: host-side rect sampling whose NumPy draw order
  matches the reference for scripted-RNG tests (a copy of the JAX package's).
* ``sample_box_rects``: the same distribution drawn on the device from a
  ``torch.Generator`` (the JAX version splits a PRNG key; the streams differ,
  so parity tests inject rects instead).
* ``rasterise_masks``: (N, B, 4) rects -> (N, H, W, 1) masks, boxes
  XOR-combined, coordinates resolved like NumPy slice indices.

Two reference quirks are kept on purpose (see the JAX module): with a fixed
aspect ratio boxes scale by 1/n_boxes rather than sqrt(1/n_boxes), and a
negative coordinate (possible with within_bounds=False) wraps by +size, so a
box crossing the top/left edge draws an empty slice instead of a clipped box.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BoxMaskConfig:
    prop_range: Tuple[float, float]
    n_boxes: int = 1
    random_aspect_ratio: bool = True
    prop_by_area: bool = True
    within_bounds: bool = True
    invert: bool = True


def _props_np(cfg: BoxMaskConfig, n_masks: int, rng: np.random.RandomState):
    """Per-box (y_prop, x_prop) fractional sizes in the reference's draw order."""
    lo, hi = cfg.prop_range
    if cfg.prop_by_area:
        mask_props = rng.uniform(lo, hi, size=(n_masks, cfg.n_boxes))
        zero = mask_props == 0.0
        fac = np.sqrt(1.0 / cfg.n_boxes)
        if cfg.random_aspect_ratio:
            y = np.exp(rng.uniform(0.0, 1.0, size=(n_masks, cfg.n_boxes)) * np.log(mask_props))
            x = mask_props / y
            y = y * fac
            x = x * fac
        else:
            # reference aliasing quirk: y and x are one shared array there, so
            # both in-place `*= fac` land on it -> scale 1/n_boxes
            y = x = np.sqrt(mask_props) * (fac * fac)
        y[zero] = 0
        x[zero] = 0
    else:
        fac = np.sqrt(1.0 / cfg.n_boxes)
        if cfg.random_aspect_ratio:
            y = rng.uniform(lo, hi, size=(n_masks, cfg.n_boxes)) * fac
            x = rng.uniform(lo, hi, size=(n_masks, cfg.n_boxes)) * fac
        else:
            # same aliasing quirk as above
            y = x = rng.uniform(lo, hi, size=(n_masks, cfg.n_boxes)) * (fac * fac)
    return y, x


def sample_box_rects_np(
    cfg: BoxMaskConfig,
    n_masks: int,
    mask_hw: Tuple[int, int],
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Sample box rectangles on the host: (N, n_boxes, 4) of (y0, x0, y1, x1)."""
    if rng is None:
        rng = np.random
    y_props, x_props = _props_np(cfg, n_masks, rng)
    sizes = np.round(
        np.stack([y_props, x_props], axis=2) * np.array(mask_hw)[None, None, :]
    )
    if cfg.within_bounds:
        positions = np.round(
            (np.array(mask_hw) - sizes) * rng.uniform(0.0, 1.0, size=sizes.shape)
        )
        rects = np.append(positions, positions + sizes, axis=2)
    else:
        centres = np.round(np.array(mask_hw) * rng.uniform(0.0, 1.0, size=sizes.shape))
        rects = np.append(centres - sizes * 0.5, centres + sizes * 0.5, axis=2)
    return rects.astype(np.float32)


def _sides(mask_hw: Tuple[int, int], n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(h, w, h, w, ...)[:n] on ``device``, filled there: no copy from the
    host, so a CUDA graph of the step can hold it."""
    sides = torch.full((n,), mask_hw[0], dtype=dtype, device=device)
    sides[1::2] = mask_hw[1]
    return sides


def _uniform(generator: torch.Generator, shape, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def sample_box_rects(
    cfg: BoxMaskConfig,
    generator: torch.Generator,
    n_masks: int,
    mask_hw: Tuple[int, int],
) -> torch.Tensor:
    """Rect sampling on the generator's device: (N, n_boxes, 4) float32
    (y0, x0, y1, x1), the distribution of ``sample_box_rects_np``."""
    lo, hi = cfg.prop_range
    shape = (n_masks, cfg.n_boxes)
    fac = (1.0 / cfg.n_boxes) ** 0.5
    if cfg.prop_by_area:
        props = _uniform(generator, shape, lo, hi)
        if cfg.random_aspect_ratio:
            u = _uniform(generator, shape)
            # exp(u * log p) needs p > 0; p == 0 is zeroed below like the
            # reference's zero-suppression
            safe = props.clamp_min(1e-20)
            y = torch.exp(u * torch.log(safe))
            x = safe / y
        else:
            # fixed aspect: the second fac lands below (aliasing quirk)
            y = x = torch.sqrt(props) * fac
        zero = props == 0.0
        y = torch.where(zero, 0.0, y * fac)
        x = torch.where(zero, 0.0, x * fac)
    else:
        if cfg.random_aspect_ratio:
            y = _uniform(generator, shape, lo, hi) * fac
            x = _uniform(generator, shape, lo, hi) * fac
        else:
            y = x = _uniform(generator, shape, lo, hi) * (fac * fac)

    hw = _sides(mask_hw, 2, torch.float32, generator.device)
    sizes = torch.round(torch.stack([y, x], dim=2) * hw)
    u_pos = _uniform(generator, shape + (2,))
    if cfg.within_bounds:
        pos = torch.round((hw - sizes) * u_pos)
        rects = torch.cat([pos, pos + sizes], dim=2)
    else:
        centres = torch.round(hw * u_pos)
        rects = torch.cat([centres - sizes * 0.5, centres + sizes * 0.5], dim=2)
    return rects.to(torch.float32)


def resolve_rects(rects: torch.Tensor, mask_hw: Tuple[int, int]) -> torch.Tensor:
    """float (N, B, 4) (y0, x0, y1, x1) -> int32 with NumPy-slice index
    resolution: truncate toward zero, negative += size, clamp to [0, size]."""
    ri = torch.trunc(rects).to(torch.int32)
    size = _sides(mask_hw, 4, torch.int32, rects.device)
    ri = torch.where(ri < 0, ri + size, ri)
    return torch.minimum(ri.clamp_min(0), size)


def rasterise_masks(
    rects: torch.Tensor,
    mask_hw: Tuple[int, int],
    invert: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Rasterise rects to (N, H, W, 1) masks; each box toggles (XORs) its
    interior, starting from 0 (invert) or 1."""
    h, w = mask_hw
    ri = resolve_rects(rects, mask_hw)[:, :, :, None, None]  # (N, B, 4, 1, 1)
    ys = torch.arange(h, dtype=torch.int32, device=rects.device)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=rects.device)[None, :]
    inside = ((ys >= ri[:, :, 0]) & (ys < ri[:, :, 2])
              & (xs >= ri[:, :, 1]) & (xs < ri[:, :, 3]))  # (N, B, H, W)
    toggles = inside.sum(dim=1) % 2
    base = 0 if invert else 1
    return torch.bitwise_xor(toggles, base).to(dtype)[..., None]


def sample_masks(
    cfg: BoxMaskConfig,
    generator: torch.Generator,
    n_masks: int,
    mask_hw: Tuple[int, int],
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """On-device sampling + rasterisation: (N, H, W, 1) masks."""
    rects = sample_box_rects(cfg, generator, n_masks, mask_hw)
    return rasterise_masks(rects, mask_hw, invert=cfg.invert, dtype=dtype)
