"""Host-side geometric augmentation parameter sampling.

A copy of cutmix_seg_tpu.aug.params. Device-side split of the reference's
OpenCV transform suite (reference: datapipe/seg_transforms_cv.py): the
*parameter draws* (cheap,
order-dependent, easiest to verify with scripted RNGs — the reference's own
test strategy) stay on the host in NumPy and produce one 2x3 pixel-space
matrix per sample mapping ORIGINAL-IMAGE coordinates -> CROP coordinates; the
*pixel work* (one fused warp per sample) runs on device
(cutmix_seg_tpu_torch.aug.device).

Each sampler mirrors the corresponding reference transform's draw semantics:

  * crop          — SegCVTransformRandomCrop (seg_transforms_cv.py:103-166):
                    pad-to-crop centring + uniform crop position.
  * crop_scale_hung — SegCVTransformRandomCropScaleHung (:169-303): scale
                    f = 0.5 + randint(0, 11)/10, crop of size crop/f resized
                    back to crop (Hung/Mittal scheme).
  * crop_rotate_scale — SegCVTransformRandomCropRotateScale (:306-449):
                    log-uniform scale in [1/max_scale, max_scale], rotation
                    U(-rot_mag, rot_mag), centre placement; image border
                    reflects (BORDER_REFLECT_101), labels pad 255.
  * flip          — SegCVTransformRandomFlip (:452-538): h/v/diagonal flips.

Pair mode (two correlated crops of one image, for augmentation-driven
consistency) mirrors the reference's transform_pair draw order, including the
Hung pair's shared-window centring (:232-303) and the rotate-scale pair's
constrain_rot_scale behaviour (:380-449).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from cutmix_seg_tpu_torch.aug import affine


@dataclasses.dataclass(frozen=True)
class GeomConfig:
    crop_size: Tuple[int, int]
    mode: str = "crop"  # 'crop' | 'crop_scale_hung' | 'crop_rotate_scale'
    crop_offset: Tuple[int, int] = (0, 0)
    uniform_scale: bool = True
    rot_mag_deg: float = 0.0
    max_scale: float = 1.0
    constrain_rot_scale: bool = True
    hflip: bool = False
    vflip: bool = False
    hvflip: bool = False

    @staticmethod
    def from_cli(crop_size, aug_scale_hung, aug_max_scale, aug_rot_mag,
                 aug_scale_non_uniform, aug_hflip, aug_vflip, aug_hvflip) -> "GeomConfig":
        """Reproduce the reference trainer's transform selection
        (train_seg_semisup_mask_mt.py:147-164)."""
        if aug_scale_hung:
            mode = "crop_scale_hung"
        elif aug_max_scale != 1.0 or aug_rot_mag != 0.0:
            mode = "crop_rotate_scale"
        else:
            mode = "crop"
        return GeomConfig(
            crop_size=tuple(crop_size),
            mode=mode,
            uniform_scale=not aug_scale_non_uniform,
            rot_mag_deg=aug_rot_mag,
            max_scale=aug_max_scale,
            hflip=aug_hflip,
            vflip=aug_vflip,
            hvflip=aug_hvflip,
        )


def _pad_offset(img_hw, needed_hw):
    """Centre offset the reference's pad step introduces: the image origin
    moves to (pad//2); crop coords are relative to the padded image."""
    ph = max(int(math.ceil(needed_hw[0])) - img_hw[0], 0)
    pw = max(int(math.ceil(needed_hw[1])) - img_hw[1], 0)
    return ph // 2, pw // 2


def _crop_single(cfg: GeomConfig, img_hw, rng) -> np.ndarray:
    ch, cw = cfg.crop_size
    oh, ow = _pad_offset(img_hw, (ch, cw))
    # effective padded size per reference: max(img, crop)
    ph = max(img_hw[0], ch)
    pw = max(img_hw[1], cw)
    extra = np.array([ph - ch, pw - cw], dtype=np.float64)
    pos = np.round(extra * rng.uniform(0.0, 1.0, size=(2,))).astype(int)
    # in original-image coords the crop origin is pos - pad_offset
    origin = pos - np.array([oh, ow])
    return affine.translation(np.array([[-origin[1], -origin[0]]], dtype=np.float64))[0]


def _crop_scale_hung_single(cfg: GeomConfig, img_hw, rng) -> np.ndarray:
    crop = np.array(cfg.crop_size)
    scale_dim = 1 if cfg.uniform_scale else 2
    f_scale = 0.5 + rng.randint(0, 11, size=(scale_dim,)) / 10.0
    if scale_dim == 1:
        f_scale = np.repeat(f_scale, 2)
    sc_size = np.round(crop / f_scale).astype(int)

    oh, ow = _pad_offset(img_hw, sc_size)
    ph = max(img_hw[0], sc_size[0])
    pw = max(img_hw[1], sc_size[1])
    extra = np.array([ph - sc_size[0], pw - sc_size[1]], dtype=np.float64)
    pos = np.round(extra * rng.uniform(0.0, 1.0, size=(2,))).astype(int)
    origin = pos - np.array([oh, ow])

    scale_factor_yx = crop / sc_size
    resize_xlat_yx = (scale_factor_yx - 1.0) * 0.5
    return affine.compose(
        affine.translation(resize_xlat_yx[None, ::-1]),
        affine.scale(scale_factor_yx[None, ::-1]),
        affine.translation(np.array([[-origin[1], -origin[0]]], dtype=np.float64)),
    )[0]


def _crop_rotate_scale_single(cfg: GeomConfig, img_hw, rng, has_labels: bool):
    crop = np.array(cfg.crop_size, dtype=np.float64)
    log_max = math.log(cfg.max_scale)
    rot_mag = math.radians(cfg.rot_mag_deg)
    if cfg.uniform_scale:
        s = np.exp(rng.uniform(-log_max, log_max, size=(1,)))
        scale_yx = np.repeat(s, 2)
    else:
        scale_yx = np.exp(rng.uniform(-log_max, log_max, size=(2,)))
    rot = rng.uniform(-rot_mag, rot_mag, size=(1,))

    sc_size = crop / scale_yx
    img = np.array(img_hw, dtype=np.float64)
    extra = np.maximum(img - sc_size, 0.0)
    centre = extra * rng.uniform(0.0, 1.0, size=(2,)) + np.minimum(sc_size, img) * 0.5

    m = affine.compose(
        affine.translation(crop[None, ::-1] * 0.5),
        affine.rotation(rot),
        affine.scale(scale_yx[None, ::-1]),
        affine.translation(-centre[None, ::-1]),
    )[0]
    if has_labels:
        interp = 0  # nearest (keeps image and labels consistent)
    else:
        interp = int(rng.choice([0, 1]))
    return m, interp


def _flip_single(cfg: GeomConfig, crop_hw, rng) -> np.ndarray:
    flags = rng.binomial(1, 0.5, size=(3,)) != 0
    flags = flags & np.array([cfg.hflip, cfg.vflip, cfg.hvflip])
    return affine.flip_xyd(flags[None], crop_hw)[0]


def sample_geom_single(
    cfg: GeomConfig, img_hw, rng, has_labels: bool
) -> Tuple[np.ndarray, int]:
    """Matrix + interp flag for one sample (single-sample transform chain)."""
    if cfg.mode == "crop":
        m, interp = _crop_single(cfg, img_hw, rng), 1
    elif cfg.mode == "crop_scale_hung":
        m, interp = _crop_scale_hung_single(cfg, img_hw, rng), 1
    elif cfg.mode == "crop_rotate_scale":
        m, interp = _crop_rotate_scale_single(cfg, img_hw, rng, has_labels)
    else:
        raise ValueError(f"unknown geom mode {cfg.mode!r}")
    if cfg.hflip or cfg.vflip or cfg.hvflip:
        m = affine.compose(
            _flip_single(cfg, cfg.crop_size, rng)[None], m[None]
        )[0]
    return m.astype(np.float32), interp


def sample_geom_pair(
    cfg: GeomConfig, img_hw, rng, has_labels: bool
):
    """Two correlated matrices for augmentation-driven consistency
    (reference pair modes; crops share a window so they overlap)."""
    crop = np.array(cfg.crop_size, dtype=np.float64)
    offs = np.array(cfg.crop_offset, dtype=np.float64)

    if cfg.mode == "crop":
        ch, cw = cfg.crop_size
        oh, ow = _pad_offset(img_hw, (ch, cw))
        ph, pw = max(img_hw[0], ch), max(img_hw[1], cw)
        extra = np.array([ph - ch, pw - cw], dtype=np.float64)
        pos0 = np.round(extra * rng.uniform(0.0, 1.0, size=(2,))).astype(int)
        pos1 = pos0 + np.round(offs * rng.uniform(-1.0, 1.0, size=(2,))).astype(int)
        pos1 = np.clip(pos1, [0, 0], extra.astype(int))
        ms, interps = [], []
        for pos in (pos0, pos1):
            origin = pos - np.array([oh, ow])
            ms.append(affine.translation(
                np.array([[-origin[1], -origin[0]]], dtype=np.float64))[0])
            interps.append(1)
    elif cfg.mode == "crop_scale_hung":
        scale_dim = 1 if cfg.uniform_scale else 2
        f_scale1 = 0.5 + rng.randint(0, 11, size=(scale_dim,)) / 10.0
        if scale_dim == 1:
            f_scale1 = np.repeat(f_scale1, 2)
        sc_size1 = np.round(crop / f_scale1).astype(int)
        max_sc = np.maximum(crop.astype(int), sc_size1)

        oh, ow = _pad_offset(img_hw, max_sc)
        ph, pw = max(img_hw[0], max_sc[0]), max(img_hw[1], max_sc[1])
        extra = np.array([ph - max_sc[0], pw - max_sc[1]], dtype=np.float64)
        pos0 = np.round(extra * rng.uniform(0.0, 1.0, size=(2,))).astype(int)
        pos1 = pos0 + np.round(offs * rng.uniform(-1.0, 1.0, size=(2,))).astype(int)
        pos1 = np.clip(pos1, [0, 0], extra.astype(int))
        centre0 = pos0 + max_sc * 0.5
        centre1 = pos1 + max_sc * 0.5
        pos0 = np.round(centre0 - crop * 0.5).astype(int)
        pos1 = np.round(centre1 - sc_size1 * 0.5).astype(int)

        origin0 = pos0 - np.array([oh, ow])
        m0 = affine.translation(
            np.array([[-origin0[1], -origin0[0]]], dtype=np.float64))[0]
        origin1 = pos1 - np.array([oh, ow])
        sf = crop / sc_size1
        rx = (sf - 1.0) * 0.5
        m1 = affine.compose(
            affine.translation(rx[None, ::-1]),
            affine.scale(sf[None, ::-1]),
            affine.translation(np.array([[-origin1[1], -origin1[0]]], dtype=np.float64)),
        )[0]
        ms, interps = [m0, m1], [1, 1]
    elif cfg.mode == "crop_rotate_scale":
        log_max = math.log(cfg.max_scale)
        rot_mag = math.radians(cfg.rot_mag_deg)
        if cfg.constrain_rot_scale:
            if cfg.uniform_scale:
                s = np.exp(rng.uniform(-log_max, log_max, size=(1, 1)))
                s = np.repeat(s, 2, axis=1)
            else:
                s = np.exp(rng.uniform(-log_max, log_max, size=(1, 2)))
            rots = rng.uniform(-rot_mag, rot_mag, size=(1,))
            scales = np.repeat(s, 2, axis=0)
            rots = np.repeat(rots, 2, axis=0)
        else:
            if cfg.uniform_scale:
                s = np.exp(rng.uniform(-log_max, log_max, size=(2, 1)))
                scales = np.repeat(s, 2, axis=1)
            else:
                scales = np.exp(rng.uniform(-log_max, log_max, size=(2, 2)))
            rots = rng.uniform(-rot_mag, rot_mag, size=(2,))

        img = np.array(img_hw, dtype=np.float64)
        sc_size = crop / scales.min(axis=0)
        crop_centre = np.minimum(sc_size, img) * 0.5
        extra = np.maximum(img - sc_size, 0.0)
        centre0 = extra * rng.uniform(0.0, 1.0, size=(2,)) + crop_centre
        offset1 = np.round(offs * rng.uniform(-1.0, 1.0, size=(2,)))
        centres = np.stack([centre0, centre0], axis=0)
        offsets1 = np.stack([np.zeros(2), offset1], axis=0)

        ms = affine.compose(
            affine.translation(np.tile(crop[None, ::-1] * 0.5, (2, 1))),
            affine.translation(offsets1[:, ::-1]),
            affine.rotation(rots),
            affine.scale(scales[:, ::-1]),
            affine.translation(-centres[:, ::-1]),
        )
        interp = 0 if has_labels else 1
        ms, interps = [ms[0], ms[1]], [interp, interp]
    else:
        raise ValueError(f"unknown geom mode {cfg.mode!r}")

    if cfg.hflip or cfg.vflip or cfg.hvflip:
        flags = rng.binomial(1, 0.5, size=(2, 3)) != 0
        flags = flags & np.array([[cfg.hflip, cfg.vflip, cfg.hvflip]])
        fm = affine.flip_xyd(flags, cfg.crop_size)
        ms = [affine.compose(fm[i][None], ms[i][None])[0] for i in range(2)]

    return (
        (ms[0].astype(np.float32), interps[0]),
        (ms[1].astype(np.float32), interps[1]),
    )
