"""What a trainer iteration feeds the step, worked out from the seed and the
raw files alone: which images each stream draws, their decoded pixels, the
geometric transform of each crop, the warp, the colour jitter and the
normalisation. Plain NumPy, PIL and PyTorch, written from the recipe's
definitions (the published data pipeline of the semi-supervised
segmentation code):

* splits and decodes: the data kind's reader (``benchmark/kinds/<kind>.py``);
* streams: each an endless reshuffled pass over its names
  (``RandomState(seed)``), its crop draws from ``RandomState(seed + 1)``;
  the labelled stream seeded ``base + 10``, unlabelled stream i
  ``base + 20 + 10 i``;
* crops: Hung et al.'s scale-crop (scale 0.5 + k / 10, k in 0..10, a
  window of crop / scale placed uniformly and resized to the crop; zeros
  outside the image), or the rotate-scale crop (log-uniform scale in
  [1 / s, s], rotation uniform in +-r, centre uniform; the image reflects
  at its border, labels read 255 outside), each followed by random flips;
  bilinear pixels (nearest for the rotate-scale crop of a labelled image,
  and for an unlabelled one with probability one half), nearest labels;
* colour: torchvision's ColorJitter in a random order per image, applied
  with probability 0.8, then RandomGrayscale(0.2), in float with clamps;
* normalisation: (x / 255 - mean * valid) / std, with valid the pixel's
  coverage of the image (1 for the reflecting crop).

Coordinates are computed in float64, pixels in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark import named

LUMA = (0.299, 0.587, 0.114)


# ------------------------------------------------------------------ splits

class Dataset:
    """Names, labelled and unlabelled indices, and the decode of a sample,
    read by the kind's reader, ``benchmark/kinds/<kind>.py``:
    ``Reader(path)`` with ``split(n_sup, split_path, split_seed)`` (names,
    labelled indices, unlabelled indices), ``image(name)`` and
    ``labels(name)``."""

    def __init__(self, kind: str, path: str, n_sup: int, split_path: Optional[str] = None,
                 split_seed: int = 12345):
        self.reader = named.module_of("benchmark.kinds", kind).Reader(path)
        self.names, self.sup, self.unsup = self.reader.split(n_sup, split_path, split_seed)

    def image(self, i: int) -> np.ndarray:
        arr = self.reader.image(self.names[i])
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        return arr[:, :, :3]

    def labels(self, i: int) -> np.ndarray:
        return self.reader.labels(self.names[i])


# ------------------------------------------------------------------ crops

@dataclasses.dataclass(frozen=True)
class Geometry:
    crop: Tuple[int, int]
    mode: str  # 'scale_hung' | 'rotate_scale'
    max_scale: float = 1.0
    rot_deg: float = 0.0
    hflip: bool = False
    vflip: bool = False
    hvflip: bool = False


def _t(tx, ty):
    return np.array([[1.0, 0.0, tx], [0.0, 1.0, ty], [0.0, 0.0, 1.0]])


def _s(sx, sy):
    return np.array([[sx, 0.0, 0.0], [0.0, sy, 0.0], [0.0, 0.0, 1.0]])


def _r(theta):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])


def _flip(fx, fy, fd, crop):
    """x / y mirror about the crop, then the axis swap."""
    m = _t(fx * (crop[1] - 1.0), fy * (crop[0] - 1.0)) @ _s(1 - 2 * fx, 1 - 2 * fy)
    if fd:
        m = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]) @ m
    return m


def _pad_offset(img_hw, need_hw):
    return (max(int(math.ceil(need_hw[0])) - img_hw[0], 0) // 2,
            max(int(math.ceil(need_hw[1])) - img_hw[1], 0) // 2)


def sample_crop(g: Geometry, img_hw, rng: np.random.RandomState, labelled: bool):
    """(3x3 source-to-crop matrix, bilinear?) of one image."""
    crop = np.array(g.crop, dtype=np.float64)
    bilinear = True
    if g.mode == "scale_hung":
        f = 0.5 + rng.randint(0, 11, size=(1,)) / 10.0
        sc = np.round(crop / np.repeat(f, 2)).astype(int)
        oh, ow = _pad_offset(img_hw, sc)
        extra = np.array([max(img_hw[0], sc[0]) - sc[0], max(img_hw[1], sc[1]) - sc[1]],
                         dtype=np.float64)
        pos = np.round(extra * rng.uniform(0.0, 1.0, size=(2,))).astype(int)
        oy, ox = pos[0] - oh, pos[1] - ow
        sf = crop / sc
        m = _t((sf[1] - 1.0) * 0.5, (sf[0] - 1.0) * 0.5) @ _s(sf[1], sf[0]) @ _t(-ox, -oy)
    elif g.mode == "rotate_scale":
        log_max = math.log(g.max_scale)
        s = float(np.exp(rng.uniform(-log_max, log_max, size=(1,)))[0])
        rot = float(rng.uniform(-math.radians(g.rot_deg), math.radians(g.rot_deg), size=(1,))[0])
        sc = crop / s
        img = np.array(img_hw, dtype=np.float64)
        centre = np.maximum(img - sc, 0.0) * rng.uniform(0.0, 1.0, size=(2,)) \
            + np.minimum(sc, img) * 0.5
        m = _t(crop[1] * 0.5, crop[0] * 0.5) @ _r(rot) @ _s(s, s) @ _t(-centre[1], -centre[0])
        bilinear = False if labelled else bool(rng.choice([0, 1]))
    else:
        raise ValueError(f"unknown crop mode {g.mode!r}")
    if g.hflip or g.vflip or g.hvflip:
        f = (rng.binomial(1, 0.5, size=(3,)) != 0) & np.array([g.hflip, g.vflip, g.hvflip])
        m = _flip(float(f[0]), float(f[1]), bool(f[2]), g.crop) @ m
    return m, bilinear


class Stream:
    """One loader stream: its images in order and their crop draws."""

    def __init__(self, indices: Sequence[int], batch: int, seed: int):
        self.indices = np.asarray(indices)
        self.batch = batch
        self.order_rng = np.random.RandomState(seed)
        self.crop_rng = np.random.RandomState(seed + 1)
        self.order = self.order_rng.permutation(len(self.indices))
        self.pos = 0

    def take(self) -> np.ndarray:
        out, n = [], self.batch
        while n > 0:
            if self.pos == len(self.order):
                self.order = self.order_rng.permutation(len(self.indices))
                self.pos = 0
            k = min(n, len(self.order) - self.pos)
            out.append(self.indices[self.order[self.pos:self.pos + k]])
            self.pos += k
            n -= k
        return np.concatenate(out)


# ------------------------------------------------------------------ pixels

def _reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    period = max(2 * (n - 1), 1)
    c = torch.remainder(torch.abs(i), period)
    return torch.where(c >= n, period - c, c)


def warp(img: np.ndarray, lab: Optional[np.ndarray], m: np.ndarray, bilinear: bool,
         crop: Tuple[int, int], reflect: bool, device):
    """One image to its crop: (pixels (H, W, 3) float32 in [0, 255], valid
    (H, W, 1), labels (H, W) int64 or None)."""
    h, w = img.shape[:2]
    inv = np.linalg.inv(m)
    ys = torch.arange(crop[0], dtype=torch.float64, device=device)[:, None]
    xs = torch.arange(crop[1], dtype=torch.float64, device=device)[None, :]
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    src = torch.from_numpy(np.ascontiguousarray(img)).to(device).float()

    def tap(yi, xi):
        if reflect:
            return src[_reflect101(yi, h), _reflect101(xi, w)]
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = src[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(inside[..., None], v, 0.0)

    yn = torch.floor(sy + 0.5).long()
    xn = torch.floor(sx + 0.5).long()
    if bilinear:
        y0, x0 = torch.floor(sy), torch.floor(sx)
        fy, fx = (sy - y0).float()[..., None], (sx - x0).float()[..., None]
        y0, x0 = y0.long(), x0.long()
        pix = (tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx) * (1 - fy) \
            + (tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx) * fy
        cx = torch.clamp(1.0 - torch.maximum(-sx, sx - (w - 1.0)), 0.0, 1.0)
        cy = torch.clamp(1.0 - torch.maximum(-sy, sy - (h - 1.0)), 0.0, 1.0)
        valid = (cx * cy).float()[..., None]
    else:
        pix = tap(yn, xn)
        valid = ((yn >= 0) & (yn < h) & (xn >= 0) & (xn < w)).float()[..., None]
    labels = None
    if lab is not None:
        lsrc = torch.from_numpy(np.ascontiguousarray(lab)).to(device)
        inside = (yn >= 0) & (yn < h) & (xn >= 0) & (xn < w)
        labels = torch.where(inside, lsrc[yn.clamp(0, h - 1), xn.clamp(0, w - 1)], 255)
    return pix, valid, labels


def draw_colour(gen: torch.Generator, n: int, c: dict) -> dict:
    """Per-image jitter draws, in the order the recipe's pipeline makes
    them from its colour generator."""
    dev = gen.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    out = {"b": uniform(max(0.0, 1.0 - c["brightness"]), 1.0 + c["brightness"]),
           "c": uniform(max(0.0, 1.0 - c["contrast"]), 1.0 + c["contrast"]),
           "s": uniform(max(0.0, 1.0 - c["saturation"]), 1.0 + c["saturation"]),
           "h": uniform(-c["hue"], c["hue"])}
    out["order"] = torch.argsort(torch.rand(n, 4, generator=gen, device=dev), dim=1)
    out["apply"] = torch.rand(n, generator=gen, device=dev) < c["prob"]
    out["grey"] = torch.rand(n, generator=gen, device=dev) < c["greyscale_prob"]
    return out


def _luma(x):
    return LUMA[0] * x[..., 0:1] + LUMA[1] * x[..., 1:2] + LUMA[2] * x[..., 2:3]


def _hue_shift(x: torch.Tensor, shift: float) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx, mn = x.amax(dim=-1), x.amin(dim=-1)
    d = mx - mn
    s = torch.where(mx > 0, d / mx.clamp_min(1e-12), 0.0)
    dz = d.clamp_min(1e-12)
    rc, gc, bc = (mx - r) / dz, (mx - g) / dz, (mx - b) / dz
    hh = torch.where(mx == r, bc - gc, torch.where(mx == g, 2.0 + rc - bc, 4.0 + gc - rc))
    hh = torch.where(d > 0, torch.remainder(hh / 6.0, 1.0), 0.0)
    hh = torch.remainder(hh + shift, 1.0)
    sector = torch.floor(hh * 6.0)
    f = hh * 6.0 - sector
    v = mx
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    k = torch.remainder(sector, 6).long()
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = torch.zeros_like(x)
    for i, (rr, gg, bb) in enumerate(table):
        sel = (k == i)[..., None]
        out = torch.where(sel, torch.stack([rr, gg, bb], dim=-1), out)
    return out


def jitter(img01: torch.Tensor, d: dict, i: int) -> torch.Tensor:
    """Image i of the batch (H, W, 3) in [0, 1], jittered by draw i."""
    x = img01
    for op in d["order"][i].tolist():
        if op == 0:
            x = (x * d["b"][i]).clamp(0.0, 1.0)
        elif op == 1:
            mean = _luma(x).mean()
            x = (mean + (x - mean) * d["c"][i]).clamp(0.0, 1.0)
        elif op == 2:
            grey = _luma(x)
            x = (grey + (x - grey) * d["s"][i]).clamp(0.0, 1.0)
        else:
            x = _hue_shift(x, d["h"][i])
    if not bool(d["apply"][i]):
        x = img01
    if bool(d["grey"][i]):
        x = _luma(x).expand_as(x)
    return x


def augment(ds: Dataset, indices, crops, g: Geometry, mean, std, labelled: bool,
            colour: Optional[dict], device) -> Dict[str, torch.Tensor]:
    """A batch's crops: 'image', 'mask' (valid), and 'labels' (labelled) or
    'image_stu' (the jittered copy, when ``colour`` holds draws)."""
    reflect = g.mode == "rotate_scale"
    mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
    std = torch.as_tensor(std, dtype=torch.float32, device=device)
    out = {"image": [], "mask": [], "labels": [], "image_stu": []}
    for k, (i, (m, bilinear)) in enumerate(zip(indices, crops)):
        lab = ds.labels(int(i)) if labelled else None
        pix, valid, labels = warp(ds.image(int(i)), lab, m, bilinear, g.crop, reflect, device)
        alpha = 1.0 if reflect else valid
        x01 = pix / 255.0
        out["image"].append((x01 - mean * alpha) / std)
        out["mask"].append(valid)
        if labelled:
            out["labels"].append(labels)
        if colour is not None:
            out["image_stu"].append((jitter(x01, colour, k) - mean * alpha) / std)
    return {k: torch.stack(v) for k, v in out.items() if v}
