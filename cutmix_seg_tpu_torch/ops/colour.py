"""Colour augmentation on the device: torchvision-style ColorJitter +
RandomGrayscale (port of cutmix_seg_tpu.ops.colour).

The JAX ``colour_jitter`` draws its random numbers from a key and applies
them in one function. Here the two halves are separate, so that tests can
feed ``apply_colour_jitter`` the draws the JAX function makes:

  * ``sample_colour_params``: per-sample factors from a ``torch.Generator``:
    brightness/contrast/saturation ~ U(max(0, 1-f), 1+f), hue ~ U(-h, h), an
    independent permutation of the four ops, the RandomApply(p) choice and
    the RandomGrayscale(p) choice;
  * ``apply_colour_jitter``: the four ops in each sample's order, through a
    per-slot select (each slot evaluates the four candidate ops on the batch
    and picks per sample), then RandomApply and RandomGrayscale.

Arithmetic is float with clamps to [0, 1] (not torchvision's per-op uint8
rounding), with the ITU-R 601 luma weights (0.299, 0.587, 0.114).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ColourJitterConfig:
    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.1
    apply_prob: float = 0.8
    greyscale_prob: float = 0.2


@dataclasses.dataclass
class ColourParams:
    """Per-sample draws for a batch of n images, on the images' device.

    fb, fc, fs, fh: (n,) float32 brightness, contrast, saturation and hue
    factors; order: (n, 4) int64, a permutation of the ops (0 brightness,
    1 contrast, 2 saturation, 3 hue) per sample; apply, to_grey: (n,) bool.
    """

    fb: torch.Tensor
    fc: torch.Tensor
    fs: torch.Tensor
    fh: torch.Tensor
    order: torch.Tensor
    apply: torch.Tensor
    to_grey: torch.Tensor


def sample_colour_params(generator: torch.Generator, n: int,
                         cfg: ColourJitterConfig) -> ColourParams:
    """Draw the jitter parameters of n images on the generator's device."""
    dev = generator.device

    def uniform(lo: float, hi: float) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(n, generator=generator, device=dev)

    def factor(f: float) -> torch.Tensor:
        return uniform(max(0.0, 1.0 - f), 1.0 + f)

    fb = factor(cfg.brightness)
    fc = factor(cfg.contrast)
    fs = factor(cfg.saturation)
    fh = uniform(-cfg.hue, cfg.hue)
    # argsort of i.i.d. uniforms: a uniformly random permutation per sample
    order = torch.argsort(torch.rand(n, 4, generator=generator, device=dev), dim=1)
    apply = torch.rand(n, generator=generator, device=dev) < cfg.apply_prob
    to_grey = torch.rand(n, generator=generator, device=dev) < cfg.greyscale_prob
    return ColourParams(fb, fc, fs, fh, order, apply, to_grey)


def _luma(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0:1], img[..., 1:2], img[..., 2:3]
    return 0.299 * r + 0.587 * g + 0.114 * b


def _rgb_to_hsv(img: torch.Tensor):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    deltac = maxc - minc
    s = torch.where(maxc > 0, deltac / torch.clamp_min(maxc, 1e-12), 0.0)
    dz = torch.clamp_min(deltac, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    # Python-semantics modulo (torch.fmod differs for negative h)
    h = torch.where(deltac > 0, torch.remainder(h / 6.0, 1.0), 0.0)
    return h, s, v


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(vals):
        out = vals[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(i == k, vals[k], out)
        return out

    r = select([v, q, p, p, t, v])
    g = select([t, v, v, q, p, p])
    b = select([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def apply_colour_jitter(img: torch.Tensor, params: ColourParams) -> torch.Tensor:
    """ColorJitter (+RandomApply) then RandomGrayscale on (N, H, W, 3) float
    images in [0, 1], with the draws in ``params``."""
    fb = params.fb[:, None, None, None]
    fc = params.fc[:, None, None, None]
    fs = params.fs[:, None, None, None]
    fh = params.fh[:, None, None]

    def op_brightness(x):
        return torch.clamp(x * fb, 0.0, 1.0)

    def op_contrast(x):
        # torchvision: blend with the mean of the grayscale image
        mean = _luma(x).mean(dim=(1, 2, 3), keepdim=True)
        return torch.clamp(mean + (x - mean) * fc, 0.0, 1.0)

    def op_saturation(x):
        grey = _luma(x)
        return torch.clamp(grey + (x - grey) * fs, 0.0, 1.0)

    def op_hue(x):
        h, s, v = _rgb_to_hsv(torch.clamp(x, 0.0, 1.0))
        h = torch.remainder(h + fh, 1.0)
        return _hsv_to_rgb(h, s, v)

    ops = [op_brightness, op_contrast, op_saturation, op_hue]
    out = img
    for slot in range(4):
        sel = params.order[:, slot][:, None, None, None]
        cand = ops[0](out)
        for k in (1, 2, 3):
            cand = torch.where(sel == k, ops[k](out), cand)
        out = cand

    out = torch.where(params.apply[:, None, None, None], out, img)
    grey3 = _luma(out).expand(out.shape)
    return torch.where(params.to_grey[:, None, None, None], grey3, out)
