"""Shared model plumbing (port of cutmix_seg_tpu.models.common): the
segmentation-model descriptor, BatchNorm with flax's two modes, dropout from
an explicit generator, convolutions with the JAX modules' initialisers,
pooling and resizing, the additive-skip U-Net decoder and path-rule
parameter labels.

Models take and return NHWC tensors like the JAX package. Inside, an NHWC
tensor permuted to NCHW is a channels_last view, which cuDNN convolves
without a copy; the NHWC helpers below permute views, not data, and the
modules' own pieces (BN, dropout, resizes, decoder blocks) take NCHW.

A module's train/eval mode picks, as the JAX package's ``train`` flag does,
whether dropout draws masks and whether BN may use batch statistics; a
train-mode BN uses them only once ``set_freeze_bn(module, False)`` has been
called (``use_running_average = (not train) or freeze_bn``, flax's rule).
Dropout in train mode draws from the generator that
``set_dropout_generator`` gave it. The train steps set both on every call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

# Standard normalisation statistics.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
IMAGENET_STD = np.array([0.229, 0.224, 0.225])
# Hung et al. Caffe-style stats: BGR ImageNet means flipped to RGB, range 0..255
HUNG_CAFFE_MEAN = np.array([104.00698793, 116.66876762, 122.67891434])[::-1] / 255.0
HUNG_CAFFE_STD = np.array([1.0, 1.0, 1.0]) / 255.0


@dataclasses.dataclass
class SegModel:
    """A segmentation architecture plus its training metadata.

    module:          nn.Module; forward(x NHWC) -> (N, H, W, C) logits
    mean/std:        per-channel input normalisation (None: the dataset's)
    block_size:      (h, w) block multiple required for input padding
    param_label:     module -> {parameter name: 'pretrained'|'new'|'frozen'}
                     (pretrained gets 0.1x LR, frozen gets no updates)
    load_pretrained: optional fn(module) that fills in pretrained weights
    """

    name: str
    module: nn.Module
    mean: Optional[np.ndarray]
    std: Optional[np.ndarray]
    block_size: Tuple[int, int]
    param_label: Callable[[nn.Module], Dict[str, str]]
    load_pretrained: Optional[Callable[[nn.Module], None]] = None


def label_params_by_path(module: nn.Module, rules: Sequence[Tuple[str, str]],
                         default: str = "new") -> Dict[str, str]:
    """Label each parameter by the first (substring, label) rule matching its
    dotted name."""
    labels = {}
    for name, _ in module.named_parameters():
        labels[name] = next((lab for sub, lab in rules if sub in name), default)
    return labels


# kernel initialisers of the JAX modules: name -> flax variance_scaling scale
# (fan_in, truncated normal); 'normal' is the ResNet convs' N(0, 0.01)
_VARIANCE_SCALE = {"lecun_normal": 1.0, "he_normal": 2.0}
# std of a standard normal truncated to [-2, 2] (flax divides by it)
_TRUNC_STD = 0.87962566103423978


class Conv2d(nn.Conv2d):
    """nn.Conv2d that keeps float32 parameters and computes in the input's
    dtype (the JAX package's ``dtype`` convention). ``init`` names the JAX
    module's kernel initialiser: 'lecun_normal' (flax's default),
    'he_normal', or 'normal' (N(0, 0.01), the ResNet convs); biases start
    at 0."""

    def __init__(self, *args, init: str = "lecun_normal", **kwargs):
        if init != "normal" and init not in _VARIANCE_SCALE:
            raise ValueError(f"unknown conv initialiser {init!r}")
        self.init = init  # read by reset_parameters inside nn.Conv2d's init
        super().__init__(*args, **kwargs)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            if self.init == "normal":
                self.weight.normal_(0.0, 0.01, generator=generator)
            else:
                fan_in = self.weight[0].numel()
                std = math.sqrt(_VARIANCE_SCALE[self.init] / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class BatchNorm2d(nn.Module):
    """flax's BatchNorm (momentum 0.9, eps 1e-5) over NCHW, with torch's
    BatchNorm2d names (``weight``, ``bias``, ``running_mean``,
    ``running_var``; no ``num_batches_tracked``), so torchvision state dicts
    load as they are.

    Running-average mode (eval, or ``freeze``): at float32 flax's
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``; in a lower compute
    dtype the channel-sized g = weight * rsqrt(var + eps) and
    b = bias - mean * g are computed in float32 and the full-tensor affine
    runs in the activation's dtype, as the JAX package's _FastFrozenBN does.

    Training mode: x promoted to float32, mean E[x], biased variance
    max(E[x^2] - E[x]^2, 0) (flax's fast variance), normalised with eps and
    cast back to x's dtype. Unless ``track`` is off, the running statistics
    become 0.9 * running + 0.1 * batch, the BIASED variance included
    (torch's batch_norm would blend in the unbiased one).
    """

    momentum = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.freeze = True  # running averages in train mode too (set_freeze_bn)
        self.track = True   # a batch-statistics forward updates the running ones
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.freeze:
            return self._affine(x, self.running_mean, self.running_var)
        x32 = x.float()
        mean = x32.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        if self.track:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return self._affine(x32, mean, var).to(x.dtype)

    def _affine(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(var + self.eps) * self.weight
        if x.dtype == torch.float32:
            return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        b = self.bias - mean * mul
        return torch.addcmul(b.to(x.dtype)[:, None, None], x, mul.to(x.dtype)[:, None, None])


class Dropout(nn.Module):
    """flax's Dropout: in train mode ``where(keep, x / keep_prob, 0)`` in x's
    dtype (keep_prob rounded to that dtype, as JAX's weak typing does), the
    keep mask drawn by ``draw_keep`` with ``bernoulli_`` from the generator
    that ``set_dropout_generator`` gave the module."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def draw_keep(self, x: torch.Tensor) -> torch.Tensor:
        """Boolean keep mask of x's shape (and memory format)."""
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator: "
                               "set_dropout_generator(module, generator)")
        return torch.empty_like(x, dtype=torch.bool).bernoulli_(
            1.0 - self.rate, generator=self.generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = torch.tensor(1.0 - self.rate, dtype=x.dtype).item()
        return torch.where(self.draw_keep(x), x / keep_prob, 0.0)


def set_freeze_bn(module: nn.Module, freeze: bool) -> None:
    """Running-average BN in train mode too (``freeze``), or batch
    statistics (the JAX package's ``freeze_bn`` argument)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.freeze = freeze


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


@contextlib.contextmanager
def running_stats_kept(module: nn.Module):
    """Batch-statistics forwards inside the block leave the running
    statistics as they were (the JAX pi-model discards the teacher pass's
    updated statistics)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.track = False
    try:
        yield
    finally:
        for m in bns:
            m.track = True


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """``module`` in eval mode (running-average BN, no dropout) inside the
    block, its previous mode restored after."""
    was_training = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(was_training)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every conv by its own initialiser from ``generator``,
    and every BN to the identity, in module order."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.reset_parameters(generator)
        elif isinstance(m, BatchNorm2d):
            m.reset_parameters()


def max_pool_ceil(x: torch.Tensor, window: int, stride: int,
                  padding: int) -> torch.Tensor:
    """Max pool with ceil-mode output size (NHWC in and out).

    The JAX version pads symmetrically, then adds the right/bottom padding
    the ceil size needs; torch's ceil_mode also drops a last window that
    would start inside the right padding. Both agree unless that happens,
    so such a configuration raises instead of silently differing."""
    n, h, w, c = x.shape
    for s in (h, w):
        out = -(-(s + 2 * padding - window) // stride) + 1
        if (out - 1) * stride >= s + padding:
            raise ValueError(
                f"max_pool_ceil(window={window}, stride={stride}, "
                f"padding={padding}) at size {s}: torch drops a window the "
                "reference keeps")
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding,
                     ceil_mode=True)
    return y.permute(0, 2, 3, 1)


def upsample_bilinear_align_corners(x: torch.Tensor,
                                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True (NHWC in and out)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling (NCHW)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def resize_bilinear_half_pixel(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False, no
    antialiasing; NCHW): ``jax.image.resize(method='linear',
    antialias=False)``, whose edge samples renormalise onto the edge pixel
    as torch's clamped source index does."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


class AddSkipDecoderBlock(nn.Module):
    """U-Net decoder block shared by ResUNet and DenseUNet: nearest-2x
    upsample, additive skip, 3x3 conv (no bias), BN, ReLU (NCHW)."""

    def __init__(self, chn_in: int, chn_out: int):
        super().__init__()
        self.conv = Conv2d(chn_in, chn_out, 3, padding=1, bias=False)
        self.conv_bn = BatchNorm2d(chn_out)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest_2x(x) + skip
        return F.relu(self.conv_bn(self.conv(x)))


class AddSkipUNet(nn.Module):
    """The decoder and head of ResUNet and DenseUNet: four
    AddSkipDecoderBlocks (``decoder3`` .. ``decoder0``), then nearest-2x
    upsample, 3x3 conv to 64 (no bias), Dropout(0.3), BN, ReLU and a 1x1
    classifier. Subclasses build the encoder and call ``decode``."""

    def _build_decoder(self, chn_in: int, chn_outs: Sequence[int], num_classes: int):
        for name, chn_out in zip(("decoder3", "decoder2", "decoder1", "decoder0"), chn_outs):
            setattr(self, name, AddSkipDecoderBlock(chn_in, chn_out))
            chn_in = chn_out
        self.final_dec_conv = Conv2d(chn_in, 64, 3, padding=1, bias=False)
        self.final_dec_drop = Dropout(0.3)
        self.final_dec_bn = BatchNorm2d(64)
        self.final_clf = Conv2d(64, num_classes, 1)

    def decode(self, y: torch.Tensor, skips: Sequence[torch.Tensor]) -> torch.Tensor:
        """NCHW features at 1/32 and the four skips (1/16 .. 1/2) -> NHWC
        logits at the input size."""
        for name, skip in zip(("decoder3", "decoder2", "decoder1", "decoder0"), skips):
            y = getattr(self, name)(y, skip)
        y = self.final_dec_drop(self.final_dec_conv(upsample_nearest_2x(y)))
        logits = self.final_clf(F.relu(self.final_dec_bn(y)))
        return logits.permute(0, 2, 3, 1)
