"""Shared model plumbing (port of cutmix_seg_tpu.models.common): the
segmentation-model descriptor, frozen BN, ceil-mode pooling, align_corners
upsampling and path-rule parameter labels.

Models take and return NHWC tensors like the JAX package. Inside, an NHWC
tensor permuted to NCHW is a channels_last view, which cuDNN convolves
without a copy; the NHWC helpers below permute views, not data.
"""

from __future__ import annotations

import dataclasses
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
    mean/std:        per-channel input normalisation
    block_size:      (h, w) block multiple required for input padding
    param_label:     module -> {parameter name: 'pretrained'|'new'|'frozen'}
                     (pretrained gets 0.1x LR, frozen gets no updates)
    load_pretrained: optional fn(module) that fills in pretrained weights
    """

    name: str
    module: nn.Module
    mean: np.ndarray
    std: np.ndarray
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


class Conv2d(nn.Conv2d):
    """nn.Conv2d that keeps float32 parameters and computes in the input's
    dtype (the JAX package's ``dtype`` convention), with the JAX package's
    init: weights N(0, 0.01), bias 0."""

    def reset_parameters(self) -> None:
        init_conv(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


def init_conv(conv: nn.Conv2d, generator: Optional[torch.Generator] = None) -> None:
    with torch.no_grad():
        conv.weight.normal_(0.0, 0.01, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with frozen running statistics as a per-channel affine in
    the compute dtype (NCHW).

    g = weight * rsqrt(running_var + eps) and b = bias - running_mean * g are
    computed in float32 (channel-sized), then cast to the activation's dtype:
    an f32 g would promote a bf16 activation to f32 and double the traffic of
    every BN in the network. Names follow torch's BatchNorm2d, so torchvision
    state dicts load as they are.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
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
        g = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * g
        return torch.addcmul(b.to(x.dtype)[:, None, None], x,
                             g.to(x.dtype)[:, None, None])


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every conv (N(0, 0.01), bias 0) from ``generator`` and
    every frozen BN to the identity, in module order."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            init_conv(m, generator)
        elif isinstance(m, FrozenBatchNorm2d):
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
