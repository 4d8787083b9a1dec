"""Dilated ResNet backbone (port of cutmix_seg_tpu.models.resnet), in its
two styles:

* ``style='deeplab2'``, the Hung et al. Caffe variant: stride on the first
  1x1 conv, every block of a stage uses the stage dilation, ceil-mode stem
  max-pool;
* ``style='torchvision'`` (ResNet V1.5): stride on the 3x3 conv, the first
  block of a dilated stage keeps the previous stage's dilation
  (``replace_stride_with_dilation``), floor-mode stem max-pool with padding 1.

A projection on each stage's first block; every conv is initialised
N(0, 0.01). Submodule names give the torchvision/Hung flat state-dict
layout: ``conv1``, ``bn1``, ``layerN.B.convK``, ``layerN.B.bnK``,
``layerN.B.downsample.0/1``. Tensors inside are NCHW (channels_last views of
the NHWC inputs).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from cutmix_seg_tpu_torch.models.common import (
    BatchNorm2d,
    Conv2d,
    max_pool_ceil,
    max_pool_floor,
)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 stride_on_conv2: bool = False):
        super().__init__()
        out = planes * self.expansion
        s1, s2 = (1, stride) if stride_on_conv2 else (stride, 1)
        self.conv1 = Conv2d(inplanes, planes, 1, stride=s1, bias=False, init="normal")
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=s2, padding=dilation,
                            dilation=dilation, bias=False, init="normal")
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False, init="normal")
        self.bn3 = BatchNorm2d(out)
        self.downsample = (
            nn.Sequential(Conv2d(inplanes, out, 1, stride=stride, bias=False, init="normal"),
                          BatchNorm2d(out))
            if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


# output stride 8: layer2 strides, layer3/layer4 dilate by 2/4
STRIDES = (1, 2, 1, 1)
DILATIONS = (1, 1, 2, 4)


class ResNetBackbone(nn.Module):
    """Stem + four bottleneck stages. ``taps`` maps NCHW input to the stem's
    BN output before and after its ReLU (``stem_prerelu``, ``stem``) and each
    stage's output (``layer1`` ..); ``features`` to the last stage's."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3),
                 strides: Sequence[int] = STRIDES, dilations: Sequence[int] = DILATIONS,
                 style: str = "deeplab2"):
        super().__init__()
        if style not in ("deeplab2", "torchvision"):
            raise ValueError(f"unknown ResNet style {style!r}")
        self.torchvision_style = style == "torchvision"
        self.spatial = None  # set_spatial: the stem pool's H split over ranks
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, init="normal")
        self.bn1 = BatchNorm2d(64)
        inplanes, prev_dilation = 64, 1
        for li, (n_blocks, planes, s, d) in enumerate(
                zip(layers, (64, 128, 256, 512), strides, dilations), start=1):
            blocks = []
            for bi in range(n_blocks):
                first = bi == 0
                blocks.append(Bottleneck(
                    inplanes, planes, stride=s if first else 1,
                    dilation=prev_dilation if (first and self.torchvision_style) else d,
                    has_downsample=first, stride_on_conv2=self.torchvision_style))
                inplanes = planes * Bottleneck.expansion
            prev_dilation = d
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.n_stages = len(layers)

    def taps(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {"stem_prerelu": self.bn1(self.conv1(x))}
        y = out["stem"] = F.relu(out["stem_prerelu"])
        if self.torchvision_style:
            y = max_pool_floor(y, 3, 2, 1, spatial=self.spatial)
        else:
            y = max_pool_ceil(y.permute(0, 2, 3, 1), window=3, stride=2,
                              padding=1, spatial=self.spatial).permute(0, 3, 1, 2)
        for li in range(1, self.n_stages + 1):
            y = out[f"layer{li}"] = getattr(self, f"layer{li}")(y)
        return out

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.taps(x)[f"layer{self.n_stages}"]
