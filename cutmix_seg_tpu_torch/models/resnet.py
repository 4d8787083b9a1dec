"""Dilated ResNet backbone, Hung et al. Caffe variant (port of
cutmix_seg_tpu.models.resnet, style='deeplab2').

Stride on the first 1x1 conv, every block of a stage uses the stage
dilation, a projection on each stage's first block, ceil-mode stem max-pool.
Submodule names give the torchvision/Hung flat state-dict layout:
``conv1``, ``bn1``, ``layerN.B.convK``, ``layerN.B.bnK``,
``layerN.B.downsample.0/1``. Tensors inside are NCHW (channels_last views of
the NHWC inputs).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from cutmix_seg_tpu_torch.models.common import (
    Conv2d,
    FrozenBatchNorm2d,
    max_pool_ceil,
)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, stride=stride, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out)
        self.downsample = (
            nn.Sequential(Conv2d(inplanes, out, 1, stride=stride, bias=False),
                          FrozenBatchNorm2d(out))
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
    """Stem + four bottleneck stages; ``features`` maps NCHW input to the
    final (N, 2048, H/8, W/8) features."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        inplanes = 64
        for li, (n_blocks, planes, s, d) in enumerate(
                zip(layers, (64, 128, 256, 512), STRIDES, DILATIONS), start=1):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes,
                                         stride=s if bi == 0 else 1,
                                         dilation=d, has_downsample=bi == 0))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.n_stages = len(layers)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = max_pool_ceil(y.permute(0, 2, 3, 1), window=3, stride=2,
                          padding=1).permute(0, 3, 1, 2)
        for li in range(1, self.n_stages + 1):
            y = getattr(self, f"layer{li}")(y)
        return y
