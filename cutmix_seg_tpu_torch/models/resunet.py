"""ResUNet: torchvision-style ResNet encoder + additive-skip U-Net decoder
(port of cutmix_seg_tpu.models.resunet).

Encoder strides (1, 2, 2, 2), no dilation. Skips: the stem's BN output
BEFORE its ReLU (r2), layer1 (r4), layer2 (r8), layer3 (r16); layer4 passes
through a 1x1 ``line0_conv`` (2048 -> 1024) into the first decoder block.
Inputs must be multiples of 32 (block size). The encoder's convs are
initialised N(0, 0.01), the decoder's by flax's default (lecun_normal).

Under ``parallel.spatial.set_spatial`` the image H axis is split over ranks
(the convs, the stem's floor pool, the nearest upsamples and the dropout
mask take and give this rank's rows; the additive skips are row-local).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from cutmix_seg_tpu_torch.models import weights
from cutmix_seg_tpu_torch.models.common import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    AddSkipUNet,
    Conv2d,
    SegModel,
    label_params_by_path,
)
from cutmix_seg_tpu_torch.models.resnet import ResNetBackbone


class ResUNet(AddSkipUNet):
    def __init__(self, num_classes: int, layers: Sequence[int] = (3, 4, 23, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNetBackbone(layers, strides=(1, 2, 2, 2), dilations=(1, 1, 1, 1),
                                       style="torchvision")
        self.line0_conv = Conv2d(2048, 1024, 1)
        self._build_decoder(1024, (512, 256, 64, 64), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H, W, num_classes) logits; H, W multiples of 32
        (under ``set_spatial``: this rank's rows of each)."""
        if self.spatial is not None:
            self.spatial.begin(self, x)
        taps = self.backbone.taps(x.to(self.dtype or x.dtype).permute(0, 3, 1, 2))
        skips = (taps["layer3"], taps["layer2"], taps["layer1"], taps["stem_prerelu"])
        return self.decode(self.line0_conv(taps["layer4"]), skips)


def _param_label_pretrained(module: nn.Module):
    # encoder pretrained (0.1x LR, its BN affine trains), the rest new
    return label_params_by_path(module, [("backbone", "pretrained")], default="new")


def _param_label_scratch(module: nn.Module):
    return label_params_by_path(module, [], default="new")


def _make(num_classes, layers, source, pretrained, dtype, name) -> SegModel:
    loader = None
    if pretrained:
        def loader(m):
            weights.load_resnet_backbone(m, source)
    return SegModel(
        name=name, module=ResUNet(num_classes, layers=layers, dtype=dtype),
        mean=np.asarray(IMAGENET_MEAN), std=np.asarray(IMAGENET_STD), block_size=(32, 32),
        param_label=_param_label_pretrained if pretrained else _param_label_scratch,
        load_pretrained=loader)


def resnet50unet_imagenet(num_classes: int, dtype=None, pretrained=True) -> SegModel:
    return _make(num_classes, (3, 4, 6, 3), "resnet50_imagenet", pretrained, dtype,
                 "resnet50unet_imagenet")


def resnet101unet_imagenet(num_classes: int, dtype=None, pretrained=True) -> SegModel:
    return _make(num_classes, (3, 4, 23, 3), "resnet101_imagenet", pretrained, dtype,
                 "resnet101unet_imagenet")
