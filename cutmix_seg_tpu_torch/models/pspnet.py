"""PSPNet: dilated ResNet-101 encoder + Pyramid Pooling head (port of
cutmix_seg_tpu.models.pspnet).

Encoder at output stride 8 (torchvision dilation pattern); the PPM head
pools the 2048-channel features into (1, 2, 3, 6) bins with torch's
AdaptiveAvgPool2d bin edges ([floor(b*S/bins), ceil((b+1)*S/bins)), as the
JAX module computes them), each 1x1 conv -> BN -> ReLU -> half-pixel
bilinear resize back; concatenated with the features -> 3x3 conv-BN-ReLU
(512) -> Dropout(0.1) -> 1x1 classifier; logits resized (half-pixel) to the
input size. Head convs take He-normal init.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from cutmix_seg_tpu_torch.models import weights
from cutmix_seg_tpu_torch.models.common import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    BatchNorm2d,
    Conv2d,
    Dropout,
    SegModel,
    label_params_by_path,
    resize_bilinear_half_pixel,
)
from cutmix_seg_tpu_torch.models.resnet import ResNetBackbone


class PPMHead(nn.Module):
    def __init__(self, chn_in: int, num_classes: int,
                 pool_scales: Sequence[int] = (1, 2, 3, 6), features: int = 512):
        super().__init__()
        self.pool_scales = tuple(pool_scales)
        for i in range(len(pool_scales)):
            setattr(self, f"pool{i}_conv",
                    Conv2d(chn_in, features, 1, bias=False, init="he_normal"))
            setattr(self, f"pool{i}_bn", BatchNorm2d(features))
        self.conv_last = Conv2d(chn_in + len(pool_scales) * features, features, 3, padding=1,
                                bias=False, init="he_normal")
        self.bn_last = BatchNorm2d(features)
        self.dropout = Dropout(0.1)
        self.classifier = Conv2d(features, num_classes, 1, init="he_normal")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [x]
        for i, bins in enumerate(self.pool_scales):
            y = getattr(self, f"pool{i}_conv")(F.adaptive_avg_pool2d(x, bins))
            y = F.relu(getattr(self, f"pool{i}_bn")(y))
            branches.append(resize_bilinear_half_pixel(y, tuple(x.shape[2:])))
        y = F.relu(self.bn_last(self.conv_last(torch.cat(branches, dim=1))))
        return self.classifier(self.dropout(y))


class PSPNet(nn.Module):
    def __init__(self, num_classes: int, layers: Sequence[int] = (3, 4, 23, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNetBackbone(layers, strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
                                       style="torchvision")
        self.decoder = PPMHead(2048, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H, W, num_classes) logits."""
        in_hw = tuple(x.shape[1:3])
        feats = self.backbone.features(x.to(self.dtype or x.dtype).permute(0, 3, 1, 2))
        logits = resize_bilinear_half_pixel(self.decoder(feats), in_hw)
        return logits.permute(0, 2, 3, 1)


def _param_label(module: nn.Module):
    return label_params_by_path(module, [("backbone", "pretrained")], default="new")


def resnet101_pspnet_imagenet(num_classes: int, dtype=None, pretrained=True) -> SegModel:
    def loader(m):
        weights.load_resnet_backbone(m, "resnet101_imagenet")

    return SegModel(name="resnet101_pspnet_imagenet", module=PSPNet(num_classes, dtype=dtype),
                    mean=np.asarray(IMAGENET_MEAN), std=np.asarray(IMAGENET_STD),
                    block_size=(1, 1), param_label=_param_label,
                    load_pretrained=loader if pretrained else None)
