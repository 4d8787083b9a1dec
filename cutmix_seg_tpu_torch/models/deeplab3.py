"""DeepLab v3 and v3+ (port of cutmix_seg_tpu.models.deeplab3).

* backbone: torchvision-style ResNet-101 at output stride 8;
* ASPP: a 1x1 branch, three 3x3 branches at dilations 12/24/36, an
  image-pooling branch, concatenated -> 1x1 256 + BN + ReLU -> Dropout(0.5);
* v3 head: ASPP -> 3x3 256 BN ReLU -> 1x1 classifier;
* v3+ head: a 48-channel projection of layer1, the ASPP output resized
  (half-pixel bilinear) to its size, concatenated (304) -> two 3x3
  conv-BN-ReLU blocks -> 1x1 classifier;
* logits resized (half-pixel bilinear) to the input size.

Head convs take He-normal init; the backbone's N(0, 0.01). No BN affine is
frozen, not even under --freeze_bn: only the running statistics freeze.
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


class ConvBNReLU(nn.Module):
    def __init__(self, chn_in: int, chn_out: int, kernel: int = 3, dilation: int = 1):
        super().__init__()
        self.conv = Conv2d(chn_in, chn_out, kernel, padding=dilation if kernel == 3 else 0,
                           dilation=dilation, bias=False, init="he_normal")
        self.bn = BatchNorm2d(chn_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class ASPP(nn.Module):
    def __init__(self, chn_in: int, dilations: Sequence[int] = (12, 24, 36),
                 features: int = 256):
        super().__init__()
        self.b0 = ConvBNReLU(chn_in, features, kernel=1)
        for i, d in enumerate(dilations, start=1):
            setattr(self, f"b{i}", ConvBNReLU(chn_in, features, dilation=d))
        self.n_dilated = len(dilations)
        self.pool = ConvBNReLU(chn_in, features, kernel=1)
        self.project = ConvBNReLU((len(dilations) + 2) * features, features, kernel=1)
        self.dropout = Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [getattr(self, f"b{i}")(x) for i in range(self.n_dilated + 1)]
        gap = self.pool(x.mean(dim=(2, 3), keepdim=True))
        branches.append(gap.expand(-1, -1, *x.shape[2:]))
        return self.dropout(self.project(torch.cat(branches, dim=1)))


class _DeepLab3Base(nn.Module):
    def __init__(self, layers: Sequence[int], dtype: Optional[torch.dtype]):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNetBackbone(layers, strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
                                       style="torchvision")
        self.aspp = ASPP(2048)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H, W, num_classes) logits."""
        in_hw = tuple(x.shape[1:3])
        taps = self.backbone.taps(x.to(self.dtype or x.dtype).permute(0, 3, 1, 2))
        logits = self.classifier(self.head(taps))
        return resize_bilinear_half_pixel(logits, in_hw).permute(0, 2, 3, 1)


class DeepLabV3Plus(_DeepLab3Base):
    def __init__(self, num_classes: int, layers: Sequence[int] = (3, 4, 23, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__(layers, dtype)
        self.project = ConvBNReLU(256, 48, kernel=1)
        self.head0 = ConvBNReLU(48 + 256, 256)
        self.head1 = ConvBNReLU(256, 256)
        self.classifier = Conv2d(256, num_classes, 1, init="he_normal")

    def head(self, taps):
        low = self.project(taps["layer1"])
        y = resize_bilinear_half_pixel(self.aspp(taps["layer4"]), tuple(low.shape[2:]))
        return self.head1(self.head0(torch.cat([low, y], dim=1)))


class DeepLabV3(_DeepLab3Base):
    def __init__(self, num_classes: int, layers: Sequence[int] = (3, 4, 23, 3),
                 dtype: Optional[torch.dtype] = None):
        super().__init__(layers, dtype)
        self.head0 = ConvBNReLU(256, 256)
        self.classifier = Conv2d(256, num_classes, 1, init="he_normal")

    def head(self, taps):
        return self.head0(self.aspp(taps["layer4"]))


def _label_imagenet(module: nn.Module):
    # ImageNet pretraining: backbone pretrained, heads new
    return label_params_by_path(module, [("backbone", "pretrained")], default="new")


def _label_coco(module: nn.Module):
    # COCO pretraining: everything except the final classifier pretrained
    return label_params_by_path(module, [("classifier", "new")], default="pretrained")


def _make(name, module, label, source, pretrained) -> SegModel:
    def loader(m):
        weights.load_resnet_backbone(m, source)

    return SegModel(name=name, module=module, mean=np.asarray(IMAGENET_MEAN),
                    std=np.asarray(IMAGENET_STD), block_size=(1, 1), param_label=label,
                    load_pretrained=loader if pretrained else None)


def resnet101_deeplabv3plus_imagenet(num_classes: int, dtype=None, pretrained=True) -> SegModel:
    return _make("resnet101_deeplabv3plus_imagenet", DeepLabV3Plus(num_classes, dtype=dtype),
                 _label_imagenet, "resnet101_imagenet", pretrained)


def resnet101_deeplabv3_imagenet(num_classes: int, dtype=None, pretrained=True) -> SegModel:
    return _make("resnet101_deeplabv3_imagenet", DeepLabV3(num_classes, dtype=dtype),
                 _label_imagenet, "resnet101_imagenet", pretrained)


def resnet101_deeplabv3_coco(num_classes: int, dtype=None, pretrained=True) -> SegModel:
    return _make("resnet101_deeplabv3_coco", DeepLabV3(num_classes, dtype=dtype),
                 _label_coco, "resnet101_deeplabv3_coco", pretrained)
