"""DeepLab v2: dilated ResNet-101 + summed-ASPP classifier (port of
cutmix_seg_tpu.models.deeplab2).

* output stride 8 (layer3 d=2, layer4 d=4);
* ASPP classifier ``layer5``: four 3x3 convs at dilations 6/12/18/24 on the
  2048-channel features, of which only the first ``branches_used`` (default
  2, the reference's return-inside-loop quirk) are summed. The unused
  branches are not computed: their parameters exist (and load from the Hung
  checkpoint), take no gradient and pass through the EMA;
* bilinear align_corners upsampling of the logits to the input size.

``dtype`` is the compute dtype; parameters stay float32. Logits come back
NHWC in the compute dtype (the losses upcast inside).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from cutmix_seg_tpu_torch.models import weights
from cutmix_seg_tpu_torch.models.common import (
    HUNG_CAFFE_MEAN,
    HUNG_CAFFE_STD,
    IMAGENET_MEAN,
    IMAGENET_STD,
    Conv2d,
    SegModel,
    label_params_by_path,
    upsample_bilinear_align_corners,
)
from cutmix_seg_tpu_torch.models.resnet import ResNetBackbone


class ASPPSum(nn.Module):
    """Summed atrous spatial pyramid classifier (Hung/Chen DeepLab v2)."""

    def __init__(self, inplanes: int, num_classes: int,
                 dilations: Sequence[int] = (6, 12, 18, 24),
                 branches_used: int = 2):
        super().__init__()
        self.conv2d_list = nn.ModuleList(
            Conv2d(inplanes, num_classes, 3, padding=d, dilation=d, bias=True, init="normal")
            for d in dilations)
        self.branches_used = branches_used

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2d_list[0](x)
        for conv in self.conv2d_list[1:self.branches_used]:
            out = out + conv(x)
        return out


class DeepLab2(ResNetBackbone):
    def __init__(self, num_classes: int, layers: Sequence[int] = (3, 4, 23, 3),
                 aspp_branches_used: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(layers)
        self.layer5 = ASPPSum(512 * 4, num_classes,
                              branches_used=aspp_branches_used)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H, W, num_classes) logits."""
        in_hw = tuple(x.shape[1:3])
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        logits = self.layer5(self.features(x))
        return upsample_bilinear_align_corners(logits.permute(0, 2, 3, 1), in_hw)


def _param_label(module: nn.Module):
    """classifier -> new, any BN -> frozen, the rest -> pretrained. The JAX
    names every BN ``bn*`` (``downsample_bn`` included); here the projection
    BN is ``downsample.1``."""
    return label_params_by_path(
        module, [("layer5", "new"), ("bn", "frozen"), ("downsample.1", "frozen")],
        default="pretrained")


def _make(num_classes: int, mean, std, dtype=None, aspp_branches_used: int = 2,
          pretrained_source: Optional[str] = None,
          name: str = "deeplab2") -> SegModel:
    module = DeepLab2(num_classes=num_classes, dtype=dtype,
                      aspp_branches_used=aspp_branches_used)
    loader = None
    if pretrained_source is not None:
        def loader(m):
            weights.load_resnet_deeplab2(m, pretrained_source)
    return SegModel(name=name, module=module, mean=np.asarray(mean),
                    std=np.asarray(std), block_size=(1, 1),
                    param_label=_param_label, load_pretrained=loader)


def resnet101_deeplab_imagenet(num_classes: int, dtype=None, pretrained=True) -> SegModel:
    """ImageNet-pretrained variant."""
    return _make(num_classes, IMAGENET_MEAN, IMAGENET_STD, dtype,
                 pretrained_source="resnet101_imagenet" if pretrained else None,
                 name="resnet101_deeplab_imagenet")


def resnet101_deeplab_imagenet_mittal_std(num_classes: int, dtype=None,
                                          pretrained=True) -> SegModel:
    """ImageNet weights with Hung et al. Caffe-style normalisation stats."""
    return _make(num_classes, HUNG_CAFFE_MEAN, HUNG_CAFFE_STD, dtype,
                 pretrained_source="resnet101_imagenet" if pretrained else None,
                 name="resnet101_deeplab_imagenet_mittal_std")


def resnet101_deeplab_coco(num_classes: int, dtype=None, pretrained=True) -> SegModel:
    """COCO DeepLab checkpoint variant (the classifier loads only when the
    class count matches)."""
    return _make(num_classes, HUNG_CAFFE_MEAN, HUNG_CAFFE_STD, dtype,
                 pretrained_source="resnet101_deeplab_coco" if pretrained else None,
                 name="resnet101_deeplab_coco")
