"""DenseUNet-161: DenseNet-161 encoder + additive-skip decoder, the ISIC-2017
architecture (port of cutmix_seg_tpu.models.denseunet).

Encoder taps, each taken before the module that follows it: relu0 (96 ch,
1/2), denseblock1 (384, 1/4), denseblock2 (768, 1/8), denseblock3 (2112,
1/16); the features are norm5's output (2208, 1/32), ReLU'd by the decoder.
The denseblock3 tap passes through a 1x1 ``line0_conv`` (2112 -> 2208).
Decoder plan 2208 -> 768 -> 384 -> 96 -> 96, then the
upsample-conv-dropout-BN-ReLU head and a 1x1 classifier. Inputs must be
multiples of 32 (block size). Other ``block_config``s derive the same plan
from their tap widths (the JAX module fixes DenseNet-161's).

Submodule names follow torchvision's densenet161 (``features.conv0``,
``features.denseblockN.denselayerM.norm1`` ..), so its state dict loads by
name. Every conv takes flax's default initialiser (lecun_normal).

Under ``parallel.spatial.set_spatial`` the image H axis is split over ranks
(the 3x3 and 7x7 convs, the stem's floor pool, the transitions' average
pools, the nearest upsamples and the dropout mask take and give this rank's
rows; the 1x1 convs, the concatenations and the additive skips are
row-local).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from cutmix_seg_tpu_torch.models import weights
from cutmix_seg_tpu_torch.models.common import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    AddSkipUNet,
    BatchNorm2d,
    Conv2d,
    SegModel,
    avg_pool_floor,
    label_params_by_path,
    max_pool_floor,
)


class DenseLayer(nn.Module):
    def __init__(self, chn_in: int, growth_rate: int, bn_size: int = 4):
        super().__init__()
        self.norm1 = BatchNorm2d(chn_in)
        self.conv1 = Conv2d(chn_in, bn_size * growth_rate, 1, bias=False)
        self.norm2 = BatchNorm2d(bn_size * growth_rate)
        self.conv2 = Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, chn_in: int, chn_out: int):
        super().__init__()
        self.spatial = None  # set_spatial: the pool's rows over ranks
        self.norm = BatchNorm2d(chn_in)
        self.conv = Conv2d(chn_in, chn_out, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool_floor(self.conv(F.relu(self.norm(x))), 2, 2, self.spatial)


class DenseNetFeatures(nn.Module):
    """torchvision's densenet feature extractor, with taps (NCHW)."""

    def __init__(self, num_init_features: int = 96, growth_rate: int = 48,
                 block_config: Sequence[int] = (6, 12, 36, 24)):
        super().__init__()
        self.spatial = None  # set_spatial: the stem pool's rows over ranks
        self.conv0 = Conv2d(3, num_init_features, 7, stride=2, padding=3, bias=False)
        self.norm0 = BatchNorm2d(num_init_features)
        chn = num_init_features
        self.tap_channels = {"relu0": chn}
        self.n_blocks = len(block_config)
        for i, n_layers in enumerate(block_config, start=1):
            block = nn.Sequential()
            for j in range(n_layers):
                block.add_module(f"denselayer{j + 1}", DenseLayer(chn + j * growth_rate,
                                                                  growth_rate))
            setattr(self, f"denseblock{i}", block)
            chn += n_layers * growth_rate
            self.tap_channels[f"denseblock{i}"] = chn
            if i < self.n_blocks:
                setattr(self, f"transition{i}", Transition(chn, chn // 2))
                chn //= 2
        self.norm5 = BatchNorm2d(chn)
        self.out_channels = chn

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        taps = {"relu0": F.relu(self.norm0(self.conv0(x)))}
        x = max_pool_floor(taps["relu0"], 3, 2, 1, self.spatial)
        for i in range(1, self.n_blocks + 1):
            x = taps[f"denseblock{i}"] = getattr(self, f"denseblock{i}")(x)
            if i < self.n_blocks:
                x = getattr(self, f"transition{i}")(x)
        return self.norm5(x), taps


class DenseUNet(AddSkipUNet):
    def __init__(self, num_classes: int, block_config: Sequence[int] = (6, 12, 36, 24),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.features = DenseNetFeatures(block_config=block_config)
        tc = self.features.tap_channels
        c_out = self.features.out_channels
        self.line0_conv = Conv2d(tc["denseblock3"], c_out, 1)
        self._build_decoder(c_out, (tc["denseblock2"], tc["denseblock1"], tc["relu0"],
                                    tc["relu0"]), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H, W, num_classes) logits; H, W multiples of 32
        (under ``set_spatial``: this rank's rows of each)."""
        if self.spatial is not None:
            self.spatial.begin(self, x)
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        feats, taps = self.features(x)
        skips = (self.line0_conv(taps["denseblock3"]), taps["denseblock2"],
                 taps["denseblock1"], taps["relu0"])
        return self.decode(F.relu(feats), skips)


def _param_label_pretrained(module: nn.Module):
    return label_params_by_path(module, [("features", "pretrained")], default="new")


def _param_label_scratch(module: nn.Module):
    return label_params_by_path(module, [], default="new")


def densenet161unet(num_classes: int, dtype=None, pretrained=True) -> SegModel:
    """From-scratch variant: normalisation statistics from the dataset."""
    return SegModel(name="densenet161unet", module=DenseUNet(num_classes, dtype=dtype),
                    mean=None, std=None, block_size=(32, 32),
                    param_label=_param_label_scratch)


def densenet161unet_imagenet(num_classes: int, dtype=None, pretrained=True) -> SegModel:
    def loader(m):
        weights.load_densenet_features(m, "densenet161_imagenet")

    return SegModel(
        name="densenet161unet_imagenet", module=DenseUNet(num_classes, dtype=dtype),
        mean=np.asarray(IMAGENET_MEAN), std=np.asarray(IMAGENET_STD), block_size=(32, 32),
        param_label=_param_label_pretrained if pretrained else _param_label_scratch,
        load_pretrained=loader if pretrained else None)
