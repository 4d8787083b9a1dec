"""DeepLab v2 on a dilated ResNet-101 (Chen et al., arXiv:1606.00915; He et
al., arXiv:1512.03385), the Caffe variant of Hung et al. that the
semi-supervised recipes train: stride on each stage's first 1x1 conv, a
ceil-mode stem pool, output stride 8 (stage 3 dilated by 2, stage 4 by 4),
and the summed atrous pyramid of four 3x3 convs (dilations 6, 12, 18, 24)
of which the published code sums only the first two (its loop returns
after the second branch). Logits are upsampled bilinearly with aligned
corners to the input size.

The trunk (``trunk_leaves``, ``trunk``) is the stem and the four
bottleneck stages at output stride 8, each stage's output returned by name.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch.nn import functional as F

from benchmark.reference.models import Leaf, Mode, batch_norm, bn_leaves, conv, conv_leaf

STAGE_PLANES = (64, 128, 256, 512)
STAGE_STRIDES = (1, 2, 1, 1)
STAGE_DILATIONS = (1, 1, 2, 4)
ASPP_DILATIONS = (6, 12, 18, 24)


def trunk_leaves(layers: Sequence[int], bn_group: str) -> List[Leaf]:
    """The stem's and the stages' tensors at ``layers`` blocks per stage,
    the convs in the pretrained group, the BNs in ``bn_group``."""
    leaves = conv_leaf("conv1", 3, 64, 7, "pretrained") + bn_leaves("bn1", 64, bn_group)
    inplanes = 64
    for si, (n, planes) in enumerate(zip(layers, STAGE_PLANES), start=1):
        for bi in range(n):
            p = f"layer{si}.{bi}."
            out = planes * 4
            leaves += conv_leaf(p + "conv1", inplanes, planes, 1, "pretrained")
            leaves += bn_leaves(p + "bn1", planes, bn_group)
            leaves += conv_leaf(p + "conv2", planes, planes, 3, "pretrained")
            leaves += bn_leaves(p + "bn2", planes, bn_group)
            leaves += conv_leaf(p + "conv3", planes, out, 1, "pretrained")
            leaves += bn_leaves(p + "bn3", out, bn_group, "residual_last")
            if bi == 0:
                leaves += conv_leaf(p + "downsample.0", inplanes, out, 1, "pretrained")
                leaves += bn_leaves(p + "downsample.1", out, bn_group)
            inplanes = out
    return leaves


def leaves(cfg: dict) -> List[Leaf]:
    """Every tensor of DeepLab v2 at ``cfg['layers']`` blocks per stage.
    Groups as the recipe trains them: the backbone's convs at a tenth of the
    learning rate, the classifier at the full rate, every BN frozen."""
    out = trunk_leaves(cfg["layers"], "frozen")
    for i in range(len(ASPP_DILATIONS)):
        out += conv_leaf(f"layer5.conv2d_list.{i}", 4 * STAGE_PLANES[len(cfg["layers"]) - 1],
                         cfg["num_classes"], 3, "new", "classifier", bias=True)
    return out


def _bottleneck(x, P, B, p, mode, stride, dilation, first):
    y = F.relu(batch_norm(conv(x, P, p + "conv1", mode, stride=stride), P, B, p + "bn1", mode))
    y = F.relu(batch_norm(conv(y, P, p + "conv2", mode, padding=dilation, dilation=dilation),
                          P, B, p + "bn2", mode))
    y = batch_norm(conv(y, P, p + "conv3", mode), P, B, p + "bn3", mode)
    res = x
    if first:
        res = batch_norm(conv(x, P, p + "downsample.0", mode, stride=stride), P, B,
                         p + "downsample.1", mode)
    return F.relu(y + res)


def trunk(layers: Sequence[int], P, B, x: torch.Tensor, mode: Mode) -> Dict[str, torch.Tensor]:
    """(N, 3, H, W) -> each stage's output, ``layer1`` to ``layer4``."""
    x = F.relu(batch_norm(conv(x, P, "conv1", mode, stride=2, padding=3), P, B, "bn1", mode))
    x = F.max_pool2d(x, 3, 2, 1, ceil_mode=True)
    taps = {}
    for si, n in enumerate(layers, start=1):
        for bi in range(n):
            x = _bottleneck(x, P, B, f"layer{si}.{bi}.", mode,
                            STAGE_STRIDES[si - 1] if bi == 0 else 1,
                            STAGE_DILATIONS[si - 1], bi == 0)
        taps[f"layer{si}"] = x
    return taps


def forward(cfg: dict, P, B, x_nhwc: torch.Tensor, mode: Mode) -> torch.Tensor:
    """(N, H, W, 3) float32 -> (N, H, W, C) float32 logits."""
    h, w = x_nhwc.shape[1:3]
    taps = trunk(cfg["layers"], P, B, x_nhwc.permute(0, 3, 1, 2), mode)
    x = taps[f"layer{len(cfg['layers'])}"]
    used = cfg.get("aspp_branches_used", 2)
    out = 0.0
    for i in range(used):
        d = ASPP_DILATIONS[i]
        out = out + conv(x, P, f"layer5.conv2d_list.{i}", mode, padding=d, dilation=d, bias=True)
    out = F.interpolate(out, size=(h, w), mode="bilinear", align_corners=True)
    return out.permute(0, 2, 3, 1)
