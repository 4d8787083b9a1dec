"""DeepLab v3+ (Chen et al., "Encoder-Decoder with Atrous Separable
Convolution", arXiv:1802.02611) on a dilated ResNet-101, the variant of the
semi-supervised recipes (``--arch=resnet101_deeplabv3plus_imagenet``):

* the trunk: torchvision's ResNet (V1.5) at output stride 8: stride on each
  bottleneck's 3x3 conv, a floor-mode stem pool, stage 3 dilated by 2 and
  stage 4 by 4, each dilated stage's first block at the previous stage's
  dilation;
* ASPP: a 1x1 branch, three 3x3 branches at dilations 12, 24 and 36, and
  image pooling (the global mean, a 1x1 conv, BN, ReLU, broadcast back),
  each branch conv-BN-ReLU; their 5 x 256 channels concatenated, then a 1x1
  conv to 256, BN, ReLU and dropout;
* the decoder: a 48-channel 1x1 conv-BN-ReLU projection of stage 1's
  output, the ASPP output resized to its size (bilinear, half-pixel
  centres) and concatenated (304 channels), two 3x3 conv-BN-ReLU blocks
  and a 1x1 classifier with bias; the logits resized (bilinear, half-pixel
  centres) to the input size.

Departures from arXiv:1802.02611, as the recipe's code has them: standard
3x3 convolutions in ASPP and the decoder where the paper's are depthwise
separable; a ResNet-101 trunk where the paper's best is an aligned
Xception; every convolution before a BN without bias.

BN: the trunk's in the backbone's group (a tenth of the learning rate),
the head's in the new one. Under ``--freeze_bn`` only the running
statistics freeze: every BN weight and bias trains.

Dropout draws its keep mask from ``mode.dropout_gen`` (no generator: no
dropout). The program's forwards run in train mode under frozen BN too, so
its dropout draws masks from the step's generator in the teacher's pass
and then the student's, after the boxes. ``steps.mask_mt_losses`` hands
its generator to the forwards only with training BN; ``_step_generator_
under_frozen_bn`` wraps it so that it hands it to both forwards under
frozen BN as well. DeepLab v2 draws no dropout and DenseUNet trains its BN,
so their steps read as before.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import torch
from torch.nn import functional as F

from benchmark.reference import steps
from benchmark.reference.families.deeplab2 import (STAGE_DILATIONS, STAGE_PLANES, STAGE_STRIDES,
                                                  trunk_leaves)
from benchmark.reference.models import Leaf, Mode, batch_norm, bn_leaves, conv, conv_leaf

TRUNK = "backbone."


def _cbr_leaves(name: str, cin: int, cout: int, k: int) -> List[Leaf]:
    return conv_leaf(name + ".conv", cin, cout, k, "new") + bn_leaves(name + ".bn", cout, "new")


def leaves(cfg: dict) -> List[Leaf]:
    """Every tensor of DeepLab v3+ at ``cfg['layers']`` blocks per stage,
    under the port's module names (the trunk under ``backbone.``)."""
    out = [dataclasses.replace(lf, name=TRUNK + lf.name)
           for lf in trunk_leaves(cfg["layers"], "pretrained")]
    c_top, c_low = 4 * STAGE_PLANES[-1], 4 * STAGE_PLANES[0]
    f = cfg["aspp_features"]
    out += _cbr_leaves("aspp.b0", c_top, f, 1)
    for i in range(1, len(cfg["aspp_dilations"]) + 1):
        out += _cbr_leaves(f"aspp.b{i}", c_top, f, 3)
    out += _cbr_leaves("aspp.pool", c_top, f, 1)
    out += _cbr_leaves("aspp.project", (len(cfg["aspp_dilations"]) + 2) * f, f, 1)
    out += _cbr_leaves("project", c_low, cfg["low_level_channels"], 1)
    out += _cbr_leaves("head0", cfg["low_level_channels"] + f, f, 3)
    out += _cbr_leaves("head1", f, f, 3)
    out += conv_leaf("classifier", f, cfg["num_classes"], 1, "new", "classifier", bias=True)
    return out


def _bottleneck(x, P, B, p, mode, stride, dilation, first):
    y = F.relu(batch_norm(conv(x, P, p + "conv1", mode), P, B, p + "bn1", mode))
    y = F.relu(batch_norm(conv(y, P, p + "conv2", mode, stride=stride, padding=dilation,
                               dilation=dilation), P, B, p + "bn2", mode))
    y = batch_norm(conv(y, P, p + "conv3", mode), P, B, p + "bn3", mode)
    res = x
    if first:
        res = batch_norm(conv(x, P, p + "downsample.0", mode, stride=stride), P, B,
                         p + "downsample.1", mode)
    return F.relu(y + res)


def trunk(layers, P, B, x: torch.Tensor, mode: Mode) -> Dict[str, torch.Tensor]:
    """(N, 3, H, W) -> each stage's output, ``layer1`` to ``layer4``."""
    t = TRUNK
    x = F.relu(batch_norm(conv(x, P, t + "conv1", mode, stride=2, padding=3), P, B,
                          t + "bn1", mode))
    x = F.max_pool2d(x, 3, 2, 1)
    taps, prev = {}, 1
    for si, n in enumerate(layers, start=1):
        for bi in range(n):
            x = _bottleneck(x, P, B, f"{t}layer{si}.{bi}.", mode,
                            STAGE_STRIDES[si - 1] if bi == 0 else 1,
                            prev if bi == 0 else STAGE_DILATIONS[si - 1], bi == 0)
        prev = STAGE_DILATIONS[si - 1]
        taps[f"layer{si}"] = x
    return taps


def _dropout(x, rate: float, mode: Mode):
    if mode.dropout_gen is None or rate == 0.0:
        return x
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    # drawn in channels-last order, the element order of the program's NHWC maps
    keep = torch.empty_like(x, dtype=torch.bool, memory_format=torch.channels_last).bernoulli_(
        keep_prob, generator=mode.dropout_gen)
    return torch.where(keep, x / keep_prob, 0.0)


def forward(cfg: dict, P, B, x_nhwc: torch.Tensor, mode: Mode) -> torch.Tensor:
    """(N, H, W, 3) float32 -> (N, H, W, C) float32 logits."""
    h, w = x_nhwc.shape[1:3]
    taps = trunk(cfg["layers"], P, B, x_nhwc.permute(0, 3, 1, 2), mode)

    def cbr(t, name, dilation=None):
        # a 3x3 conv when given a dilation, else a 1x1
        d = dilation or 1
        y = conv(t, P, name + ".conv", mode, padding=0 if dilation is None else d, dilation=d)
        return F.relu(batch_norm(y, P, B, name + ".bn", mode))

    top = taps["layer4"]
    branches = [cbr(top, "aspp.b0")]
    for i, d in enumerate(cfg["aspp_dilations"], start=1):
        branches.append(cbr(top, f"aspp.b{i}", d))
    pooled = cbr(F.adaptive_avg_pool2d(top, 1), "aspp.pool")
    branches.append(pooled.expand(-1, -1, *top.shape[2:]))
    y = _dropout(cbr(torch.cat(branches, dim=1), "aspp.project"), cfg["dropout"], mode)
    low = cbr(taps["layer1"], "project")
    y = F.interpolate(y, size=tuple(low.shape[2:]), mode="bilinear", align_corners=False)
    y = cbr(cbr(torch.cat([low, y], dim=1), "head0", 1), "head1", 1)
    logits = conv(y, P, "classifier", mode, bias=True)
    logits = F.interpolate(logits, size=(h, w), mode="bilinear", align_corners=False)
    return logits.permute(0, 2, 3, 1)


def _step_generator_under_frozen_bn(losses):
    """``steps.mask_mt_losses`` whose forwards take the step's generator for
    their dropout masks under frozen BN too, as the program's do. A family
    that draws no dropout (DeepLab v2) reads the same either way."""

    @functools.wraps(losses)
    def wrapped(nets, hp, b, gen, train_bn):
        if train_bn:
            return losses(nets, hp, b, gen, train_bn)
        fwd = nets.fwd
        nets.fwd = lambda teacher, x, train_bn, _gen=None, update=True: fwd(
            teacher, x, train_bn, gen, update)
        try:
            return losses(nets, hp, b, gen, train_bn)
        finally:
            del nets.fwd

    wrapped.hands_generator_under_frozen_bn = True
    return wrapped


if not getattr(steps.mask_mt_losses, "hands_generator_under_frozen_bn", False):
    steps.mask_mt_losses = _step_generator_under_frozen_bn(steps.mask_mt_losses)
