"""DenseUNet-161: the DenseNet-161 encoder (Huang et al., arXiv:1608.06993;
growth 48, bottleneck width 4 x 48, blocks of 6, 12, 36 and 24 layers, 96
stem channels, transitions halving the channels) and the additive-skip
decoder of the ISIC recipe: nearest 2x upsample, add the skip, 3x3 conv,
BN, ReLU per level (2208 -> 768 -> 384 -> 96 -> 96; the 1/16 skip through a
1x1 conv with bias from 2112 to 2208 channels), then a nearest 2x upsample,
a 3x3 conv to 64, dropout 0.3, BN, ReLU and a 1x1 classifier.
"""

from __future__ import annotations

from typing import List

import torch
from torch.nn import functional as F

from benchmark.reference.models import Leaf, Mode, batch_norm, bn_leaves, conv, conv_leaf


def _dense_plan(cfg: dict):
    growth, stem = cfg["growth_rate"], cfg["num_init_features"]
    chn, taps, blocks = stem, {"relu0": stem}, []
    n_blocks = len(cfg["block_config"])
    for i, n_layers in enumerate(cfg["block_config"], start=1):
        blocks.append((i, n_layers, chn))
        chn += n_layers * growth
        taps[f"denseblock{i}"] = chn
        if i < n_blocks:
            chn //= 2
    return blocks, taps, chn


def leaves(cfg: dict) -> List[Leaf]:
    """Every tensor of DenseUNet: the encoder at a tenth of the learning
    rate, the decoder at the full rate; BN trains (batch statistics)."""
    growth, bn_size = cfg["growth_rate"], cfg["bn_size"]
    blocks, taps, c_out = _dense_plan(cfg)
    enc = "pretrained"
    out = conv_leaf("features.conv0", 3, cfg["num_init_features"], 7, enc)
    out += bn_leaves("features.norm0", cfg["num_init_features"], enc)
    n_blocks = len(blocks)
    for i, n_layers, chn in blocks:
        for j in range(n_layers):
            p = f"features.denseblock{i}.denselayer{j + 1}."
            c_in = chn + j * growth
            out += bn_leaves(p + "norm1", c_in, enc)
            out += conv_leaf(p + "conv1", c_in, bn_size * growth, 1, enc)
            out += bn_leaves(p + "norm2", bn_size * growth, enc)
            out += conv_leaf(p + "conv2", bn_size * growth, growth, 3, enc)
        if i < n_blocks:
            c = taps[f"denseblock{i}"]
            out += bn_leaves(f"features.transition{i}.norm", c, enc)
            out += conv_leaf(f"features.transition{i}.conv", c, c // 2, 1, enc)
    out += bn_leaves("features.norm5", c_out, enc)
    out += conv_leaf("line0_conv", taps[f"denseblock{n_blocks - 1}"], c_out, 1, "new",
                     bias=True)
    c_in = c_out
    for name, c in zip(("decoder3", "decoder2", "decoder1", "decoder0"),
                       (taps[f"denseblock{n_blocks - 2}"], taps[f"denseblock{n_blocks - 3}"],
                        taps["relu0"], taps["relu0"])):
        out += conv_leaf(name + ".conv", c_in, c, 3, "new")
        out += bn_leaves(name + ".conv_bn", c, "new")
        c_in = c
    out += conv_leaf("final_dec_conv", c_in, 64, 3, "new")
    out += bn_leaves("final_dec_bn", 64, "new")
    out += conv_leaf("final_clf", 64, cfg["num_classes"], 1, "new", "classifier", bias=True)
    return out


def _up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def _dropout(x, rate: float, mode: Mode):
    if mode.dropout_gen is None or rate == 0.0:
        return x
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    keep = torch.empty_like(x, dtype=torch.bool).bernoulli_(keep_prob, generator=mode.dropout_gen)
    return torch.where(keep, x / keep_prob, 0.0)


def forward(cfg: dict, P, B, x_nhwc: torch.Tensor, mode: Mode) -> torch.Tensor:
    """(N, H, W, 3) float32, H and W multiples of 32 -> (N, H, W, C) logits."""
    blocks, _, _ = _dense_plan(cfg)
    x = x_nhwc.permute(0, 3, 1, 2)

    def bn_relu(t, name):
        return F.relu(batch_norm(t, P, B, name, mode))

    taps = {"relu0": bn_relu(conv(x, P, "features.conv0", mode, stride=2, padding=3),
                             "features.norm0")}
    x = F.max_pool2d(taps["relu0"], 3, 2, 1)
    n_blocks = len(blocks)
    for i, n_layers, _ in blocks:
        for j in range(n_layers):
            p = f"features.denseblock{i}.denselayer{j + 1}."
            y = conv(bn_relu(x, p + "norm1"), P, p + "conv1", mode)
            y = conv(bn_relu(y, p + "norm2"), P, p + "conv2", mode, padding=1)
            x = torch.cat([x, y], dim=1)
        taps[f"denseblock{i}"] = x
        if i < n_blocks:
            t = f"features.transition{i}."
            x = F.avg_pool2d(conv(bn_relu(x, t + "norm"), P, t + "conv", mode), 2, 2)
    y = F.relu(batch_norm(x, P, B, "features.norm5", mode))
    skips = (conv(taps[f"denseblock{n_blocks - 1}"], P, "line0_conv", mode, bias=True),
             taps[f"denseblock{n_blocks - 2}"], taps[f"denseblock{n_blocks - 3}"], taps["relu0"])
    for name, skip in zip(("decoder3", "decoder2", "decoder1", "decoder0"), skips):
        y = bn_relu(conv(_up2(y) + skip, P, name + ".conv", mode, padding=1), name + ".conv_bn")
    y = _dropout(conv(_up2(y), P, "final_dec_conv", mode, padding=1), cfg["dropout"], mode)
    logits = conv(bn_relu(y, "final_dec_bn"), P, "final_clf", mode, bias=True)
    return logits.permute(0, 2, 3, 1)
