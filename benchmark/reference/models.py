"""The two architectures of the benchmark's configurations, written from
their papers as plain functions of a dict of tensors, in float32.

* DeepLab v2 on a dilated ResNet-101 (Chen et al., arXiv:1606.00915; He et
  al., arXiv:1512.03385), the Caffe variant of Hung et al. that the
  semi-supervised recipes train: stride on each stage's first 1x1 conv, a
  ceil-mode stem pool, output stride 8 (stage 3 dilated by 2, stage 4 by 4),
  and the summed atrous pyramid of four 3x3 convs (dilations 6, 12, 18, 24)
  of which the published code sums only the first two (its loop returns
  after the second branch). Logits are upsampled bilinearly with aligned
  corners to the input size.
* DenseUNet-161: the DenseNet-161 encoder (Huang et al., arXiv:1608.06993;
  growth 48, bottleneck width 4 x 48, blocks of 6, 12, 36 and 24 layers,
  96 stem channels, transitions halving the channels) and the additive-skip
  decoder of the ISIC recipe: nearest 2x upsample, add the skip, 3x3 conv,
  BN, ReLU per level (2208 -> 768 -> 384 -> 96 -> 96; the 1/16 skip through
  a 1x1 conv with bias from 2112 to 2208 channels), then a nearest 2x
  upsample, a 3x3 conv to 64, dropout 0.3, BN, ReLU and a 1x1 classifier.

Tensors are named as the module attributes of the published code name them
(torchvision's layout), so one dict of weights serves every implementation.
BatchNorm uses running statistics (frozen) or the batch's, with the biased
variance in the running average (momentum 0.9, eps 1e-5).

``Precision`` rounds what enters and what leaves each convolution: float32
as it is, or through float8 with a per-tensor scale (e4m3 values, e5m2
gradients), the control that a lower precision than the configuration's
must fail. Its output is rounded too, as the program rounds every
convolution's output to its bfloat16: operands alone would leave the
control's errors averaged over each sum's terms, finer than the program's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.nn import functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One tensor of a model: its name, shape, kind (conv, conv_bias,
    bn_weight, bn_bias, bn_mean, bn_var), the optimiser group of the
    recipe (pretrained, new, frozen; buffers: buffer) and the role its
    initial value takes (plain, residual_last, classifier)."""

    name: str
    shape: Tuple[int, ...]
    kind: str
    group: str
    role: str = "plain"


def _round_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x through ``dtype`` with a per-tensor scale that maps its largest
    magnitude to ``top``."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """The float8 training recipe's rounding: values in e4m3, their
    gradients in e5m2, each tensor with its own scale."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, FP8_E5M2_MAX)


@dataclasses.dataclass
class Precision:
    mode: str = "float32"  # 'float32' | 'fp8' | 'float64'

    @property
    def dtype(self) -> torch.dtype:
        """The type of the weights and activations."""
        return torch.float64 if self.mode == "float64" else torch.float32

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x as a convolution reads or writes it (and its gradient as the
        convolution's backward takes or returns it)."""
        if self.mode in ("float32", "float64"):
            return x
        return _Fp8.apply(x)


@dataclasses.dataclass
class Mode:
    """How a forward runs: BN from the batch (``train_bn``, updating the
    running statistics in ``buffers``) or from running statistics; dropout
    masks from ``dropout_gen`` (None: no dropout)."""

    train_bn: bool = False
    dropout_gen: Optional[torch.Generator] = None
    precision: Precision = dataclasses.field(default_factory=Precision)
    update_stats: bool = True


def conv(x, P, name, mode: Mode, stride=1, padding=0, dilation=1, bias=False):
    q = mode.precision.q
    b = P[name + ".bias"] if bias else None
    return q(F.conv2d(q(x), q(P[name + ".weight"]), b, stride, padding, dilation))


def batch_norm(x, P, B, name, mode: Mode):
    w, b = P[name + ".weight"], P[name + ".bias"]
    rm, rv = B[name + ".running_mean"], B[name + ".running_var"]
    if not mode.train_bn:
        mean, var = rm, rv
    else:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
        if mode.update_stats:
            with torch.no_grad():
                rm.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean.detach())
                rv.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var.detach())
    inv = torch.rsqrt(var + BN_EPS) * w
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] + b[None, :, None, None]


def _conv_leaf(name, cin, cout, k, group, role="plain", bias=False) -> List[Leaf]:
    out = [Leaf(name + ".weight", (cout, cin, k, k), "conv", group, role)]
    if bias:
        out.append(Leaf(name + ".bias", (cout,), "conv_bias", group, role))
    return out


def _bn_leaves(name, c, group, role="plain") -> List[Leaf]:
    return [Leaf(name + ".weight", (c,), "bn_weight", group, role),
            Leaf(name + ".bias", (c,), "bn_bias", group, role),
            Leaf(name + ".running_mean", (c,), "bn_mean", "buffer", role),
            Leaf(name + ".running_var", (c,), "bn_var", "buffer", role)]


# ---------------------------------------------------------------- DeepLab v2

STAGE_PLANES = (64, 128, 256, 512)
STAGE_STRIDES = (1, 2, 1, 1)
STAGE_DILATIONS = (1, 1, 2, 4)
ASPP_DILATIONS = (6, 12, 18, 24)


def deeplab2_leaves(cfg: dict) -> List[Leaf]:
    """Every tensor of DeepLab v2 at ``cfg['layers']`` blocks per stage.
    Groups as the recipe trains them: the backbone's convs at a tenth of the
    learning rate, the classifier at the full rate, every BN frozen."""
    bn_group = "frozen"
    leaves = _conv_leaf("conv1", 3, 64, 7, "pretrained") + _bn_leaves("bn1", 64, bn_group)
    inplanes = 64
    for si, (n, planes) in enumerate(zip(cfg["layers"], STAGE_PLANES), start=1):
        for bi in range(n):
            p = f"layer{si}.{bi}."
            out = planes * 4
            leaves += _conv_leaf(p + "conv1", inplanes, planes, 1, "pretrained")
            leaves += _bn_leaves(p + "bn1", planes, bn_group)
            leaves += _conv_leaf(p + "conv2", planes, planes, 3, "pretrained")
            leaves += _bn_leaves(p + "bn2", planes, bn_group)
            leaves += _conv_leaf(p + "conv3", planes, out, 1, "pretrained")
            leaves += _bn_leaves(p + "bn3", out, bn_group, "residual_last")
            if bi == 0:
                leaves += _conv_leaf(p + "downsample.0", inplanes, out, 1, "pretrained")
                leaves += _bn_leaves(p + "downsample.1", out, bn_group)
            inplanes = out
    for i in range(len(ASPP_DILATIONS)):
        leaves += _conv_leaf(f"layer5.conv2d_list.{i}", inplanes, cfg["num_classes"], 3,
                             "new", "classifier", bias=True)
    return leaves


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


def deeplab2_forward(cfg: dict, P, B, x_nhwc: torch.Tensor, mode: Mode) -> torch.Tensor:
    """(N, H, W, 3) float32 -> (N, H, W, C) float32 logits."""
    h, w = x_nhwc.shape[1:3]
    x = x_nhwc.permute(0, 3, 1, 2)
    x = F.relu(batch_norm(conv(x, P, "conv1", mode, stride=2, padding=3), P, B, "bn1", mode))
    x = F.max_pool2d(x, 3, 2, 1, ceil_mode=True)
    for si, n in enumerate(cfg["layers"], start=1):
        for bi in range(n):
            x = _bottleneck(x, P, B, f"layer{si}.{bi}.", mode,
                            STAGE_STRIDES[si - 1] if bi == 0 else 1,
                            STAGE_DILATIONS[si - 1], bi == 0)
    used = cfg.get("aspp_branches_used", 2)
    out = 0.0
    for i in range(used):
        d = ASPP_DILATIONS[i]
        out = out + conv(x, P, f"layer5.conv2d_list.{i}", mode, padding=d, dilation=d, bias=True)
    out = F.interpolate(out, size=(h, w), mode="bilinear", align_corners=True)
    return out.permute(0, 2, 3, 1)


# ------------------------------------------------------------- DenseUNet-161

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


def denseunet_leaves(cfg: dict) -> List[Leaf]:
    """Every tensor of DenseUNet: the encoder at a tenth of the learning
    rate, the decoder at the full rate; BN trains (batch statistics)."""
    growth, bn_size = cfg["growth_rate"], cfg["bn_size"]
    blocks, taps, c_out = _dense_plan(cfg)
    enc = "pretrained"
    leaves = _conv_leaf("features.conv0", 3, cfg["num_init_features"], 7, enc)
    leaves += _bn_leaves("features.norm0", cfg["num_init_features"], enc)
    n_blocks = len(blocks)
    for i, n_layers, chn in blocks:
        for j in range(n_layers):
            p = f"features.denseblock{i}.denselayer{j + 1}."
            c_in = chn + j * growth
            leaves += _bn_leaves(p + "norm1", c_in, enc)
            leaves += _conv_leaf(p + "conv1", c_in, bn_size * growth, 1, enc)
            leaves += _bn_leaves(p + "norm2", bn_size * growth, enc)
            leaves += _conv_leaf(p + "conv2", bn_size * growth, growth, 3, enc)
        if i < n_blocks:
            c = taps[f"denseblock{i}"]
            leaves += _bn_leaves(f"features.transition{i}.norm", c, enc)
            leaves += _conv_leaf(f"features.transition{i}.conv", c, c // 2, 1, enc)
    leaves += _bn_leaves("features.norm5", c_out, enc)
    leaves += _conv_leaf("line0_conv", taps[f"denseblock{n_blocks - 1}"], c_out, 1, "new",
                         bias=True)
    c_in = c_out
    for name, c in zip(("decoder3", "decoder2", "decoder1", "decoder0"),
                       (taps[f"denseblock{n_blocks - 2}"], taps[f"denseblock{n_blocks - 3}"],
                        taps["relu0"], taps["relu0"])):
        leaves += _conv_leaf(name + ".conv", c_in, c, 3, "new")
        leaves += _bn_leaves(name + ".conv_bn", c, "new")
        c_in = c
    leaves += _conv_leaf("final_dec_conv", c_in, 64, 3, "new")
    leaves += _bn_leaves("final_dec_bn", 64, "new")
    leaves += _conv_leaf("final_clf", 64, cfg["num_classes"], 1, "new", "classifier", bias=True)
    return leaves


def _up2(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def _dropout(x, rate: float, mode: Mode):
    if mode.dropout_gen is None or rate == 0.0:
        return x
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    keep = torch.empty_like(x, dtype=torch.bool).bernoulli_(keep_prob, generator=mode.dropout_gen)
    return torch.where(keep, x / keep_prob, 0.0)


def denseunet_forward(cfg: dict, P, B, x_nhwc: torch.Tensor, mode: Mode) -> torch.Tensor:
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


FAMILIES = {
    "deeplab2": (deeplab2_leaves, deeplab2_forward),
    "denseunet": (denseunet_leaves, denseunet_forward),
}


def leaves_of(model_cfg: dict) -> List[Leaf]:
    return FAMILIES[model_cfg["family"]][0](model_cfg)


def forward(model_cfg: dict, P: Dict[str, torch.Tensor], B: Dict[str, torch.Tensor],
            x: torch.Tensor, mode: Mode) -> torch.Tensor:
    return FAMILIES[model_cfg["family"]][1](model_cfg, P, B, x, mode)
