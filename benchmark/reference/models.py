"""What the benchmark's reference models share, in plain functions of a
dict of tensors in float32: each architecture is a module of its own,
``benchmark/reference/families/<family>.py``, found by the configuration's
``model.family``, with ``leaves(cfg)`` (every tensor of the model, as
``Leaf``) and ``forward(cfg, P, B, x, mode)`` ((N, H, W, 3) images to
(N, H, W, C) logits).

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
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch
from torch.nn import functional as F

from benchmark import named

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


def conv_leaf(name, cin, cout, k, group, role="plain", bias=False) -> List[Leaf]:
    out = [Leaf(name + ".weight", (cout, cin, k, k), "conv", group, role)]
    if bias:
        out.append(Leaf(name + ".bias", (cout,), "conv_bias", group, role))
    return out


def bn_leaves(name, c, group, role="plain") -> List[Leaf]:
    return [Leaf(name + ".weight", (c,), "bn_weight", group, role),
            Leaf(name + ".bias", (c,), "bn_bias", group, role),
            Leaf(name + ".running_mean", (c,), "bn_mean", "buffer", role),
            Leaf(name + ".running_var", (c,), "bn_var", "buffer", role)]


def leaves_of(model_cfg: dict) -> List[Leaf]:
    return family(model_cfg).leaves(model_cfg)


def forward(model_cfg: dict, P: Dict[str, torch.Tensor], B: Dict[str, torch.Tensor],
            x: torch.Tensor, mode: Mode) -> torch.Tensor:
    return family(model_cfg).forward(model_cfg, P, B, x, mode)


def family(model_cfg: dict) -> ModuleType:
    """The module of the configuration's ``family``,
    ``benchmark/reference/families/<family>.py``."""
    return named.module_of("benchmark.reference.families", model_cfg["family"])
