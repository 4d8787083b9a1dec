"""Toy-2D MLP with the reference's normalisation menu (port of
cutmix_seg_tpu.toy2d.model.ToyMLP), with flax's semantics for each norm.

Reference: toy2d_train.py:83-122 — n_hidden x (Linear [+ norm] + ReLU/LeakyReLU),
dropout(0.5) before the final 2-class linear layer; norm options none /
batch_norm / group_norm / weight_norm / spectral_norm.

The flax modules' arithmetic, not torch's defaults:
  * BatchNorm (``bn{i}``): momentum 0.9, eps 1e-5, batch mean and biased
    fast variance max(E[x^2] - E[x]^2, 0), the same variance in the running
    update;
  * GroupNorm(4) (``gn{i}``): eps 1e-6, fast variance;
  * WeightNorm (``dense{i}.scale``, ones at init): the weight normalised per
    output feature over its inputs, eps 1e-12;
  * SpectralNorm (buffers ``dense{i}.u``, ``dense{i}.sigma``): one power step
    from the stored u on every forward, eps 1e-12, the weight divided by the
    sigma it gives; only a forward that updates statistics stores u and sigma.

A forward updates statistics (BN's running averages, SpectralNorm's u and
sigma) when the module is in train mode, unless ``update_stats=False`` (the
mean teacher's forward, whose updates the JAX step discards). Dropout in
train mode takes the keep mask it is given, else draws one from
``generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

NORMS = ("none", "batch_norm", "group_norm", "weight_norm", "spectral_norm")
DROP_RATE = 0.5
# std of a standard normal truncated to [-2, 2] (flax's lecun_normal divides by it)
_TRUNC_STD = 0.87962566103423978
_EPS_L2 = 1e-12


def _l2_normalize(x: torch.Tensor, dim=None) -> torch.Tensor:
    sq = (x * x).sum() if dim is None else (x * x).sum(dim=dim, keepdim=True)
    return x * torch.rsqrt(sq + _EPS_L2)


class Dense(nn.Module):
    """flax's Dense (``weight`` is the kernel transposed, (out, in)), bare or
    under flax's WeightNorm or SpectralNorm (``norm``)."""

    def __init__(self, n_in: int, n_out: int, norm: str = "none"):
        super().__init__()
        self.norm = norm
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(n_out))
        if norm == "weight_norm":
            self.scale = nn.Parameter(torch.ones(n_out))
        if norm == "spectral_norm":
            self.register_buffer("u", torch.empty(1, n_out))
            self.register_buffer("sigma", torch.ones(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """lecun_normal weight, zero bias (flax's Dense), a standard normal u."""
        with torch.no_grad():
            std = math.sqrt(1.0 / self.weight.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            self.bias.zero_()
            if self.norm == "weight_norm":
                self.scale.fill_(1.0)
            if self.norm == "spectral_norm":
                self.u.normal_(generator=generator)
                self.sigma.fill_(1.0)

    def kernel(self, update_stats: bool) -> torch.Tensor:
        w = self.weight
        if self.norm == "weight_norm":
            return _l2_normalize(w, dim=1) * self.scale[:, None]
        if self.norm == "spectral_norm":
            with torch.no_grad():  # flax stops the gradient through u and v
                v = _l2_normalize(self.u @ w)
                u = _l2_normalize(v @ w.t())
            sigma = (u @ w @ v.t())[0, 0]
            if update_stats:
                with torch.no_grad():
                    self.u.copy_(u)
                    self.sigma.copy_(sigma)
            return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        return w

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        return F.linear(x, self.kernel(update_stats), self.bias)


class BatchNorm(nn.Module):
    """flax's BatchNorm over (N, C) (momentum 0.9, eps 1e-5, fast variance),
    with torch's parameter names."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean = x.mean(dim=0)
            var = torch.clamp_min((x * x).mean(dim=0) - mean * mean, 0.0)
            if update_stats:
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class GroupNorm(nn.Module):
    """flax's GroupNorm over (N, C) (eps 1e-6, fast variance)."""

    eps = 1e-6

    def __init__(self, n: int, groups: int = 4):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape
        g = x.reshape(n, self.groups, c // self.groups)
        mean = g.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((g * g).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps).expand_as(g).reshape(n, c) * self.weight
        return (x - mean.expand_as(g).reshape(n, c)) * mul + self.bias


class ToyMLP(nn.Module):
    def __init__(self, n_hidden: int = 3, hidden_size: int = 512, hidden_act: str = "relu",
                 norm_layer: str = "batch_norm"):
        super().__init__()
        if norm_layer not in NORMS:
            raise ValueError(norm_layer)
        if hidden_act not in ("relu", "lrelu"):
            raise ValueError(hidden_act)
        self.n_hidden = n_hidden
        self.hidden_act = hidden_act
        self.norm_layer = norm_layer
        self.generator: Optional[torch.Generator] = None  # dropout draws without a mask
        dense_norm = norm_layer if norm_layer in ("weight_norm", "spectral_norm") else "none"
        for i in range(n_hidden):
            setattr(self, f"dense{i}", Dense(2 if i == 0 else hidden_size, hidden_size,
                                             dense_norm))
            if norm_layer == "batch_norm":
                setattr(self, f"bn{i}", BatchNorm(hidden_size))
            elif norm_layer == "group_norm":
                setattr(self, f"gn{i}", GroupNorm(hidden_size))
        self.final = Dense(hidden_size, 2)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Every Dense in module order from ``generator``; norms to identity."""
        for m in self.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, use_dropout: bool = True,
                keep: Optional[torch.Tensor] = None,
                update_stats: Optional[bool] = None) -> torch.Tensor:
        """(N, 2) points -> (N, 2) logits. ``keep``: the dropout keep mask
        (N, hidden_size) of a train-mode forward; ``update_stats`` defaults
        to the train mode."""
        update = self.training if update_stats is None else update_stats
        for i in range(self.n_hidden):
            x = getattr(self, f"dense{i}")(x, update)
            if self.norm_layer == "batch_norm":
                x = getattr(self, f"bn{i}")(x, update)
            elif self.norm_layer == "group_norm":
                x = getattr(self, f"gn{i}")(x)
            x = F.relu(x) if self.hidden_act == "relu" else F.leaky_relu(x, 0.01)
        if use_dropout and self.training:
            if keep is None:
                keep = self.draw_keep(x)
            x = torch.where(keep, x / (1.0 - DROP_RATE), 0.0)
        return self.final(x)

    def draw_keep(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None:
            raise RuntimeError("a train-mode ToyMLP forward without a keep mask needs "
                               "its generator set")
        return torch.rand(x.shape, generator=self.generator, device=x.device) >= DROP_RATE
