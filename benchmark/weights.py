"""The weights of a run, made on the device from the seed in one draw and
handed alike to the program and to the reference.

Every tensor is a slice of one ``randn`` of the model's total size from a
generator seeded by ``seed``, scaled by its kind: convs N(0, 2 / fan_in)
(He et al.), times ``classifier_gain`` for the classifier; conv biases
N(0, 0.01^2); BN weights 1 + 0.1 z (times ``residual_gain`` for the last
BN of a residual branch, which keeps a 33-block ResNet's activations from
doubling at every block), BN biases and running means 0.1 z, running
variances 1 + 0.1 |z|. The two gains are the configuration's (its
``assumed`` says why each was set as it is).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

SEED_SALT = 0x5EED5


def make(leaves: Iterable, seed: int, init: dict, device) -> Dict[str, torch.Tensor]:
    leaves = list(leaves)
    total = sum(math.prod(lf.shape) for lf in leaves)
    gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + SEED_SALT) % (1 << 63))
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for lf in leaves:
        n = math.prod(lf.shape)
        v = z[at:at + n].view(lf.shape)
        at += n
        if lf.kind == "conv":
            fan_in = n // lf.shape[0]
            gain = init["classifier_gain"] if lf.role == "classifier" else 1.0
            t = v * (gain * math.sqrt(2.0 / fan_in))
        elif lf.kind == "conv_bias":
            t = v * 0.01
        elif lf.kind == "bn_weight":
            t = (1.0 + 0.1 * v) * (init["residual_gain"] if lf.role == "residual_last" else 1.0)
        elif lf.kind in ("bn_bias", "bn_mean"):
            t = 0.1 * v
        elif lf.kind == "bn_var":
            t = 1.0 + 0.1 * v.abs()
        else:
            raise ValueError(f"unknown tensor kind {lf.kind!r}")
        out[lf.name] = t.contiguous()
    return out
