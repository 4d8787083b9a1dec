"""EMA teacher update (port of cutmix_seg_tpu.semisup.ema).

teacher <- alpha * teacher + (1 - alpha) * student over every float tensor
of the model: parameters, the frozen BN's affine parameters and its running
statistics alike. Frozen tensors are not skipped: with t == s,
t * alpha + s * (1 - alpha) is not bit-identical to t, and the JAX package
does this arithmetic.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn


def float_tensors(module: nn.Module) -> List[torch.Tensor]:
    """Every float parameter and buffer of ``module``, in a fixed order."""
    return [t for t in (*module.parameters(), *module.buffers())
            if t.is_floating_point()]


@torch.no_grad()
def ema_update(teacher: List[torch.Tensor], student: List[torch.Tensor],
               alpha: float) -> None:
    """In place: t = t * alpha + s * (1 - alpha), each product rounded, as
    the JAX expression is."""
    torch._foreach_mul_(teacher, alpha)
    torch._foreach_add_(teacher, torch._foreach_mul(student, 1.0 - alpha))
