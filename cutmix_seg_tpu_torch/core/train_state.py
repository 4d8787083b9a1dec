"""Train state and the two-group optimiser (port of
cutmix_seg_tpu.core.train_state).

The state bundles what a step mutates: the student module, the EMA teacher
module (None in pi-model mode, where the student is its own teacher), the
optimiser with its moments, the step count and the device generator that
draws the CutMix boxes. Modules are updated in place.

Optimiser parity with the JAX package's optax chain: parameters labelled
'pretrained' step at 0.1x the learning rate, 'new' at 1x, 'frozen' not at
all (``requires_grad=False`` stands in for ``optax.set_to_zero``). Adam is
``optax.scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0); SGD is
weight decay, then ``optax.trace(momentum, nesterov)``, then the learning
rate, in that order. The learning rate of an update is the schedule at the
optax count before it (the first update uses ``sched(0)``). A parameter that
got no gradient is updated as if its gradient were zero, as optax does.

An update reads its per-step scalars (each group's negated learning rate,
Adam's two bias corrections) from one float32 tensor on the parameters'
device, which the host fills before the update (``Optimizer.scalar_values``,
``scalars_to_device``; a train step hands its copy over in
``Optimizer.device_scalars``), so the update launches the same kernels
whatever the count and can be replayed from a CUDA graph
(``semisup.step_graph``). Each value is a Python double rounded to float32
once, as an op rounds a Python scalar; Adam divides by the bias corrections
(on the card the division by a Python scalar would be a multiply by its
reciprocal).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from cutmix_seg_tpu_torch.core.schedules import constant_schedule
from cutmix_seg_tpu_torch.models.common import SegModel, init_weights
from cutmix_seg_tpu_torch.utils.device import resolve_device

GROUP_SCALES = {"pretrained": 0.1, "new": 1.0}
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _bias_correction(decay: float, t: int) -> float:
    """1 - decay**t in float32, as optax computes it: in float32,
    1 - 0.999 is 1.29e-5 away from 1e-3, which moves Adam's first update by
    6.4e-6 relative."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(t))


def scalars_to_device(values: Sequence[float], device,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``values`` (Python floats) as one float32 tensor on ``device``, in one
    copy. To a CUDA device the copy goes from pinned memory without waiting
    for the device; ``out`` (a graph's static input) receives it in place."""
    device = torch.device(device)
    host = torch.tensor(values, dtype=torch.float32, pin_memory=device.type == "cuda")
    if out is None:
        return host.to(device, non_blocking=True)
    return out.copy_(host, non_blocking=True)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    opt_type: str = "adam"  # 'adam' | 'sgd'
    learning_rate: float = 1e-4
    sgd_momentum: float = 0.9
    sgd_nesterov: bool = False
    sgd_weight_decay: float = 5e-4
    lr_schedule: Optional[Callable[[int], float]] = None  # step -> lr


@dataclasses.dataclass
class _Group:
    scale: float
    params: List[torch.Tensor]
    state: Dict[str, List[torch.Tensor]]


class Optimizer:
    """Adam or SGD over labelled parameter groups, with optax's arithmetic."""

    def __init__(self, cfg: OptimizerConfig, named_params: Mapping[str, nn.Parameter],
                 labels: Mapping[str, str]):
        if cfg.opt_type not in ("adam", "sgd"):
            raise ValueError(f"unknown opt_type {cfg.opt_type!r}")
        unknown = set(labels.values()) - set(GROUP_SCALES) - {"frozen"}
        if unknown:
            raise ValueError(f"unknown parameter labels {sorted(unknown)}")
        self.cfg = cfg
        self.sched = cfg.lr_schedule or constant_schedule(cfg.learning_rate)
        self.count = 0
        # the next update's scalar_values() on the device, set by a train step
        # (stepcore.step_scalars' copy); step() takes them, or copies its own
        self.device_scalars: Optional[torch.Tensor] = None
        self.groups: List[_Group] = []
        for name, p in named_params.items():
            if labels[name] == "frozen":
                p.requires_grad_(False)
        for label, scale in GROUP_SCALES.items():
            params = [p for n, p in named_params.items() if labels[n] == label]
            if not params:
                continue
            if cfg.opt_type == "adam":
                state = {"mu": [torch.zeros_like(p) for p in params],
                         "nu": [torch.zeros_like(p) for p in params]}
            elif cfg.sgd_momentum:
                state = {"trace": [torch.zeros_like(p) for p in params]}
            else:
                state = {}
            self.groups.append(_Group(scale, params, state))

    def zero_grad(self) -> None:
        for g in self.groups:
            for p in g.params:
                p.grad = None

    def scalar_values(self) -> List[float]:
        """The next update's scalars, as Python floats: each group's negated
        learning rate (``sched(count)`` times its scale), then, with Adam,
        the bias corrections 1 - b1^t and 1 - b2^t of t = count + 1."""
        values = [-(self.sched(self.count) * g.scale) for g in self.groups]
        if self.cfg.opt_type == "adam":
            t = self.count + 1
            values += [_bias_correction(ADAM_B1, t), _bias_correction(ADAM_B2, t)]
        return values

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad``, then count += 1. Its
        scalars are ``device_scalars`` (taken: the next update needs its
        own), else ``scalar_values()`` copied to the parameters' device."""
        scalars, self.device_scalars = self.device_scalars, None
        if scalars is None and self.groups:
            scalars = scalars_to_device(self.scalar_values(), self.groups[0].params[0].device)
        n = len(self.groups)
        for i, g in enumerate(self.groups):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in g.params]
            if self.cfg.opt_type == "adam":
                updates = self._adam(g, grads, scalars[n], scalars[n + 1])
            else:
                updates = self._sgd(g, grads)
            torch._foreach_mul_(updates, scalars[i])
            torch._foreach_add_(g.params, updates)
        self.count += 1

    def _adam(self, g: _Group, grads, bias1: torch.Tensor, bias2: torch.Tensor):
        mu, nu = g.state["mu"], g.state["nu"]
        torch._foreach_mul_(mu, ADAM_B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - ADAM_B1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - ADAM_B2)
        torch._foreach_mul_(nu, ADAM_B2)
        torch._foreach_add_(nu, sq)
        denom = torch._foreach_div(nu, bias2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        updates = torch._foreach_div(mu, bias1)
        torch._foreach_div_(updates, denom)
        return updates

    def _sgd(self, g: _Group, grads):
        cfg = self.cfg
        if cfg.sgd_weight_decay:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(g.params, cfg.sgd_weight_decay))
        if not cfg.sgd_momentum:
            return [g.clone() for g in grads]  # step() scales updates in place
        trace = g.state["trace"]
        torch._foreach_mul_(trace, cfg.sgd_momentum)
        torch._foreach_add_(trace, grads)
        if cfg.sgd_nesterov:
            return torch._foreach_add(
                grads, torch._foreach_mul(trace, cfg.sgd_momentum))
        return [t.clone() for t in trace]


def make_optimizer(cfg: OptimizerConfig, named_params: Mapping[str, nn.Parameter],
                   labels: Mapping[str, str]) -> Optimizer:
    return Optimizer(cfg, named_params, labels)


@dataclasses.dataclass
class TrainState:
    student: nn.Module
    teacher: Optional[nn.Module]  # None in pi-model mode
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0


def create_train_state(model: SegModel, opt_cfg: OptimizerConfig, seed: int,
                       device=None, mean_teacher: bool = True,
                       pretrained: bool = True):
    """Initialise the train state of a SegModel; returns (state, optimizer).

    Weights are drawn on the CPU from ``seed`` (so the CPU and GPU states of
    one seed are equal), optionally overwritten by the pretrained loader, and
    moved to ``device`` (CUDA by default; raises without a GPU) in
    channels_last layout. The teacher is a distinct copy."""
    dev = resolve_device(device)
    module = model.module.to("cpu")
    init_weights(module, torch.Generator().manual_seed(seed))
    if pretrained and model.load_pretrained is not None:
        model.load_pretrained(module)
    module.to(dev, memory_format=torch.channels_last)
    opt = make_optimizer(opt_cfg, dict(module.named_parameters()),
                         model.param_label(module))
    teacher = None
    if mean_teacher:
        teacher = copy.deepcopy(module).requires_grad_(False)
    generator = torch.Generator(device=dev).manual_seed(seed)
    state = TrainState(student=module, teacher=teacher, optimizer=opt,
                       generator=generator)
    return state, opt
