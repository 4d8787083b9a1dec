"""Learning-rate schedules as step -> lr functions (port of
cutmix_seg_tpu.core.schedules): 'none', 'stepped' (per-epoch multi-step
decay), 'cosine' (per-iter), 'poly' (per-iter, ``(1 - t)^power``).

The step is the optimiser's count before the update, as optax's is: the
first update uses ``sched(0)``.
"""

from __future__ import annotations

import ast
import math
from typing import Callable, Sequence, Union

Schedule = Callable[[int], float]


def constant_schedule(base_lr: float) -> Schedule:
    return lambda step: base_lr


def polynomial_schedule(base_lr: float, total_iters: int, power: float = 0.9,
                        eta_min: float = 0.0) -> Schedule:
    """(1 - step/total)^power decay, clamped; step 0 yields base_lr."""

    def sched(step):
        progress = min(max(step / max(total_iters, 1), 0.0), 1.0)
        return base_lr * max((1.0 - progress) ** power, eta_min)

    return sched


def stepped_schedule(base_lr: float, milestones: Sequence[int], gamma: float,
                     iters_per_epoch: int) -> Schedule:
    """MultiStepLR semantics: lr is multiplied by gamma at each milestone
    *epoch*, as a function of the global iteration."""
    milestones = sorted(int(m) for m in milestones)

    def sched(step):
        epoch = step // max(iters_per_epoch, 1)
        return base_lr * gamma ** sum(epoch >= m for m in milestones)

    return sched


def cosine_decay_schedule(base_lr: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0."""

    def sched(step):
        t = min(step, decay_steps)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))

    return sched


def make_lr_schedule(
    schedule_type: str,
    base_lr: float,
    total_iters: int,
    step_epochs: Union[str, Sequence[int], None] = None,
    step_gamma: float = 0.1,
    poly_power: float = 0.9,
    iters_per_epoch: int = 1,
) -> Schedule:
    """Factory mirroring the reference CLI surface."""
    if schedule_type == "none":
        return constant_schedule(base_lr)
    if schedule_type == "stepped":
        if isinstance(step_epochs, str):
            if step_epochs.strip() == "":
                return constant_schedule(base_lr)
            step_epochs = ast.literal_eval(step_epochs)
        if not step_epochs:
            return constant_schedule(base_lr)
        return stepped_schedule(base_lr, step_epochs, step_gamma, iters_per_epoch)
    if schedule_type == "cosine":
        return cosine_decay_schedule(base_lr, max(total_iters, 1))
    if schedule_type == "poly":
        return polynomial_schedule(base_lr, total_iters, power=poly_power)
    raise ValueError(f"unknown schedule_type {schedule_type!r}")
