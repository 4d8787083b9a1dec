"""Consistency-weight ramp-up schedules (copy of cutmix_seg_tpu.utils.rampup)."""

from __future__ import annotations

import numpy as np


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """Exponential sigmoid ramp-up ``exp(-5 (1 - t)^2)`` from Laine & Aila,
    arXiv:1610.02242."""
    if rampup_length == 0:
        return 1.0
    current = float(np.clip(current, 0.0, rampup_length))
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))
