"""Tracing and timing helpers (port of cutmix_seg_tpu.utils.profiling).

  * ``trace(logdir)``: a torch.profiler trace of the enclosed block (CPU,
    and CUDA where the card is used), written to ``logdir`` as a Chrome
    trace; a no-op for None;
  * ``StepTimer``: a throughput meter for a stream of asynchronously
    launched steps, synchronising at explicit points;
  * ``images_per_sec``: the trainers' images/s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Capture a torch.profiler trace of the enclosed block into
    ``logdir/trace.json`` (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync(value) -> float:
    """Wait for ``value`` (a tensor) to be computed: on a CUDA device by
    synchronising it, on the CPU by fetching it; returns its first element."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
        return float(value.detach().reshape(-1)[0])
    return float(value)


class StepTimer:
    """Times a stream of async step launches with explicit sync points.

    Usage:
        timer = StepTimer()
        for i in range(n):
            state, metrics = step(state, batch, ramp)
            timer.tick(metrics["sup_loss"], every=20)
        elapsed = timer.finish(metrics["sup_loss"])
    """

    def __init__(self):
        self.t0 = time.perf_counter()
        self.n_steps = 0
        self.synced_at = 0.0

    def tick(self, sync_value=None, every: int = 0):
        self.n_steps += 1
        if sync_value is not None and every and self.n_steps % every == 0:
            _sync(sync_value)
            self.synced_at = time.perf_counter()

    def finish(self, sync_value) -> float:
        """Final sync; returns elapsed seconds."""
        _sync(sync_value)
        return time.perf_counter() - self.t0

    def steps_per_sec(self, elapsed: float) -> float:
        return self.n_steps / max(elapsed, 1e-9)


def images_per_sec(n_steps: int, batch_per_device: int, elapsed: float) -> float:
    """Train images/s per device."""
    return n_steps * batch_per_device / max(elapsed, 1e-9)
