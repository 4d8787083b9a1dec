"""From a traced window's profiler events to per-iteration sums: host time
in each trainer span, device time by kernel group and by the span that
launched each kernel, launches per span, the busy union of the device, the
longest device idle gaps by what the host was doing, and the hand-written
kernel's launches.

The kernel-name table and the busy-union and span arithmetic are copies of
the program's profiling scripts (``scripts/torch_step_profile.py::GROUPS``,
``scripts/torch_trainer_profile.py::_union_us``), frozen here. The events
are the profiler's raw records (``kineto_results.events()``), read once:
a DenseUNet window launches tens of thousands of kernels an iteration.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

SPANS = ("trainer.fetch", "trainer.copy", "trainer.augment", "trainer.step")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
CUTMIX_KERNEL = "cutmix_blend_kernel"

GROUPS = (
    ("cutmix_blend", "cutmix kernel"),
    ("multi_tensor_apply", "optimiser + EMA (foreach)"),
    ("softmax", "softmax / log-softmax"),
    ("upsample", "upsample"),
    ("max_pool", "max pool"),
    ("gather", "gather"),
    ("reduce", "reductions"),
    ("conv", "convolution"), ("xmma", "convolution"), ("cudnn", "convolution"),
    ("gemm", "convolution"), ("cutlass", "convolution"), ("sm90", "convolution"),
    ("nvjet", "convolution"),
    ("wgrad", "convolution"), ("dgrad", "convolution"),
    ("nchw", "layout transforms"), ("nhwc", "layout transforms"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("unrolled", "elementwise"), ("copy", "elementwise"),
)


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for sub, g in GROUPS if sub in low), "other")


def union(intervals) -> List[Tuple[int, int]]:
    """Merged [start, end) intervals, in order."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _Spans:
    """The trainer spans of the main thread, to look up by time."""

    def __init__(self, spans: List[Tuple[int, int, str]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.spans[i][1]:
            return self.spans[i][2]
        return None


def kind_of(e) -> str:
    """The profiler's activity type of an event (kernel, gpu_memcpy,
    gpu_memset, gpu_user_annotation, user_annotation, cuda_runtime,
    cpu_op), from ``activity_type()`` where the installed PyTorch has it,
    else from the device and the name."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    name = e.name()
    user = getattr(e, "is_user_annotation", None)
    if str(e.device_type()).endswith("CUDA"):
        if name in SPANS or (user is not None and user()):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name in SPANS or (user is not None and user()):
        return "user_annotation"
    if name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def summarise(events, iterations: int, window_s: float) -> Dict[str, object]:
    """``events``: the profiler's raw events (name(), activity_type(),
    start_ns(), duration_ns(), correlation_id(), linked_correlation_id())
    of a traced window of ``iterations`` iterations that lasted
    ``window_s`` on the host's clock (the profiler started just before its
    first iteration and stopped after the device finished its last)."""
    spans, runtime_at, op_at, device = [], {}, {}, []
    for e in events:
        kind = kind_of(e)
        if kind in DEVICE_KINDS:
            s = e.start_ns()
            device.append((s, s + e.duration_ns(), kind, e.name(),
                           e.correlation_id(), e.linked_correlation_id()))
        elif kind == "user_annotation" and e.name() in SPANS:
            s = e.start_ns()
            spans.append((s, s + e.duration_ns(), e.name()))
        elif kind in ("cuda_runtime", "cuda_driver"):
            runtime_at[e.correlation_id()] = e.start_ns()
        elif kind == "cpu_op":
            op_at[e.correlation_id()] = e.start_ns()
    if not spans:
        raise RuntimeError("the profiler recorded no trainer span")
    t0_ns = min(s for s, _, _ in spans)
    t1_ns = max([e for _, e, _ in spans] + [d[1] for d in device])
    lookup = _Spans(spans)
    host_ns = collections.Counter()
    for s, e, name in spans:
        host_ns[name] += e - s
    group_ns, op_ns = collections.Counter(), collections.Counter()
    span_dev_ns, span_launches = collections.Counter(), collections.Counter()
    cutmix_ns, cutmix_n, attributed = 0, 0, 0
    for s, e, kind, name, cid, lcid in device:
        dur = e - s
        if kind != "kernel":
            group_ns[kind] += dur
            continue
        group_ns[group_of(name)] += dur
        op_ns[name] += dur
        if CUTMIX_KERNEL in name:
            cutmix_ns += dur
            cutmix_n += 1
        t = runtime_at.get(cid)
        if t is None:
            t = op_at.get(lcid)
        span = lookup.at(t) if t is not None else None
        if span is not None:
            attributed += 1
            span_dev_ns[span] += dur
            span_launches[span] += 1
    busy = union((s, e) for s, e, *_ in device)
    busy_ns = sum(e - s for s, e in busy)
    gaps = collections.Counter()
    prev = t0_ns
    for s, e in busy + [(t1_ns, t1_ns)]:
        if s > prev:
            gaps[lookup.at(prev) or "outside the trainer spans"] += s - prev
        prev = max(prev, e)
    n = max(iterations, 1)
    kernels = sum(1 for d in device if d[2] == "kernel")
    return {
        "iterations": iterations,
        "window_s": window_s,
        "busy_s": busy_ns / 1e9,
        "host_ms_per_iter": {k: host_ns[k] / n / 1e6 for k in SPANS},
        "device_ms_per_iter_by_group": {g: v / n / 1e6 for g, v in group_ns.most_common()},
        "device_ms_per_iter_by_span": {k: span_dev_ns[k] / n / 1e6 for k in SPANS},
        "launches_per_iter_by_span": {k: span_launches[k] / n for k in SPANS},
        "kernels_per_iter": kernels / n,
        "kernels_attributed": attributed / max(kernels, 1),
        "cutmix_launches": cutmix_n,
        "cutmix_s": cutmix_ns / 1e9,
        "device_ops": [[name[:120], v / 1e9] for name, v in op_ns.most_common(10)],
        "idle_gaps": [[name, v / 1e9] for name, v in gaps.most_common(10)],
    }
