"""The train step's phase split of a traced window: for each phase span the
port's steps open inside ``trainer.step`` (``step.perturb``,
``step.teacher``, ``step.student``, ``step.backward``, ``step.update``)
and for the step's "other" (inside ``trainer.step``, outside every phase),
per iteration: host ms in the span, kernels launched from it, device ms of
those kernels, CutMix launches among them, and device idle ms whose gap
starts inside it.

It reads the same raw events as ``trace.summarise`` and matches kernels to
their launch the same way (correlation ids, ``trace.kind_of``); the busy
union is ``trace.union``'s. The phases are disjoint siblings inside the
step, so the innermost span at a launch is its phase where one is open, and
the step's "other" where none is. A trace without phase spans (a program
older than them) gives "other" alone.
"""

from __future__ import annotations

import collections
from typing import Dict

from benchmark import trace

STEP = "trainer.step"
PHASES = ("step.perturb", "step.teacher", "step.student", "step.backward", "step.update")
OTHER = "other"
KEYS = ("host_ms", "launches", "device_ms", "idle_ms", "cutmix_launches")


def summarise(events, iterations: int) -> Dict[str, object]:
    """``{"step_phases": {phase: {key: per iteration}}, "step_phase_cover":
    {"host_ms": %, "launches": %}}``: phases by their name without
    ``step.``, those absent from the trace left out, and "other"; the cover
    is the phases' share of the step's host time and of its launches."""
    steps, phases, runtime_at, op_at, device = [], [], {}, {}, []
    t0 = None  # where trace.summarise starts its walk over the idle gaps
    for e in events:
        kind = trace.kind_of(e)
        if kind in trace.DEVICE_KINDS:
            s = e.start_ns()
            device.append((s, s + e.duration_ns(), kind, e.name(),
                           e.correlation_id(), e.linked_correlation_id()))
        elif kind == "user_annotation" and e.name() in PHASES + trace.SPANS:
            s = e.start_ns()
            if e.name() in trace.SPANS:
                t0 = s if t0 is None else min(t0, s)
            if e.name() in PHASES + (STEP,):
                (steps if e.name() == STEP else phases).append(
                    (s, s + e.duration_ns(), e.name()))
        elif kind in ("cuda_runtime", "cuda_driver"):
            runtime_at[e.correlation_id()] = e.start_ns()
        elif kind == "cpu_op":
            op_at[e.correlation_id()] = e.start_ns()
    in_step, in_phase = trace._Spans(steps), trace._Spans(phases)

    def where(t):
        if t is None or in_step.at(t) is None:
            return None
        return in_phase.at(t) or OTHER

    sums = collections.defaultdict(collections.Counter)
    for s, e, name in phases:
        sums[name]["host_ms"] += e - s
    sums[OTHER]["host_ms"] = (sum(e - s for s, e, _ in steps)
                              - sum(sums[p]["host_ms"] for p in PHASES))
    for s, e, kind, name, cid, lcid in device:
        if kind != "kernel":
            continue
        t = runtime_at.get(cid)
        span = where(t if t is not None else op_at.get(lcid))
        if span is not None:
            sums[span]["launches"] += 1
            sums[span]["device_ms"] += e - s
            sums[span]["cutmix_launches"] += int(trace.CUTMIX_KERNEL in name)
    busy = trace.union((s, e) for s, e, *_ in device)
    t1 = max([e for _, e, _ in steps] + [d[1] for d in device], default=0)
    prev = t0 if t0 is not None else t1
    for s, e in busy + [(t1, t1)]:
        if s > prev:
            span = where(prev)
            if span is not None:
                sums[span]["idle_ms"] += s - prev
        prev = max(prev, e)
    n = max(iterations, 1)
    ns_keys = ("host_ms", "device_ms", "idle_ms")
    out = {}
    present = {name for _, _, name in phases}
    for name in PHASES + (OTHER,):
        if name in present or name == OTHER:
            out[name.replace("step.", "")] = {
                k: sums[name][k] / n / (1e6 if k in ns_keys else 1) for k in KEYS}
    step_host = sum(e - s for s, e, _ in steps)
    step_launches = sum(sums[k]["launches"] for k in PHASES + (OTHER,))
    cover = {"host_ms": 100.0 * sum(sums[p]["host_ms"] for p in PHASES) / max(step_host, 1),
             "launches": 100.0 * sum(sums[p]["launches"] for p in PHASES)
             / max(step_launches, 1)}
    return {"step_phases": out, "step_phase_cover": cover}
