"""The step's phase split (``benchmark/phases.py``) on the synthetic event
list of ``test_bench_trace.py`` with phase spans and a kernel launched from
each phase added inside ``trainer.step``: known sums per phase and for the
step's "other", and ``trace.summarise`` unmoved by the phase spans."""

import pytest

from benchmark import phase_run, phases, trace
from benchmark.tests.test_bench_trace import MS, BareEv, Ev, events

# (name, start ms, end ms) inside each iteration's trainer.step (40-100 ms)
PHASE_SPANS = (("step.perturb", 41.5, 44), ("step.teacher", 44, 62), ("step.student", 62, 74),
               ("step.backward", 74, 88), ("step.update", 88, 99.5))
# (launched at ms, device start ms, device ms): from perturb, student,
# backward and update
PHASE_KERNELS = ((42.5, 42.6, 0.4), (65, 92, 1), (75, 94, 2), (95, 97, 1))


def phase_events(iterations=2):
    """``events()`` with the phase spans and their kernels: the conv
    (launched at 41 ms) is the step's "other", the CutMix blend (42 ms)
    perturb's, the elementwise kernel of the op at 50 ms the teacher's."""
    out, cid = events(iterations), 50_000
    for i in range(iterations):
        t = i * 100 * MS
        for name, a, b in PHASE_SPANS:
            out.append(Ev("user_annotation", name, t + int(a * MS), int((b - a) * MS)))
        for at, dev_at, dur in PHASE_KERNELS:
            out.append(Ev("cuda_runtime", "cudaLaunchKernel", t + int(at * MS), 1000, cid=cid))
            out.append(Ev("kernel", "reduce_kernel", t + int(dev_at * MS), int(dur * MS),
                          cid=cid))
            cid += 1
    return out


# per iteration; idle: the gaps after the perturb kernel (43-45 ms), after
# the conv and the blend (75-80, 80.02-81 ms) and after each update-time
# kernel (91-92, 93-94, 96-97, then 98 ms to the next copy at 112 ms, or to
# the window's end at 200 ms)
WANT = {
    "perturb": dict(host_ms=2.5, launches=2, device_ms=0.42, idle_ms=2, cutmix_launches=1),
    "teacher": dict(host_ms=18, launches=1, device_ms=10, idle_ms=0, cutmix_launches=0),
    "student": dict(host_ms=12, launches=1, device_ms=1, idle_ms=0, cutmix_launches=0),
    "backward": dict(host_ms=14, launches=1, device_ms=2, idle_ms=5.98, cutmix_launches=0),
    "update": dict(host_ms=11.5, launches=1, device_ms=1, idle_ms=(3 + 14 + 3 + 2) / 2,
                   cutmix_launches=0),
    "other": dict(host_ms=2, launches=1, device_ms=30, idle_ms=0, cutmix_launches=0),
}


def test_phase_sums():
    s = phases.summarise(phase_events(), 2)
    assert list(s["step_phases"]) == list(WANT)
    for name, want in WANT.items():
        assert s["step_phases"][name] == pytest.approx(want), name
    assert s["step_phase_cover"] == pytest.approx({"host_ms": 100 * 58 / 60,
                                                   "launches": 100 * 6 / 7})


def _idle_in_step(evs, iterations=2):
    """trace.summarise's idle ms per iteration in trainer.step."""
    gaps = dict(trace.summarise(evs, iterations, 0.2)["idle_gaps"])
    return gaps.get("trainer.step", 0) * 1e3 / iterations


@pytest.mark.parametrize("first_span", ["trainer.fetch", "trainer.step"])
def test_phase_idle_sums_to_the_step_idle_of_the_trace(first_span):
    """The phases and "other" split the idle time that trace.summarise puts
    in trainer.step, also where the window opens with the step: a gap from
    the step's start to its first kernel (42.6 ms) is the step's "other"."""
    evs = phase_events()
    if first_span == "trainer.step":  # the first iteration's fetch to augment left out
        evs = [e for e in evs if e.start >= 40 * MS or e.kind == "cpu_op"]
    s = phases.summarise(evs, 2)["step_phases"]
    assert sum(p["idle_ms"] for p in s.values()) == pytest.approx(_idle_in_step(evs))
    extra = (42.6 - 40) / 2 if first_span == "trainer.step" else 0
    assert s["other"]["idle_ms"] == pytest.approx(WANT["other"]["idle_ms"] + extra)


def test_phase_sums_without_activity_type():
    evs = phase_events()
    assert phases.summarise([BareEv(e) for e in evs], 2) == phases.summarise(evs, 2)


def test_trace_summary_unmoved_by_the_phase_spans():
    """The per-layer metrics' summary is the same dict with and without the
    phase spans in the events."""
    evs = phase_events()
    bare = [e for e in evs if e.name() not in phases.PHASES]
    assert len(bare) == len(evs) - 2 * len(PHASE_SPANS)
    assert trace.summarise(evs, 2, 0.2) == trace.summarise(bare, 2, 0.2)


def test_no_phase_spans_gives_other_alone():
    """A program without the phase spans: the whole step is "other"."""
    s = phases.summarise(events(), 2)
    assert list(s["step_phases"]) == ["other"]
    assert s["step_phases"]["other"]["host_ms"] == pytest.approx(60)
    assert s["step_phases"]["other"]["launches"] == pytest.approx(3)
    assert s["step_phase_cover"] == {"host_ms": 0.0, "launches": 0.0}


def test_phase_run_wraps_the_trace_summary():
    captured, evs = {}, phase_events()
    wrapped = phase_run.with_phases(trace.summarise, captured)
    assert wrapped(iter(evs), 2, 0.2) == trace.summarise(evs, 2, 0.2)
    assert captured == phases.summarise(evs, 2)
