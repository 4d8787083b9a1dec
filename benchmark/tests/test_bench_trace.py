"""The trace arithmetic and every per-layer reader on a synthetic event
list whose sums are known."""

import importlib

import pytest

from benchmark import recipe, trace
from benchmark.tests.tiny import cells


class Ev:
    def __init__(self, kind, name, start, dur, cid=0, lcid=0):
        self.kind, self._name, self.start, self.dur, self.cid, self.lcid = \
            kind, name, start, dur, cid, lcid

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def correlation_id(self):
        return self.cid

    def linked_correlation_id(self):
        return self.lcid


MS = 1_000_000


def events(iterations=2):
    """Each iteration 100 ms: fetch 0-10, copy 10-20, augment 20-40, step
    40-100 ms; an augment kernel of 5 ms, a conv of 30 ms and a CutMix blend
    of 0.02 ms from the step, an elementwise kernel of 10 ms launched by a
    cpu op, a 2 ms copy."""
    out, cid = [], 1
    for i in range(iterations):
        t = i * 100 * MS
        for name, a, b in (("trainer.fetch", 0, 10), ("trainer.copy", 10, 20),
                           ("trainer.augment", 20, 40), ("trainer.step", 40, 100)):
            out.append(Ev("user_annotation", name, t + a * MS, (b - a) * MS))
        launches = (("elementwise_kernel<aug>", 21, 22, 5), ("sm90_xmma_conv", 41, 45, 30),
                    (trace.CUTMIX_KERNEL + "<float, 4>", 42, 80, 0.02))
        for name, at, dev_at, dur in launches:
            out.append(Ev("cuda_runtime", "cudaLaunchKernel", t + at * MS, 1000, cid=cid))
            out.append(Ev("kernel", name, t + dev_at * MS, int(dur * MS), cid=cid))
            cid += 1
        out.append(Ev("cpu_op", "aten::add", t + 50 * MS, 1000, cid=10_000 + i))
        out.append(Ev("kernel", "vectorized_elementwise_kernel", t + 81 * MS, 10 * MS,
                      cid=99_999, lcid=10_000 + i))
        out.append(Ev("gpu_memcpy", "Memcpy HtoD", t + 12 * MS, 2 * MS))
    return out


def test_summary_sums():
    s = trace.summarise(events(), 2, 0.2)
    assert s["host_ms_per_iter"] == pytest.approx(
        {"trainer.fetch": 10, "trainer.copy": 10, "trainer.augment": 20, "trainer.step": 60})
    assert s["device_ms_per_iter_by_span"]["trainer.augment"] == pytest.approx(5)
    assert s["device_ms_per_iter_by_span"]["trainer.step"] == pytest.approx(40.02)
    assert s["launches_per_iter_by_span"]["trainer.step"] == pytest.approx(3)
    assert s["kernels_attributed"] == 1.0
    assert s["device_ms_per_iter_by_group"]["convolution"] == pytest.approx(30)
    assert s["device_ms_per_iter_by_group"]["elementwise"] == pytest.approx(15)
    assert s["cutmix_launches"] == 2
    # busy: 2 + 5 + 30 + 0.02 + 10 ms an iteration, none overlapping
    assert s["busy_s"] == pytest.approx(2 * 47.02e-3)
    assert sum(v for _, v in s["idle_gaps"]) == pytest.approx(
        (200 - 94.04) * 1e-3 - 0.0, abs=1e-9)


class BareEv(Ev):
    """An event of a PyTorch whose raw events have no activity_type()."""

    activity_type = None

    def __init__(self, ev):
        super().__init__(ev.kind, ev._name, ev.start, ev.dur, ev.cid, ev.lcid)

    def device_type(self):
        return "DeviceType.CUDA" if self.kind in trace.DEVICE_KINDS else "DeviceType.CPU"

    def is_user_annotation(self):
        return self.kind == "user_annotation"


def test_summary_without_activity_type():
    assert trace.summarise([BareEv(e) for e in events()], 2, 0.2) == \
        trace.summarise(events(), 2, 0.2)


@pytest.mark.parametrize("name", cells())
def test_readers(name):
    cell = recipe.load_cell(name)
    s = trace.summarise(events(), 2, 0.2)

    def read(name):
        return importlib.import_module(f"benchmark.metrics.{name}").read(s, cell)

    assert read("fetch_ms") == pytest.approx(10)
    assert read("step_host_ms") == pytest.approx(60)
    assert read("augment_device_ms") == pytest.approx(5)
    assert read("step_launches") == pytest.approx(3)
    assert read("elementwise_ms") == pytest.approx(15)
    assert read("device_idle_share") == pytest.approx(100 * (1 - 0.09404 / 0.2))
    counts = cell["workload"]["counts"]
    assert read("conv_roofline") == pytest.approx(
        100 * counts["conv_flops_per_iter"] / 0.030 / 989e12)
    assert read("cutmix_roofline") == pytest.approx(
        100 * counts["cutmix_bytes"] / 3.35e12 / 0.02e-3)
    assert read("mfu") == pytest.approx(100 * counts["model_flops_per_iter"] * 2 / 0.2 / 989e12)
    s.update(img_per_s=100.0, state_gib=1.5, transient_gib=3.25)
    assert read("img_per_s_traced") == 100.0
    assert read("state_gib") == 1.5 and read("transient_gib") == 3.25


@pytest.mark.parametrize("name", cells())
def test_readers_find_nothing(name):
    """A trace without the kernel or its group gives no reading, not 0."""
    cell = recipe.load_cell(name)
    evs = [e for e in events() if trace.CUTMIX_KERNEL not in e.name() and "conv" not in e.name()]
    s = trace.summarise(evs, 2, 0.2)
    s.update(state_gib=None, transient_gib=None)  # as off a CUDA device
    for name in ("cutmix_roofline", "conv_roofline", "state_gib", "transient_gib"):
        assert importlib.import_module(f"benchmark.metrics.{name}").read(s, cell) is None
