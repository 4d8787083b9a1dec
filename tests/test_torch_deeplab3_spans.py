"""The profiler spans of the DeepLab v3 heads (``models/deeplab3.py``):
``model.aspp`` around the ASPP and, in v3+, ``model.decoder`` around the
decoder. On the CPU an eager tiny mask_mt step under the profiler records
each once per forward of the net (one teacher and one student forward
under frozen BN, two each with training BN). On the card (``-m cuda``) a
replay of the step's CUDA graph records neither, while its first, eager,
call does."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from cutmix_seg_tpu_torch.core import train_state as tts
from cutmix_seg_tpu_torch.models import deeplab3
from cutmix_seg_tpu_torch.models.common import SegModel
from cutmix_seg_tpu_torch.semisup import mask_mt

torch.set_num_threads(1)

C, N, HW = 4, 2, (33, 33)
SPANS = ("model.aspp", "model.decoder")
NETS = {"v3plus": deeplab3.DeepLabV3Plus, "v3": deeplab3.DeepLabV3}


def _model(arch):
    return SegModel("tiny", NETS[arch](C, layers=(1, 1, 1, 1)), np.zeros(3), np.ones(3),
                    (1, 1), deeplab3._label_imagenet)


def _batch(device, seed):
    g = torch.Generator().manual_seed(seed)

    def img():
        return torch.randn(N, *HW, 3, generator=g)

    b = {"sup_x": img(), "sup_y": torch.randint(0, C, (N, *HW), generator=g)}
    for k in ("ux0", "ux1"):
        b[f"{k}_tea"] = img()
        b[f"{k}_stu"] = b[f"{k}_tea"] + 0.3 * img()
    for k in ("um0", "um1"):
        b[k] = torch.ones(N, *HW, 1)
    return {k: v.to(device) for k, v in b.items()}


def _step(arch, device, freeze_bn):
    model = _model(arch)
    state, opt = tts.create_train_state(model, tts.OptimizerConfig(learning_rate=1e-4), 0,
                                        device=device, pretrained=False)
    cfg = mask_mt.MaskConsistencyConfig(conf_thresh=0.3, freeze_bn=freeze_bn)
    return state, mask_mt.make_mask_mt_step(model, opt, cfg)


def _span_counts(prof):
    """Host-side records of each span (with CUDA activity the profiler adds
    a device-side annotation of the same name)."""
    counts = dict.fromkeys(SPANS + ("step.replay",), 0)
    for e in prof.events():
        if e.name in counts and e.device_type == DeviceType.CPU:
            counts[e.name] += 1
    return counts


class _Forwards:
    """Counts the forwards of a state's student and teacher."""

    def __init__(self, state):
        self.n = 0
        for net in (state.student, state.teacher):
            net.register_forward_hook(self._hook)

    def _hook(self, *_):
        self.n += 1


@pytest.mark.parametrize("arch,freeze_bn", [("v3plus", True), ("v3plus", False),
                                            ("v3", True)])
def test_an_eager_step_records_each_span_once_per_forward(arch, freeze_bn):
    state, step = _step(arch, "cpu", freeze_bn)
    forwards = _Forwards(state)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, _batch("cpu", 0), 1.0)
    assert torch.isfinite(metrics["sup_loss"])
    assert forwards.n == (2 if freeze_bn else 4)
    counts = _span_counts(prof)
    assert counts["model.aspp"] == forwards.n
    assert counts["model.decoder"] == (forwards.n if arch == "v3plus" else 0)
    assert counts["step.replay"] == 0


@pytest.mark.cuda
def test_a_graph_replay_records_no_span_of_the_head():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the card)")
    state, step = _step("v3plus", "cuda", True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def profiled(k):
        with torch.profiler.profile(activities=acts) as prof:
            step(state, _batch("cuda", k), 1.0)
            torch.cuda.synchronize()
        return _span_counts(prof)

    eager = profiled(0)
    step(state, _batch("cuda", 1), 1.0)  # the capture, outside the profiler
    replay = profiled(2)
    assert step.counters() == {"captures": 1, "replays": 2, "eager_steps": 1}
    assert eager == {"model.aspp": 2, "model.decoder": 2, "step.replay": 0}
    assert replay == {"model.aspp": 0, "model.decoder": 0, "step.replay": 1}
