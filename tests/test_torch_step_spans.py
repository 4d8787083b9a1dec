"""The train steps' phase spans (``step.perturb``, ``step.teacher``,
``step.student``, ``step.backward``, ``step.update``; ``semisup.stepcore``)
on the CPU: a tiny step of each algorithm under ``torch.profiler`` inside a
``trainer.step`` span, at ``grad_accum`` 1 and 2. The phases come in the
step's order, each as often as the step runs it (once per chunk inside the
chunk loop, else once per step), inside ``trainer.step`` and overlapping no
other phase. The trainer's ``--profile_dir`` trace holds them inside
``trainer.step``, and the profiler changes no bit of a step."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cutmix_seg_tpu_torch.core import train_state as tts
from cutmix_seg_tpu_torch.models.common import SegModel
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label
from cutmix_seg_tpu_torch.semisup import aug_cons, ict, mask_mt, vat
from tests._torch_tmp import drop_tmp_path_if_passed  # noqa: F401
from tests.test_torch_trainer import _submit, voc  # noqa: F401

torch.set_num_threads(1)

N, HW, C = 2, (17, 17), 4
PHASES = ("step.perturb", "step.teacher", "step.student", "step.backward", "step.update")
COMMON = dict(cons_weight=1.0, conf_thresh=0.34, conf_per_pixel=True)

# name: (step factory, config class, config kwargs, batch kind, phases of
# one chunk, whether perturb runs once per step before the chunks)
CASES = {
    "mask_mt_mix": (mask_mt.make_mask_mt_step, mask_mt.MaskConsistencyConfig,
                    dict(mask_mode="mix"), "mix", ("teacher",), True),
    "mask_mt_cutout": (mask_mt.make_mask_mt_step, mask_mt.MaskConsistencyConfig,
                       dict(mask_mode="zero"), "zero", ("teacher",), True),
    "ict": (ict.make_ict_step, ict.ICTConfig, dict(ict_alpha=0.5), "mix", ("teacher",), True),
    "vat": (vat.make_vat_step, vat.VATConfig, dict(adaptive_vat_radius=True), "zero",
            ("perturb", "teacher"), False),
    "aug_mt": (aug_cons.make_aug_cons_step, aug_cons.AugConsConfig, {}, "aug",
               ("teacher", "perturb"), False),
}


def _batch(kind, seed=0):
    g = torch.Generator().manual_seed(seed)

    def img():
        return torch.randn(N, *HW, 3, generator=g)

    def mask():
        return (torch.rand(N, *HW, 1, generator=g) > 0.2).float()

    labels = torch.randint(0, C, (N, *HW), generator=g)
    labels[torch.rand(N, *HW, generator=g) < 0.1] = 255
    b = {"sup_x": img(), "sup_y": labels}
    if kind == "mix":
        for k in ("ux0", "ux1"):
            b[f"{k}_tea"] = img()
            b[f"{k}_stu"] = b[f"{k}_tea"] + 0.3 * img()
        b["um0"], b["um1"] = mask(), mask()
    elif kind == "zero":
        b["ux_tea"] = img()
        b["ux_stu"] = b["ux_tea"] + 0.3 * img()
        b["um"] = mask()
    else:
        b.update(ux0=img(), ux1=img(), um0=mask(), um1=mask())
        b["xf0_to_1"] = torch.eye(2, 3).repeat(N, 1, 1) + 0.1 * torch.rand(N, 2, 3, generator=g)
    return b


def _step(case, grad_accum=1):
    make, cfg_cls, kw, kind, _, _ = CASES[case]
    torch.manual_seed(0)
    model = SegModel("tiny", DeepLab2(C, layers=(1, 1, 1, 1)), np.zeros(3), np.ones(3),
                     (1, 1), _param_label)
    state, opt = tts.create_train_state(model, tts.OptimizerConfig(learning_rate=3e-4), 0,
                                        device="cpu", pretrained=False)
    step = make(model, opt, cfg_cls(grad_accum=grad_accum, **COMMON, **kw))
    return state, step, _batch(kind)


def _spans(events):
    """{name: [(start, end), ...]} of the trainer.step and phase spans."""
    out = {}
    for e in events:
        if e.activity_type() == "user_annotation" and e.name() in PHASES + ("trainer.step",):
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _expected(case, grad_accum):
    _, _, _, _, chunk, once = CASES[case]
    per_chunk = [f"step.{p}" for p in chunk] + ["step.student", "step.backward"]
    return (["step.perturb"] if once else []) + per_chunk * grad_accum + ["step.update"]


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_phase_spans_tile_the_step(case, grad_accum):
    state, step, batch = _step(case, grad_accum)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("trainer.step"):
            step(state, batch, 1.0)
    spans = _spans(prof.profiler.kineto_results.events())
    (s0, s1), = spans.pop("trainer.step")
    phases = sorted((s, e, name) for name, v in spans.items() for s, e in v)
    assert [name for _, _, name in phases] == _expected(case, grad_accum)
    assert all(s0 <= s and e <= s1 for s, e, _ in phases)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))  # disjoint siblings


def test_profile_dir_trace_holds_the_phases(voc, tmp_path):  # noqa: F811
    """--profile_dir traces iteration 2 of a 3-iteration epoch: its
    trainer.step span holds each phase once, in the step's order."""
    prof = tmp_path / "prof"
    eng = _submit(tmp_path / "results", "prof", num_epochs=1, iters_per_epoch=3,
                  save_model=False, profile_dir=str(prof))
    assert eng.state.step == 3
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    (s0, s1), = spans["trainer.step"]
    phases = sorted((s, e, name) for name in PHASES for s, e in spans.get(name, ()))
    assert [name for _, _, name in phases] == list(PHASES)
    assert all(s0 <= s and e <= s1 for s, e, _ in phases)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))


def test_profiler_changes_no_bit():
    """Each algorithm's step, with and without the profiler, from equal
    states: equal metrics and parameters, bit for bit."""
    for case in sorted(CASES):
        runs = []
        for traced in (False, True):
            state, step, batch = _step(case, grad_accum=2)
            if traced:
                with profile(activities=[ProfilerActivity.CPU]):
                    with record_function("trainer.step"):
                        state, metrics = step(state, batch, 1.0)
            else:
                state, metrics = step(state, batch, 1.0)
            runs.append((metrics, state.student.state_dict(), state.teacher.state_dict()))
        (m0, s0, t0), (m1, s1, t1) = runs
        assert m0.keys() == m1.keys() and all(torch.equal(m0[k], m1[k]) for k in m0), case
        for a, b in ((s0, s1), (t0, t1)):
            assert all(torch.equal(a[k], b[k]) for k in a), case
