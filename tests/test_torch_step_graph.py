"""The mask_mt step replayed as a CUDA graph (``semisup.step_graph``).

On the CPU: the host scalars that now reach the device in one tensor
(learning rates, Adam's bias corrections, ramp) and the constants built on
the device (the box sides, sqrt(num_classes)) give the same bits as the
Python-float expressions they replace; and the wrapper's decisions, with
the capture stubbed out (eager where no graph can stand in, warm-up, capture,
replay, capture again after any change it can observe; the batch consumed;
the returned metrics kept from the next replay; the host counters advanced
as the body advances them; the counters). On the card
(``-m cuda``): five iterations of small DenseUNet mask_mt steps through
the graph and through the eager step end in the same student, teacher,
optimiser state and generator state, bit for bit."""

import numpy as np
import pytest
import torch

from cutmix_seg_tpu_torch.core import train_state as tts
from cutmix_seg_tpu_torch.core.schedules import make_lr_schedule
from cutmix_seg_tpu_torch.masks import box_mask
from cutmix_seg_tpu_torch.models.common import SegModel, label_params_by_path
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label
from cutmix_seg_tpu_torch.models.denseunet import DenseUNet
from cutmix_seg_tpu_torch.parallel.mesh import Mesh
from cutmix_seg_tpu_torch.semisup import losses as L
from cutmix_seg_tpu_torch.semisup import mask_mt, step_graph, stepcore

torch.set_num_threads(1)

N, HW, C = 2, (17, 17), 4
STEPS = 5


def _tiny_deeplab():
    return SegModel("tiny", DeepLab2(C, layers=(1, 1, 1, 1)), np.zeros(3), np.ones(3),
                    (1, 1), _param_label)


def _tiny_denseunet():
    label = lambda m: label_params_by_path(m, [("features", "pretrained")])  # noqa: E731
    return SegModel("tiny", DenseUNet(C, block_config=(2, 2, 2, 2)), np.zeros(3), np.ones(3),
                    (1, 1), label)


def _batch(n, hw, device, seed, kind="mix"):
    g = torch.Generator().manual_seed(seed)

    def img():
        return torch.randn(n, *hw, 3, generator=g)

    labels = torch.randint(0, C, (n, *hw), generator=g)
    labels[torch.rand(n, *hw, generator=g) < 0.1] = 255
    b = {"sup_x": img(), "sup_y": labels}
    if kind == "mix":
        for k in ("ux0", "ux1"):
            b[f"{k}_tea"] = img()
            b[f"{k}_stu"] = b[f"{k}_tea"] + 0.3 * img()
        b["um0"] = (torch.rand(n, *hw, 1, generator=g) > 0.2).float()
        b["um1"] = (torch.rand(n, *hw, 1, generator=g) > 0.2).float()
    else:
        b["ux_tea"] = img()
        b["ux_stu"] = b["ux_tea"] + 0.3 * img()
        b["um"] = (torch.rand(n, *hw, 1, generator=g) > 0.2).float()
    return {k: v.to(device) for k, v in b.items()}


# ---- the arithmetic: device scalars and constants against Python floats ----

def _python_float_update(opt):
    """The update with its scalars as Python floats (the expressions the
    device scalars replace)."""
    with torch.no_grad():
        for g in opt.groups:
            lr = opt.sched(opt.count) * g.scale
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in g.params]
            if opt.cfg.opt_type == "adam":
                mu, nu = g.state["mu"], g.state["nu"]
                torch._foreach_mul_(mu, tts.ADAM_B1)
                torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - tts.ADAM_B1))
                sq = torch._foreach_mul(grads, grads)
                torch._foreach_mul_(sq, 1.0 - tts.ADAM_B2)
                torch._foreach_mul_(nu, tts.ADAM_B2)
                torch._foreach_add_(nu, sq)
                t = opt.count + 1
                denom = torch._foreach_div(nu, tts._bias_correction(tts.ADAM_B2, t))
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, tts.ADAM_EPS)
                updates = torch._foreach_div(mu, tts._bias_correction(tts.ADAM_B1, t))
                torch._foreach_div_(updates, denom)
            else:
                updates = opt._sgd(g, grads)
            torch._foreach_mul_(updates, -lr)
            torch._foreach_add_(g.params, updates)
    opt.count += 1


OPTIMIZERS = {
    "adam": tts.OptimizerConfig(opt_type="adam", learning_rate=3e-4),
    "sgd_poly": tts.OptimizerConfig(
        opt_type="sgd", learning_rate=0.1, sgd_momentum=0.9, sgd_weight_decay=5e-4,
        lr_schedule=make_lr_schedule("poly", 0.1, 7, poly_power=0.9)),
    "sgd_nesterov_stepped": tts.OptimizerConfig(
        opt_type="sgd", learning_rate=0.05, sgd_momentum=0.9, sgd_nesterov=True,
        lr_schedule=make_lr_schedule("stepped", 0.05, 8, step_epochs=[1, 2],
                                     iters_per_epoch=2)),
}


@pytest.mark.parametrize("path", ["own_copy", "step_scalars"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_device_scalar_update_is_the_python_float_update(name, path):
    """Over 5 updates with both label groups, the device-scalar update leaves
    the parameters and moments of the Python-float update, bit for bit."""
    opts = []
    for _ in range(2):
        model = _tiny_deeplab()
        state, opt = tts.create_train_state(model, OPTIMIZERS[name], 0, device="cpu",
                                            mean_teacher=False, pretrained=False)
        opts.append((state.student, opt))
    assert [g.scale for g in opts[0][1].groups] == [0.1, 1.0]
    g = torch.Generator().manual_seed(1)
    for _ in range(STEPS):
        grads = [torch.randn(p.shape, generator=g) for p in opts[0][0].parameters()]
        for net, _ in opts:
            for p, gr in zip(net.parameters(), grads):
                p.grad = gr.clone()
        (_, new), (_, old) = opts
        if path == "step_scalars":
            assert stepcore.split_scalars(new, stepcore.step_scalars(new, 0.5, "cpu")) == 0.5
        new.step()
        assert new.device_scalars is None
        _python_float_update(old)
        for _, opt in opts:
            opt.zero_grad()
    (net_a, opt_a), (net_b, opt_b) = opts
    assert opt_a.count == opt_b.count == STEPS
    for a, b in zip(net_a.parameters(), net_b.parameters()):
        assert torch.equal(a, b)
    for ga, gb in zip(opt_a.groups, opt_b.groups):
        for k in ga.state:
            assert all(torch.equal(a, b) for a, b in zip(ga.state[k], gb.state[k]))


def test_scalar_values_round_once_to_float32():
    opt = tts.Optimizer(OPTIMIZERS["sgd_poly"], {"w": torch.nn.Parameter(torch.zeros(3))},
                        {"w": "new"})
    opt.count = 3
    want = -(opt.sched(3) * 1.0)
    got = stepcore.step_scalars(opt, 0.3, "cpu")
    assert got.dtype == torch.float32 and got.shape == (2,)
    assert got[0].item() == float(np.float32(0.3)) and got[1].item() == float(np.float32(want))


def _host_sides(mask_hw, n, dtype, device):
    """The sides as the host-copied tensor that ``box_mask._sides`` replaces."""
    return torch.tensor((list(mask_hw) * 2)[:n], dtype=dtype, device=device)


@pytest.mark.parametrize("within_bounds", [True, False])
@pytest.mark.parametrize("by_area,aspect", [(True, True), (True, False), (False, True)])
def test_box_sides_filled_on_the_device_are_the_copied_ones(monkeypatch, within_bounds,
                                                            by_area, aspect):
    cfg = box_mask.BoxMaskConfig((0.1, 0.9), n_boxes=3, random_aspect_ratio=aspect,
                                 prop_by_area=by_area, within_bounds=within_bounds)
    hw = (37, 53)
    new = box_mask.sample_box_rects(cfg, torch.Generator().manual_seed(5), 64, hw)
    masks_new = box_mask.rasterise_masks(new, hw)
    monkeypatch.setattr(box_mask, "_sides", _host_sides)
    old = box_mask.sample_box_rects(cfg, torch.Generator().manual_seed(5), 64, hw)
    assert torch.equal(new, old)
    assert torch.equal(masks_new, box_mask.rasterise_masks(old, hw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("loss_fn", ["logits_var", "logits_smoothl1"])
@pytest.mark.parametrize("classes", [2, 19, 21])
def test_root_c_filled_on_the_device_is_the_copied_one(monkeypatch, loss_fn, dtype, classes):
    g = torch.Generator().manual_seed(classes)
    stu, tea = (torch.randn(3, 5, 7, classes, generator=g) * 3 for _ in range(2))
    new = L.consistency_loss_per_pixel(loss_fn, stu, tea, dtype)
    monkeypatch.setattr(L, "_root_c", lambda x: torch.sqrt(
        torch.tensor(float(x.shape[-1]))).to(device=x.device, dtype=x.dtype))
    assert torch.equal(new, L.consistency_loss_per_pixel(loss_fn, stu, tea, dtype))


@pytest.mark.parametrize("ramp", [0.0, 0.3, 1.0])
def test_a_tensor_ramp_gives_the_float_ramps_loss(ramp):
    """student_backward with ramp as the step's 0-dim float32 tensor gives
    the metrics and gradients of ramp as a Python float."""
    cfg = mask_mt.MaskConsistencyConfig(conf_thresh=0.34, conf_per_pixel=True,
                                        cons_weight=0.7)
    batch = _batch(N, HW, "cpu", 3)
    out = []
    for r in (ramp, stepcore.step_scalars(
            tts.Optimizer(OPTIMIZERS["adam"], {}, {}), ramp, "cpu")[0]):
        torch.manual_seed(0)
        model = _tiny_deeplab()
        state, _ = tts.create_train_state(model, OPTIMIZERS["adam"], 0, device="cpu",
                                          pretrained=False)
        stepcore.prepare_nets(cfg, state)
        with torch.no_grad():
            tea = state.teacher(batch["ux0_tea"])
        conf_px = stepcore.confidence_px(cfg, torch.softmax(tea, -1).amax(-1, keepdim=True))
        m = stepcore.student_backward(
            cfg, state.student, batch, batch["ux0_stu"],
            lambda logits: L.consistency_loss_per_pixel("var", logits, tea), batch["um0"],
            conf_px, r)
        out.append((m, {n: p.grad for n, p in state.student.named_parameters()
                        if p.grad is not None}))
    (m_f, g_f), (m_t, g_t) = out
    assert all(torch.equal(m_f[k], m_t[k]) for k in m_f)
    assert g_f and sorted(g_f) == sorted(g_t)
    assert all(torch.equal(g_f[n], g_t[n]) for n in g_f)


# ---- the wrapper's decisions, with the capture stubbed out ----

class _StubGraph:
    """Stands in for a captured graph: a replay overwrites the static
    metrics, as a real one does."""

    def __init__(self, metrics):
        self.metrics = metrics
        self.replayed = 0

    def replay(self):
        self.replayed += 1
        for v in self.metrics.values():
            v.add_(1.0)


@pytest.fixture
def stub_graphs(monkeypatch):
    """Make the CPU look like a card to ``step_graph``: the side stream is
    None, work on it runs in place, and a capture runs the body once."""
    captured = []

    def capture(stream, generator, fn):
        out = fn()
        captured.append(_StubGraph(out[1]))
        return captured[-1], out

    monkeypatch.setattr(step_graph, "_graphable", lambda device: True)
    monkeypatch.setattr(step_graph, "_side_stream", lambda device: None)
    monkeypatch.setattr(step_graph, "_run_on", lambda stream, fn: fn())
    monkeypatch.setattr(step_graph, "_capture", capture)
    return captured


def _graphed(**kw):
    torch.manual_seed(0)
    model = _tiny_deeplab()
    state, opt = tts.create_train_state(model, OPTIMIZERS["adam"], 0, device="cpu",
                                        pretrained=False)
    cfg = mask_mt.MaskConsistencyConfig(conf_thresh=0.34, conf_per_pixel=True, **kw)
    return state, opt, mask_mt.make_mask_mt_step(model, opt, cfg)


def _counts(step):
    c = step.counters()
    return c["eager_steps"], c["captures"], c["replays"]


def test_eager_on_the_cpu_and_under_a_mesh():
    state, opt, step = _graphed()
    assert isinstance(step, step_graph.GraphedStep)
    for k in range(3):
        batch = _batch(N, HW, "cpu", k)
        state, m = step(state, batch, 1.0)
        assert len(batch) == 8  # not consumed off the card
    assert _counts(step) == (3, 0, 0) and state.step == opt.count == 3
    meshed = mask_mt.make_mask_mt_step(_tiny_deeplab(), opt, mask_mt.MaskConsistencyConfig(),
                                       mesh=Mesh(1, 0))
    assert isinstance(meshed, step_graph.GraphedStep) and not meshed.capturable


def test_warm_up_capture_replay_and_the_counters(stub_graphs):
    state, opt, step = _graphed()
    seen = []
    for k in range(4):
        batch = _batch(N, HW, "cpu", k)
        state, m = step(state, batch, 1.0)
        assert batch == {}  # consumed
        seen.append({n: v.clone() for n, v in m.items()})
        prev = m
    # warm-up, capture + replay, replay, replay
    assert _counts(step) == (1, 1, 3)
    assert len(stub_graphs) == 1 and stub_graphs[0].replayed == 3
    assert state.step == opt.count == 4
    # the metrics a call returned do not change on the next replay
    state, m = step(state, _batch(N, HW, "cpu", 9), 1.0)
    assert all(torch.equal(prev[n], seen[-1][n]) for n in prev)
    assert not any(m[n] is prev[n] for n in m)


def _replaced_param(state, opt):
    p = next(state.student.parameters())
    p.data = p.data.clone()


def _replaced_moment(state, opt):
    opt.groups[0].state["mu"][0] = torch.zeros_like(opt.groups[0].state["mu"][0])


def _eval_teacher(state, opt):
    state.teacher.eval()


CHANGES = {"param": _replaced_param, "moment": _replaced_moment, "eval": _eval_teacher}


@pytest.mark.parametrize("change", sorted(CHANGES) + ["shape"])
def test_any_observed_change_warms_up_and_captures_again(stub_graphs, change):
    state, opt, step = _graphed()
    for k in range(3):
        state, _ = step(state, _batch(N, HW, "cpu", k), 1.0)
    assert _counts(step) == (1, 1, 2)
    hw = HW
    if change == "shape":
        hw = (HW[0] + 4, HW[1])
    else:
        CHANGES[change](state, opt)
    for k in range(3):
        state, _ = step(state, _batch(N, hw, "cpu", 10 + k), 1.0)
    # the new signature: an eager warm-up, a new capture, a replay
    assert _counts(step) == (2, 2, 4) and len(stub_graphs) == 2
    assert stub_graphs[0].replayed == 2 and stub_graphs[1].replayed == 2


def test_a_student_holding_gradients_steps_eagerly(stub_graphs):
    state, opt, step = _graphed()
    for k in range(3):
        state, _ = step(state, _batch(N, HW, "cpu", k), 1.0)
    p = next(state.student.parameters())
    p.grad = torch.zeros_like(p)
    state, _ = step(state, _batch(N, HW, "cpu", 5), 1.0)
    assert _counts(step) == (2, 1, 2) and p.grad is None
    state, _ = step(state, _batch(N, HW, "cpu", 6), 1.0)
    assert _counts(step) == (2, 1, 3)


def test_a_step_over_a_mesh_steps_eagerly(stub_graphs):
    """The wrapper ``make_mask_mt_step`` builds over a mesh (``capturable``
    False) steps eagerly on a state the graph could take."""
    state, opt, graphed = _graphed()
    step = step_graph.GraphedStep(graphed.body, opt, capturable=False)
    for k in range(3):
        batch = _batch(N, HW, "cpu", k)
        state, _ = step(state, batch, 1.0)
        assert len(batch) == 8
    assert _counts(step) == (3, 0, 0) and state.step == opt.count == 3


def _finish_without_update(state, opt, cfg):
    """``finish_step`` that leaves the optimiser as it was (the benchmark's
    ``state_unchanged`` fault): ``state.step`` advances, ``opt.count`` not."""
    opt.zero_grad()
    state.step += 1
    return state


def test_replays_advance_the_host_counters_as_the_body_does(stub_graphs, monkeypatch):
    monkeypatch.setattr(mask_mt, "finish_step", _finish_without_update)
    state, opt, step = _graphed()
    for k in range(4):
        state, _ = step(state, _batch(N, HW, "cpu", k), 1.0)
        assert (state.step, opt.count) == (k + 1, 0)
    assert _counts(step) == (1, 1, 3)


def test_the_engine_logs_the_step_counters():
    from cutmix_seg_tpu_torch.train.engine import TrainEngine

    engine = TrainEngine(None, None, None, {})
    engine.step = lambda state, batch, ramp: (state, {})
    assert engine.step_counters() == {}
    _, _, engine.step = _graphed()
    assert engine.step_counters() == {"captures": 0, "replays": 0, "eager_steps": 0}


# ---- on the card: the graph against the eager step, bit for bit ----

# small DenseUNets (its step is deterministic with deterministic cuDNN: no
# bilinear upsampling, whose backward adds with atomics)
CUDA_CASES = {
    # the ISIC recipe's step in small: training BN, dropout, SGD with the poly schedule
    "trainbn_dropout_sgd_poly": (OPTIMIZERS["sgd_poly"], dict(freeze_bn=False), "mix"),
    # the Pascal recipe's: frozen BN, Adam
    "frozen_bn_adam": (OPTIMIZERS["adam"], {}, "mix"),
    "cutout_adam": (OPTIMIZERS["adam"],
                    dict(mask_mode="zero", box=box_mask.BoxMaskConfig((0.0, 1.0))), "zero"),
    "accum2_pi_model_sgd": (OPTIMIZERS["sgd_poly"],
                            dict(freeze_bn=False, grad_accum=2, mean_teacher=False), "mix"),
    "logits_var_bf16_adam": (OPTIMIZERS["adam"],
                             dict(cons_loss_fn="logits_var", cons_compute_dtype="bfloat16"),
                             "mix"),
    # the loss tails recomputed in the backward (torch.utils.checkpoint)
    "remat_loss_chain_trainbn_adam": (OPTIMIZERS["adam"],
                                      dict(remat_loss_chain=True, freeze_bn=False), "mix"),
}


def _run_on_card(case, graphed):
    opt_cfg, kw, kind = CUDA_CASES[case]
    n, h, w = 4, 64, 64
    model = _tiny_denseunet()
    state, opt = tts.create_train_state(model, opt_cfg, 0, device="cuda", pretrained=False,
                                        mean_teacher=kw.get("mean_teacher", True))
    cfg = mask_mt.MaskConsistencyConfig(conf_thresh=0.34, conf_per_pixel=True, **kw)
    step = mask_mt.make_mask_mt_step(model, opt, cfg)
    counters = step.counters
    if not graphed:
        body = step.body

        def step(state, batch, ramp):
            return body(state, batch, stepcore.step_scalars(opt, ramp, "cuda"))

        counters = dict
    losses = []
    for k in range(STEPS):
        state, m = step(state, _batch(n, (h, w), "cuda", k, kind), 0.2 * k)
        losses.append({n_: v.item() for n_, v in m.items()})
    torch.cuda.synchronize()
    nets = {"student": state.student, "teacher": state.teacher}
    tensors = {f"{p}.{k}": v.cpu() for p, net in nets.items() if net is not None
               for k, v in net.state_dict().items()}
    tensors.update({f"opt.{i}.{k}.{j}": t.cpu() for i, g in enumerate(opt.groups)
                    for k, ts in g.state.items() for j, t in enumerate(ts)})
    return counters(), losses, tensors, state.generator.get_state(), state.step, opt.count


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_graph_replays_are_the_eager_step_bit_for_bit(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the card)")
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        eager = _run_on_card(case, graphed=False)
        control = _run_on_card(case, graphed=False)
        graph = _run_on_card(case, graphed=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    # the eager step repeats itself bit for bit, so a difference is the graph's
    assert control[1] == eager[1] and torch.equal(control[3], eager[3])
    assert all(torch.equal(control[2][k], v) for k, v in eager[2].items())
    assert graph[0] == {"captures": 1, "replays": STEPS - 1, "eager_steps": 1}
    assert graph[1] == eager[1]
    assert sorted(graph[2]) == sorted(eager[2])
    differ = [k for k in eager[2] if not torch.equal(graph[2][k], eager[2][k])]
    assert differ == []
    assert torch.equal(graph[3], eager[3])
    assert graph[4:] == eager[4:] == (STEPS, STEPS)
