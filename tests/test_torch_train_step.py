"""The port's optimiser, schedules, EMA and mask_mt step against the JAX
package (optax, jax.jit of make_mask_mt_step) on the CPU at float32."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch import nn

from cutmix_seg_tpu.core import schedules as jsched
from cutmix_seg_tpu.core import train_state as jts
from cutmix_seg_tpu.masks.box_mask import BoxMaskConfig as JBoxMaskConfig
from cutmix_seg_tpu.masks.box_mask import sample_box_rects as jax_sample_box_rects
from cutmix_seg_tpu.models.common import SegModel as JSegModel
from cutmix_seg_tpu.models.deeplab2 import DeepLab2 as JDeepLab2
from cutmix_seg_tpu.models.deeplab2 import _param_label as j_param_label
from cutmix_seg_tpu.semisup import ema as jema
from cutmix_seg_tpu.semisup import mask_mt as jmm
from cutmix_seg_tpu_torch.core import schedules as tsched
from cutmix_seg_tpu_torch.core import train_state as tts
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig
from cutmix_seg_tpu_torch.models.common import SegModel
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.semisup import ema as tema
from cutmix_seg_tpu_torch.semisup import mask_mt as tmm
from tests.test_torch_models import random_variables

torch.set_num_threads(1)

SCHEDULES = {
    "none": dict(schedule_type="none"),
    "stepped": dict(schedule_type="stepped", step_epochs="[1, 3]", iters_per_epoch=2),
    "cosine": dict(schedule_type="cosine"),
    "poly": dict(schedule_type="poly", poly_power=0.9),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    kw = dict(base_lr=3e-4, total_iters=10, **SCHEDULES[name])
    js, ts = jsched.make_lr_schedule(**kw), tsched.make_lr_schedule(**kw)
    for step in range(13):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)


# name -> (shape, label); 'unused' gets no gradient in torch, zeros in optax
PARAMS = {"backbone.conv": ((3, 4), "pretrained"), "classifier.w": ((5,), "new"),
          "backbone.bn.weight": ((4,), "frozen"), "classifier.unused": ((2, 2), "new")}

OPT_CASES = {
    "adam_const": dict(opt_type="adam", learning_rate=3e-4, sched=None),
    "adam_poly": dict(opt_type="adam", learning_rate=1e-2, sched="poly"),
    "sgd_momentum_wd_stepped": dict(opt_type="sgd", learning_rate=1e-2, sched="stepped"),
    "sgd_nesterov_cosine": dict(opt_type="sgd", learning_rate=1e-2, sgd_nesterov=True,
                                sched="cosine"),
    "sgd_plain": dict(opt_type="sgd", learning_rate=1e-2, sgd_momentum=0.0,
                      sgd_weight_decay=0.0, sched=None),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    """Three updates from equal gradients. Both apply optax's formulas in
    float32; the schedule is computed in double here and in float32 there,
    so results agree to a few ulps (rtol 1e-6)."""
    kw = dict(OPT_CASES[case])
    sched = kw.pop("sched")
    j_sched = t_sched = None
    if sched is not None:
        skw = dict(base_lr=kw["learning_rate"], total_iters=4, **SCHEDULES[sched])
        j_sched, t_sched = jsched.make_lr_schedule(**skw), tsched.make_lr_schedule(**skw)
    rng = np.random.RandomState(0)
    init = {k: rng.randn(*shape).astype(np.float32) for k, (shape, _) in PARAMS.items()}
    labels = {k: lab for k, (_, lab) in PARAMS.items()}

    tx = jts.make_optimizer(jts.OptimizerConfig(lr_schedule=j_sched, **kw), labels)
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = tx.init(j_params)
    t_params = {k: nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = tts.make_optimizer(tts.OptimizerConfig(lr_schedule=t_sched, **kw), t_params, labels)
    assert not t_params["backbone.bn.weight"].requires_grad

    for _ in range(3):
        grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
        grads["classifier.unused"][:] = 0.0
        updates, j_state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                     j_state, j_params)
        j_params = {k: j_params[k] + updates[k] for k in j_params}
        for k, p in t_params.items():
            p.grad = None if k in ("classifier.unused", "backbone.bn.weight") \
                else torch.from_numpy(grads[k])
        opt.step()
        opt.zero_grad()
        for k in init:
            np.testing.assert_allclose(t_params[k].detach().numpy(), np.asarray(j_params[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(t_params["backbone.bn.weight"].detach().numpy(),
                                  init["backbone.bn.weight"])


def test_ema_matches_jax_bit_for_bit():
    """t * a + s * (1 - a), each product rounded, over every float tensor
    (frozen ones too, where t == s is not a fixed point of the arithmetic)."""
    rng = np.random.RandomState(1)
    shapes = [(3, 4), (5,), (2, 3, 3)]
    tea = [rng.randn(*s).astype(np.float32) for s in shapes]
    stu = [rng.randn(*s).astype(np.float32) for s in shapes]
    stu[1] = tea[1].copy()  # a frozen tensor: equal in both
    want = jema.ema_update([jnp.asarray(t) for t in tea], [jnp.asarray(s) for s in stu], 0.99)
    got = [torch.from_numpy(t.copy()) for t in tea]
    tema.ema_update(got, [torch.from_numpy(s) for s in stu], 0.99)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_float_tensors_cover_params_and_running_stats():
    m = DeepLab2(3, layers=(1, 1, 1, 1))
    names = [n for n, _ in m.named_parameters()] + [n for n, _ in m.named_buffers()]
    assert len(tema.float_tensors(m)) == len(names) == len(m.state_dict())


# ---- the mask_mt step, 3 steps against jax.jit(make_mask_mt_step) ----

LR = 3e-4
N, HW, C = 2, (33, 33), 4


def _batch(mode, seed=0, ratio=1):
    rng = np.random.RandomState(seed)
    h, w = HW
    nu = N * ratio
    labels = rng.randint(0, C, size=(N, h, w)).astype(np.int32)
    labels[rng.rand(N, h, w) < 0.1] = 255
    b = {"sup_x": rng.randn(N, h, w, 3).astype(np.float32), "sup_y": labels}
    keys = ("ux0", "ux1") if mode == "mix" else ("ux",)
    for k in keys:
        b[f"{k}_tea"] = b[f"{k}_stu"] = rng.randn(nu, h, w, 3).astype(np.float32)
    for k in (("um0", "um1") if mode == "mix" else ("um",)):
        b[k] = (rng.rand(nu, h, w, 1) > 0.2).astype(np.float32)
    return b


def _cfg_kw(mode, mean_teacher, **extra):
    return dict(dict(mask_mode=mode, cons_weight=1.0, conf_thresh=0.34, conf_per_pixel=False,
                     freeze_bn=True, mean_teacher=mean_teacher, teacher_alpha=0.99), **extra)


def _setup(mode, mean_teacher, n_boxes=1, **extra):
    jmodel = JSegModel(name="tiny", module=JDeepLab2(num_classes=C, layers=(1, 1, 1, 1)),
                       mean=np.zeros(3), std=np.ones(3), block_size=(1, 1),
                       param_label=j_param_label)
    jstate, tx = jts.create_train_state(
        jmodel, jts.OptimizerConfig(opt_type="adam", learning_rate=LR),
        jax.random.PRNGKey(0), input_hw=HW, mean_teacher=mean_teacher, pretrained=False)
    variables = random_variables(jmodel.module, HW, 3)
    student = jts.ModelState(params=variables["params"], batch_stats=variables["batch_stats"])
    teacher = student if mean_teacher else jstate.teacher
    jstate = jstate.replace(student=student, teacher=teacher)
    jcfg = jmm.MaskConsistencyConfig(box=JBoxMaskConfig((0.5, 0.5), n_boxes=n_boxes),
                                     **_cfg_kw(mode, mean_teacher, **extra))
    jstep = jax.jit(jmm.make_mask_mt_step(jmodel, tx, jcfg))

    tmodel = SegModel("tiny", DeepLab2(C, layers=(1, 1, 1, 1)), np.zeros(3), np.ones(3),
                      (1, 1), _param_label)
    tstate, opt = tts.create_train_state(
        tmodel, tts.OptimizerConfig(opt_type="adam", learning_rate=LR), 0,
        device="cpu", mean_teacher=mean_teacher, pretrained=False)
    sd = from_jax_variables(variables)
    tstate.student.load_state_dict(sd)
    if mean_teacher:
        tstate.teacher.load_state_dict(sd)
    tcfg = tmm.MaskConsistencyConfig(box=BoxMaskConfig((0.5, 0.5), n_boxes=n_boxes),
                                     **_cfg_kw(mode, mean_teacher, **extra))
    tstep = tmm.make_mask_mt_step(tmodel, opt, tcfg)
    return jstate, jstep, jcfg, tstate, tstep


def _close_params(port_module, jax_params, jax_stats, steps, what):
    """Adam's first updates are ~lr * sign(g): an element whose gradient is
    at rounding noise can move the other way in one framework, by up to
    2 * lr per step. So every element is held within 2 * lr * steps, and all
    but 0.1% of them within 1e-6 (the float32 difference of the sums)."""
    want = from_jax_variables({"params": jax.device_get(jax_params),
                               "batch_stats": jax.device_get(jax_stats)})
    got = port_module.state_dict()
    assert set(got) == set(want)
    n_tight = n_all = 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        assert d.max().item() <= 2 * LR * steps + 1e-6, (what, k, d.max().item())
        n_tight += int((d <= 1e-6 + 1e-5 * w.abs()).sum())
        n_all += d.numel()
    assert n_tight >= 0.999 * n_all, (what, n_all - n_tight, n_all)


@pytest.mark.parametrize("mode, mean_teacher", [("mix", True), ("zero", True),
                                                ("mix", False)])
def test_mask_mt_step_matches_jax(mode, mean_teacher):
    """Rects are injected by replaying the JAX step's key split. Losses agree
    within rtol 1e-4 over 3 steps (float32 sums in another order, plus the
    Adam sign effect above on later steps); conf_rate is a mean of 0/1
    gates and must agree to float32 rounding."""
    jstate, jstep, jcfg, tstate, tstep = _setup(mode, mean_teacher)
    nb = _batch(mode)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    tbatch["sup_y"] = tbatch["sup_y"].long()
    rates = []
    for i in range(3):
        k_mask = jax.random.split(jstate.rng, 5)[1]
        rects = np.array(jax_sample_box_rects(jcfg.box, k_mask, N, HW))
        jstate, jm = jstep(jstate, jbatch, jnp.float32(1.0))
        tstate, tm = tstep(tstate, tbatch, 1.0, rects=torch.from_numpy(rects))
        for k in ("sup_loss", "cons_loss", "conf_rate"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        rates.append(tm["conf_rate"].item())
    assert any(0.0 < r < 1.0 for r in rates), rates  # the gate is exercised
    assert tstate.step == int(jstate.step) == 3
    _close_params(tstate.student, jstate.student.params, jstate.student.batch_stats, 3,
                  "student")
    if mean_teacher:
        _close_params(tstate.teacher, jstate.teacher.params, jstate.teacher.batch_stats, 3,
                      "teacher")
    else:
        assert tstate.teacher is None


# options the parity test above fixes: name -> (mask_mode, config kwargs)
OPTION_CASES = {
    "ratio2_mix": ("mix", dict(unsup_batch_ratio=2)),
    "ratio2_zero": ("zero", dict(unsup_batch_ratio=2)),
    "conf_per_pixel": ("mix", dict(conf_per_pixel=True)),
    "bce": ("mix", dict(cons_loss_fn="bce")),
    "kld": ("mix", dict(cons_loss_fn="kld")),
    "logits_var": ("mix", dict(cons_loss_fn="logits_var")),
    "logits_smoothl1": ("mix", dict(cons_loss_fn="logits_smoothl1")),
    "n_boxes3": ("mix", dict(n_boxes=3)),
    "conf_thresh0": ("mix", dict(conf_thresh=0.0)),
    "cons_weight0": ("mix", dict(cons_weight=0.0)),
    # Cutout at R = 2: at a 0.34 gate one pixel's confidence lies within
    # rounding of the threshold and flips; 0.3 and 0.5 hold
    "cutout_ratio2_gate0.3": ("zero", dict(unsup_batch_ratio=2, conf_thresh=0.3)),
    "cutout_ratio2_gate0.5": ("zero", dict(unsup_batch_ratio=2, conf_thresh=0.5)),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_mask_mt_step_options_match_jax(case):
    """The mask_mt step under one more option each, 3 steps against
    jax.jit of the JAX step: losses within rtol 1e-5, conf_rate within two
    flipped pixels, parameters as _close_params holds them."""
    mode, kw = OPTION_CASES[case]
    kw = dict(kw)
    ratio = kw.get("unsup_batch_ratio", 1)
    jstate, jstep, jcfg, tstate, tstep = _setup(mode, True, **kw)
    nb = _batch(mode, ratio=ratio)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    tbatch["sup_y"] = tbatch["sup_y"].long()
    n_unsup = N * ratio
    one_gate = 1.0 / (n_unsup * HW[0] * HW[1])
    for i in range(3):
        k_mask = jax.random.split(jstate.rng, 5)[1]
        rects = np.array(jax_sample_box_rects(jcfg.box, k_mask, n_unsup, HW))
        jstate, jm = jstep(jstate, jbatch, jnp.float32(1.0))
        tstate, tm = tstep(tstate, tbatch, 1.0, rects=torch.from_numpy(rects))
        assert sorted(tm) == sorted(jm)
        for k in ("sup_loss", "cons_loss"):
            if k in jm:
                np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {i} {k}")
        if "conf_rate" in jm:
            assert abs(tm["conf_rate"].item() - float(jm["conf_rate"])) <= 2 * one_gate + 1e-7
    assert tstate.step == int(jstate.step) == 3
    _close_params(tstate.student, jstate.student.params, jstate.student.batch_stats, 3,
                  "student")
    _close_params(tstate.teacher, jstate.teacher.params, jstate.teacher.batch_stats, 3,
                  "teacher")


def _tiny_state():
    model = SegModel("tiny", DeepLab2(C, layers=(1, 1, 1, 1)), np.zeros(3), np.ones(3),
                     (1, 1), _param_label)
    state, opt = tts.create_train_state(model, tts.OptimizerConfig(learning_rate=LR), 5,
                                        device="cpu")
    return model, state, opt


def test_remat_loss_chain_is_identical():
    """Recomputing the loss tails in the backward pass changes no bit."""
    nb = _batch("mix", seed=1)
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    tbatch["sup_y"] = tbatch["sup_y"].long()
    results = []
    for remat in (False, True):
        model, state, opt = _tiny_state()
        step = tmm.make_mask_mt_step(model, opt, tmm.MaskConsistencyConfig(
            conf_thresh=0.0, remat_loss_chain=remat))
        state, m = step(state, tbatch, 1.0)
        results.append((m, state.student.state_dict()))
    (m0, sd0), (m1, sd1) = results
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


def test_sampled_rects_drive_the_step():
    """Without injected rects the step draws them from the state's
    generator: equal seeds give equal steps."""
    nb = _batch("mix", seed=2)
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    tbatch["sup_y"] = tbatch["sup_y"].long()
    out = []
    for _ in range(2):
        model, state, opt = _tiny_state()
        step = tmm.make_mask_mt_step(model, opt, tmm.MaskConsistencyConfig(conf_thresh=0.0))
        _, m = step(state, tbatch, 0.5)
        out.append(m)
    assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])
    assert all(torch.isfinite(v) for v in out[0].values())


@pytest.mark.parametrize("kw", [dict(mask_mode="blend")])
def test_unported_options_raise(kw):
    model, state, opt = _tiny_state()
    with pytest.raises((NotImplementedError, ValueError)):
        tmm.make_mask_mt_step(model, opt, tmm.MaskConsistencyConfig(**kw))


@pytest.mark.parametrize("length", [0, 5.0, 40])
def test_sigmoid_rampup_matches_jax(length):
    from cutmix_seg_tpu.utils.rampup import sigmoid_rampup as j_rampup
    from cutmix_seg_tpu_torch.utils.rampup import sigmoid_rampup as t_rampup

    for current in (-1.0, 0.0, 2.5, 5.0, 17.0, 40.0, 55.0):
        assert t_rampup(current, length) == j_rampup(current, length)
