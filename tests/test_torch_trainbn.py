"""The four steps with training BN (``freeze_bn=False``) and dropout against
``jax.jit`` of the JAX steps on the CPU at float32, over 3 steps: a tiny
flax model with two BatchNorms and a Dropout, and its torch twin, from the
same weights (``from_jax_variables(..., 'tree')``).

Draws are injected as the frozen-BN tests do (rects, lambda, VAT noise from
the JAX key split); dropout masks by call order: flax's
``nn.Dropout.__call__`` is patched inside the test to take mask k of a
step, the port's ``Dropout.draw_keep`` to return it. The jitted JAX step is
traced once, so its masks are the same at every step; the port's draws
restart at mask 0 each step.

Both sides run the JAX step's forwards in its order: the teacher's (two in
turn for a mixed pair), then the student's on sup_x and on the consistency
input, each updating the running statistics it normalises with; the EMA
mixes the teacher's updated statistics with the student's. The pi-model's
teacher pass leaves the student's statistics as they were.

Tolerances: as test_torch_algorithms.py (losses rtol 1e-5, parameters AND
running statistics of student and teacher within 2 * lr * steps),
conf_rate within two flipped pixels; all but 1% of the elements within
1e-6 + 1e-5 relative (0.1% there: this model has 892 elements, and Adam
turns a gradient that differs at rounding level into an update that differs
by up to lr, so one element of a thousand can already be out).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch
from torch.nn import functional as F

from cutmix_seg_tpu.core import train_state as jts
from cutmix_seg_tpu.masks.box_mask import BoxMaskConfig as JBoxMaskConfig
from cutmix_seg_tpu.masks.box_mask import sample_box_rects as jax_sample_box_rects
from cutmix_seg_tpu.models import common as jcommon
from cutmix_seg_tpu.semisup import aug_cons as jaug
from cutmix_seg_tpu.semisup import ict as jict
from cutmix_seg_tpu.semisup import mask_mt as jmm
from cutmix_seg_tpu.semisup import vat as jvat
from cutmix_seg_tpu_torch.core import train_state as tts
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig
from cutmix_seg_tpu_torch.models import common as tcommon
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.semisup import aug_cons as taug
from cutmix_seg_tpu_torch.semisup import ict as tict
from cutmix_seg_tpu_torch.semisup import mask_mt as tmm
from cutmix_seg_tpu_torch.semisup import vat as tvat
from tests.test_torch_algorithms import _batch as algo_batch
from tests.test_torch_algorithms import _ict_lam, _to_torch, _vat_eps0
from tests.test_torch_models_families import fill, patch_dropout
from tests.test_torch_train_step import C, HW, LR, N
from tests.test_torch_train_step import _batch as mask_batch

torch.set_num_threads(1)

STEPS = 3
RULES = [("conv0", "pretrained")]


class JTiny(fnn.Module):
    """conv-BN-ReLU, conv-dropout-BN-ReLU, 1x1 classifier."""

    @fnn.compact
    def __call__(self, x, train: bool, freeze_bn: bool = False):
        use_ra = (not train) or freeze_bn
        y = fnn.Conv(8, (3, 3), padding=1, use_bias=False, name="conv0")(x)
        y = fnn.relu(jcommon.batch_norm(use_ra, "bn0")(y))
        y = fnn.Conv(8, (3, 3), padding=1, use_bias=False, name="conv1")(y)
        y = fnn.Dropout(0.3, deterministic=not train)(y)
        y = fnn.relu(jcommon.batch_norm(use_ra, "bn1")(y))
        return fnn.Conv(C, (1, 1), name="classifier")(y)


class TTiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = tcommon.Conv2d(3, 8, 3, padding=1, bias=False)
        self.bn0 = tcommon.BatchNorm2d(8)
        self.conv1 = tcommon.Conv2d(8, 8, 3, padding=1, bias=False)
        self.drop = tcommon.Dropout(0.3)
        self.bn1 = tcommon.BatchNorm2d(8)
        self.classifier = tcommon.Conv2d(8, C, 1)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x.permute(0, 3, 1, 2))))
        y = F.relu(self.bn1(self.drop(self.conv1(y))))
        return self.classifier(y).permute(0, 2, 3, 1)


class StepMasks:
    """Mask k of a step, from seed 300 + k; after the first JAX trace has
    counted a step's draws, k wraps at that count (a retrace draws the same
    masks again)."""

    def __init__(self):
        self.k, self.per_step = 0, None

    def next(self, shape_nhwc, keep_prob):
        k = self.k if self.per_step is None else self.k % self.per_step
        self.k += 1
        return np.random.RandomState(300 + k).rand(*shape_nhwc) < keep_prob


ALGOS = {  # name: (JAX config, JAX step factory, port config, port step factory)
    "mask_mt": (jmm.MaskConsistencyConfig, jmm.make_mask_mt_step,
                tmm.MaskConsistencyConfig, tmm.make_mask_mt_step),
    "ict": (jict.ICTConfig, jict.make_ict_step, tict.ICTConfig, tict.make_ict_step),
    "vat": (jvat.VATConfig, jvat.make_vat_step, tvat.VATConfig, tvat.make_vat_step),
    "aug": (jaug.AugConsConfig, jaug.make_aug_cons_step, taug.AugConsConfig,
            taug.make_aug_cons_step),
}

CASES = {  # name: (algorithm, config kwargs, forwards that draw dropout masks per step)
    "mask_mt_mix": ("mask_mt", dict(mask_mode="mix", conf_thresh=0.34), 4),
    "mask_mt_zero": ("mask_mt", dict(mask_mode="zero", conf_thresh=0.34), 3),
    "mask_mt_mix_pi": ("mask_mt", dict(mask_mode="mix", conf_thresh=0.0,
                                       mean_teacher=False), 4),
    "ict": ("ict", dict(ict_alpha=0.5, conf_thresh=0.34), 4),
    "ict_pi": ("ict", dict(ict_alpha=0.5, conf_thresh=0.0, mean_teacher=False), 4),
    "vat_teacher_direction": ("vat", dict(conf_thresh=0.34, vat_radius=0.5), 3),
    "vat_student_direction_adaptive": ("vat", dict(conf_thresh=0.0, adaptive_vat_radius=True,
                                                   vat_dir_from_student=True), 3),
    "aug_mt": ("aug", dict(conf_thresh=0.34), 3),
    "aug_mt_pi": ("aug", dict(conf_thresh=0.0, mean_teacher=False), 3),
}


def _setup(algo, kw):
    jcfg_cls, jmake, tcfg_cls, tmake = ALGOS[algo]
    kw = dict(kw, freeze_bn=False, cons_weight=1.0)
    if algo == "mask_mt":
        jkw, tkw = dict(kw, box=JBoxMaskConfig((0.5, 0.5))), dict(kw, box=BoxMaskConfig((0.5, 0.5)))
    else:
        jkw = tkw = kw
    mean_teacher = kw.get("mean_teacher", True)
    jmodel = jcommon.SegModel(name="tiny", module=JTiny(), mean=np.zeros(3), std=np.ones(3),
                              block_size=(1, 1),
                              param_label=lambda p: jcommon.label_params_by_path(p, RULES))
    jstate, tx = jts.create_train_state(
        jmodel, jts.OptimizerConfig(opt_type="adam", learning_rate=LR), jax.random.PRNGKey(0),
        input_hw=HW, mean_teacher=mean_teacher, pretrained=False)
    shapes = jax.eval_shape(lambda: JTiny().init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1,) + HW + (3,)), train=False))
    variables = fill(shapes, 3)
    student = jts.ModelState(params=variables["params"], batch_stats=variables["batch_stats"])
    jstate = jstate.replace(student=student, teacher=student if mean_teacher else jstate.teacher)
    jcfg = jcfg_cls(**jkw)
    jstep = jax.jit(jmake(jmodel, tx, jcfg))

    tmodel = tcommon.SegModel("tiny", TTiny(), np.zeros(3), np.ones(3), (1, 1),
                              lambda m: tcommon.label_params_by_path(m, RULES))
    tstate, opt = tts.create_train_state(
        tmodel, tts.OptimizerConfig(opt_type="adam", learning_rate=LR), 0, device="cpu",
        mean_teacher=mean_teacher, pretrained=False)
    sd = from_jax_variables(variables, "tree")
    for net in (tstate.student, tstate.teacher):
        if net is not None:
            net.load_state_dict(sd)
    return jstate, jstep, jcfg, tstate, tmake(tmodel, opt, tcfg_cls(**tkw))


def _close(port_module, jax_params, jax_stats, what):
    """As test_torch_train_step._close_params, in the tree layout, with 1%
    in place of 0.1% (see the module docstring)."""
    want = from_jax_variables({"params": jax.device_get(jax_params),
                               "batch_stats": jax.device_get(jax_stats)}, "tree")
    got = port_module.state_dict()
    assert set(got) == set(want)
    n_tight = n_all = 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        assert d.max().item() <= 2 * LR * STEPS + 1e-6, (what, k, d.max().item())
        n_tight += int((d <= 1e-6 + 1e-5 * w.abs()).sum())
        n_all += d.numel()
    assert n_tight >= 0.99 * n_all, (what, n_all - n_tight, n_all)


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_bn_step_matches_jax(case, monkeypatch):
    algo, kw, draws_per_step = CASES[case]
    masks = StepMasks()
    patch_dropout(monkeypatch, masks)
    jstate, jstep, jcfg, tstate, tstep = _setup(algo, kw)
    mean_teacher = kw.get("mean_teacher", True)
    if algo == "mask_mt":
        nb = mask_batch(kw["mask_mode"])
    else:
        nb = algo_batch(algo, seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = _to_torch(nb)
    stats0 = {k: v.clone() for k, v in tstate.student.state_dict().items() if "running" in k}
    n_unsup = nb[{"mask_mt": "sup_x", "ict": "ux0_stu", "vat": "ux_stu", "aug": "ux0"}[algo]] \
        .shape[0]
    one_gate = 1.0 / (n_unsup * HW[0] * HW[1])
    for i in range(STEPS):
        inject = {}
        if algo == "mask_mt":
            k_mask = jax.random.split(jstate.rng, 5)[1]
            inject["rects"] = torch.from_numpy(
                np.array(jax_sample_box_rects(jcfg.box, k_mask, N, HW)))
        elif algo == "ict":
            inject["lam"] = _ict_lam(jstate, kw["ict_alpha"], n_unsup)
        elif algo == "vat":
            inject["eps0"] = _vat_eps0(jstate, nb["ux_stu"].shape)
        jstate, jm = jstep(jstate, jbatch, jnp.float32(1.0))
        if masks.per_step is None:
            masks.per_step = masks.k
            assert masks.per_step == draws_per_step
        masks.k = 0
        tstate, tm = tstep(tstate, tbatch, 1.0, **inject)
        assert masks.k == draws_per_step
        assert sorted(tm) == sorted(jm)
        for k in ("sup_loss", "cons_loss"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        assert abs(tm["conf_rate"].item() - float(jm["conf_rate"])) <= 2 * one_gate + 1e-7
    assert tstate.step == int(jstate.step) == STEPS
    # the running statistics moved, and match JAX's
    assert all(not torch.equal(tstate.student.state_dict()[k], v) for k, v in stats0.items())
    _close(tstate.student, jstate.student.params, jstate.student.batch_stats, "student")
    if mean_teacher:
        _close(tstate.teacher, jstate.teacher.params, jstate.teacher.batch_stats, "teacher")
