"""The port's ICT, VAT and aug_mt steps (semisup/{ict,vat,aug_cons}.py)
against ``jax.jit`` of the JAX steps on the CPU at float32: the tiny
DeepLab v2 of test_torch_train_step.py, the same weights (carried across
with ``from_jax_variables``) and inputs, 3 steps.

The JAX steps draw lambda (ICT) and the VAT noise from their key; the tests
replay the key split outside the step and inject the draws into the port,
as test_mask_mt_step_matches_jax does with the CutMix boxes.

Tolerances: sup and consistency losses within rtol 1e-5 of JAX (atol 1e-7);
parameters after 3 steps as ``_close_params`` holds mask_mt (within
2 * lr * steps everywhere, all but 0.1% within 1e-6 + 1e-5 relative; Adam
moves a noise-level gradient's element by up to lr per step, in either
direction); conf_rate, a mean of 0/1 gates, within two flipped pixels.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from scipy import special, stats

from cutmix_seg_tpu.core import train_state as jts
from cutmix_seg_tpu.models.common import SegModel as JSegModel
from cutmix_seg_tpu.models.deeplab2 import DeepLab2 as JDeepLab2
from cutmix_seg_tpu.models.deeplab2 import _param_label as j_param_label
from cutmix_seg_tpu.semisup import aug_cons as jaug
from cutmix_seg_tpu.semisup import ict as jict
from cutmix_seg_tpu.semisup import vat as jvat
from cutmix_seg_tpu.semisup.stepcore import apply_model as j_apply_model
from cutmix_seg_tpu_torch.core import train_state as tts
from cutmix_seg_tpu_torch.models.common import SegModel
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.semisup import aug_cons as taug
from cutmix_seg_tpu_torch.semisup import ict as tict
from cutmix_seg_tpu_torch.semisup import vat as tvat
from tests.test_torch_models import random_variables
from tests.test_torch_resample import _thetas
from tests.test_torch_train_step import C, HW, LR, N, _close_params

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-7
STEPS = 3
ALGOS = {  # name: (JAX module, JAX config, JAX step factory, port ...)
    "ict": (jict.ICTConfig, jict.make_ict_step, tict.ICTConfig, tict.make_ict_step),
    "vat": (jvat.VATConfig, jvat.make_vat_step, tvat.VATConfig, tvat.make_vat_step),
    "aug": (jaug.AugConsConfig, jaug.make_aug_cons_step, taug.AugConsConfig,
            taug.make_aug_cons_step),
}


def _models():
    jmodel = JSegModel(name="tiny", module=JDeepLab2(num_classes=C, layers=(1, 1, 1, 1)),
                       mean=np.zeros(3), std=np.ones(3), block_size=(1, 1),
                       param_label=j_param_label)
    tmodel = SegModel("tiny", DeepLab2(C, layers=(1, 1, 1, 1)), np.zeros(3), np.ones(3),
                      (1, 1), _param_label)
    return jmodel, tmodel


def _setup(algo, **kw):
    """(jstate, jitted JAX step, tstate, port step, jmodel) from equal weights."""
    jcfg_cls, jmake, tcfg_cls, tmake = ALGOS[algo]
    mean_teacher = kw.get("mean_teacher", True)
    jmodel, tmodel = _models()
    jstate, tx = jts.create_train_state(
        jmodel, jts.OptimizerConfig(opt_type="adam", learning_rate=LR),
        jax.random.PRNGKey(0), input_hw=HW, mean_teacher=mean_teacher, pretrained=False)
    variables = random_variables(jmodel.module, HW, 3)
    student = jts.ModelState(params=variables["params"], batch_stats=variables["batch_stats"])
    jstate = jstate.replace(student=student,
                            teacher=student if mean_teacher else jstate.teacher)
    jstep = jax.jit(jmake(jmodel, tx, jcfg_cls(**kw)))

    tstate, opt = tts.create_train_state(
        tmodel, tts.OptimizerConfig(opt_type="adam", learning_rate=LR), 0,
        device="cpu", mean_teacher=mean_teacher, pretrained=False)
    sd = from_jax_variables(variables)
    tstate.student.load_state_dict(sd)
    if mean_teacher:
        tstate.teacher.load_state_dict(sd)
    return jstate, jstep, tstate, tmake(tmodel, opt, tcfg_cls(**kw)), jmodel


def _batch(algo, ratio=1, seed=0, xf="random"):
    """numpy batch: student images differ from the teacher's (as colour
    jitter makes them), so VAT's direction is not zero."""
    rng = np.random.RandomState(seed)
    h, w = HW
    nu = N * ratio
    labels = rng.randint(0, C, size=(N, h, w)).astype(np.int32)
    labels[rng.rand(N, h, w) < 0.1] = 255
    b = {"sup_x": rng.randn(N, h, w, 3).astype(np.float32), "sup_y": labels}

    def img():
        return rng.randn(nu, h, w, 3).astype(np.float32)

    def mask():
        return (rng.rand(nu, h, w, 1) > 0.2).astype(np.float32)

    if algo == "ict":
        for k in ("ux0", "ux1"):
            b[f"{k}_tea"] = img()
            b[f"{k}_stu"] = b[f"{k}_tea"] + 0.3 * img()
        b["um0"], b["um1"] = mask(), mask()
    elif algo == "vat":
        b["ux_tea"] = img()
        b["ux_stu"] = b["ux_tea"] + 0.3 * img()
        b["um"] = mask()
    else:
        b["ux0"], b["ux1"], b["um0"], b["um1"] = img(), img(), mask(), mask()
        b["xf0_to_1"] = (np.tile(np.eye(2, 3, dtype=np.float32), (nu, 1, 1))
                         if xf == "identity" else _thetas(rng, nu))
    return b


def _to_torch(nb):
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    tb["sup_y"] = tb["sup_y"].long()
    return tb


def _ict_lam(jstate, alpha, n):
    k_beta = jax.random.split(jstate.rng, 5)[1]
    lam = jax.jit(lambda k: jax.random.beta(k, alpha, alpha, shape=(n, 1, 1, 1)))(k_beta)
    return torch.from_numpy(np.array(lam, np.float32))


def _vat_eps0(jstate, shape):
    k_eps = jax.random.split(jstate.rng, 5)[1]
    h, w = shape[1:3]
    eps0 = jax.jit(lambda k: jvat._normalize_per_sample(
        jax.random.normal(k, shape, jnp.float32)) * (1.0e-6 * h * w / 1000.0))(k_eps)
    return torch.from_numpy(np.array(eps0))


def _run(algo, nb, steps=STEPS, **kw):
    jstate, jstep, tstate, tstep, _ = _setup(algo, **kw)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = _to_torch(nb)
    n_unsup = nb["ux0" if algo == "aug" else ("ux_stu" if algo == "vat" else "ux0_stu")].shape[0]
    one_gate = 1.0 / (n_unsup * HW[0] * HW[1])
    rates = []
    for i in range(steps):
        inject = {}
        if algo == "ict":
            inject["lam"] = _ict_lam(jstate, kw["ict_alpha"], n_unsup)
        elif algo == "vat":
            inject["eps0"] = _vat_eps0(jstate, nb["ux_stu"].shape)
        jstate, jm = jstep(jstate, jbatch, jnp.float32(1.0))
        tstate, tm = tstep(tstate, tbatch, 1.0, **inject)
        assert sorted(tm) == sorted(jm)
        for k in ("sup_loss", "cons_loss"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {k}")
        assert abs(tm["conf_rate"].item() - float(jm["conf_rate"])) <= 2 * one_gate + 1e-7
        rates.append(tm["conf_rate"].item())
    assert tstate.step == int(jstate.step) == steps
    _close_params(tstate.student, jstate.student.params, jstate.student.batch_stats, steps,
                  "student")
    if kw.get("mean_teacher", True):
        _close_params(tstate.teacher, jstate.teacher.params, jstate.teacher.batch_stats, steps,
                      "teacher")
    else:
        assert tstate.teacher is None
    return rates


def _gate_exercised(rates, conf_thresh):
    if conf_thresh > 0:
        assert any(0.0 < r < 1.0 for r in rates), rates
    else:
        assert all(r == 1.0 for r in rates), rates


ICT_CASES = {
    "var_gated_alpha0.1": dict(cons_loss_fn="var", conf_thresh=0.34, ict_alpha=0.1),
    "kld_alpha1": dict(cons_loss_fn="kld", conf_thresh=0.0, ict_alpha=1.0),
    "logits_var_ratio2": dict(cons_loss_fn="logits_var", conf_thresh=0.34, ict_alpha=0.5,
                              unsup_batch_ratio=2),
    "logits_smoothl1_per_pixel": dict(cons_loss_fn="logits_smoothl1", conf_thresh=0.34,
                                      conf_per_pixel=True, ict_alpha=0.5),
    "var_pi_model": dict(cons_loss_fn="var", conf_thresh=0.0, ict_alpha=1.0,
                         mean_teacher=False),
}


@pytest.mark.parametrize("case", sorted(ICT_CASES))
def test_ict_step_matches_jax(case):
    kw = ICT_CASES[case]
    nb = _batch("ict", ratio=kw.get("unsup_batch_ratio", 1), seed=1)
    _gate_exercised(_run("ict", nb, **kw), kw["conf_thresh"])


VAT_CASES = {
    "var_fixed_teacher": dict(cons_loss_fn="var", conf_thresh=0.34),
    "bce_adaptive_teacher": dict(cons_loss_fn="bce", conf_thresh=0.0,
                                 adaptive_vat_radius=True, vat_radius=1.0),
    "kld_adaptive_student": dict(cons_loss_fn="kld", conf_thresh=0.34,
                                 adaptive_vat_radius=True, vat_dir_from_student=True),
    # logits_var is unbounded: at radius 0.2 the third step's loss moves by
    # 2.7e-4 after Adam's sign effect on the student, the direction net here
    "logits_var_fixed_student": dict(cons_loss_fn="logits_var", conf_thresh=0.0,
                                     vat_dir_from_student=True, vat_radius=0.05),
}


@pytest.mark.parametrize("case", sorted(VAT_CASES))
def test_vat_step_matches_jax(case):
    kw = VAT_CASES[case]
    nb = _batch("vat", seed=2)
    _gate_exercised(_run("vat", nb, **kw), kw["conf_thresh"])


AUG_CASES = {
    "var_identity": dict(xf="identity", cons_loss_fn="var", conf_thresh=0.34),
    "var_random": dict(xf="random", cons_loss_fn="var", conf_thresh=0.0),
    "bce_random_ratio2": dict(xf="random", cons_loss_fn="bce", conf_thresh=0.34,
                              unsup_batch_ratio=2),
    "kld_random_per_pixel": dict(xf="random", cons_loss_fn="kld", conf_thresh=0.34,
                                 conf_per_pixel=True),
    "logits_var_random": dict(xf="random", cons_loss_fn="logits_var", conf_thresh=0.0),
}


@pytest.mark.parametrize("case", sorted(AUG_CASES))
def test_aug_mt_step_matches_jax(case):
    kw = dict(AUG_CASES[case])
    nb = _batch("aug", ratio=kw.get("unsup_batch_ratio", 1), seed=3, xf=kw.pop("xf"))
    _gate_exercised(_run("aug", nb, **kw), kw["conf_thresh"])


@pytest.mark.parametrize("adaptive, from_student", [(False, False), (True, True)])
def test_vat_adversarial_input_matches_jax(adaptive, from_student):
    """x_adv against the JAX step's, computed from the same eps0 with the JAX
    package's functions, relative to the radius; the direction pass leaves
    every parameter's .grad as it was."""
    cfg_kw = dict(vat_radius=0.7, adaptive_vat_radius=adaptive,
                  vat_dir_from_student=from_student)
    jstate, _, tstate, _, jmodel = _setup("vat", **cfg_kw)
    nb = _batch("vat", seed=4)
    x_tea, x_stu = jnp.asarray(nb["ux_tea"]), jnp.asarray(nb["ux_stu"])
    eps0 = _vat_eps0(jstate, nb["ux_stu"].shape)
    jcfg = jvat.VATConfig(**cfg_kw)
    st = jstate.student if from_student else jstate.teacher

    @jax.jit
    def j_adv(eps0):
        y, _ = j_apply_model(jmodel, st.params, st.batch_stats, x_tea, train=False,
                             freeze_bn=True)

        def dir_loss(eps):
            out, _ = j_apply_model(jmodel, st.params, st.batch_stats, x_stu + eps,
                                   train=False, freeze_bn=True)
            return jvat._vat_sum_loss(jcfg.cons_loss_fn, out, y)

        direction = jvat._normalize_per_sample(jax.grad(dir_loss)(eps0))
        n, h, w, c = x_stu.shape
        if adaptive:
            dv = x_stu[:, 2:] - x_stu[:, :-2]
            dh = x_stu[:, :, 2:] - x_stu[:, :, :-2]
            mag = jnp.sqrt((dv.reshape(n, -1) ** 2).sum(1) + (dh.reshape(n, -1) ** 2).sum(1))
            radius = jcfg.vat_radius * mag[:, None, None, None] * 0.5
        else:
            radius = jnp.full((n, 1, 1, 1), jcfg.vat_radius * math.sqrt(c * h * w))
        return x_stu + direction * radius, radius

    want, radius = map(np.asarray, j_adv(jnp.asarray(eps0)))
    net = tstate.student if from_student else tstate.teacher
    net.train()
    got = tvat.adversarial_input(tvat.VATConfig(**cfg_kw), net, torch.from_numpy(nb["ux_tea"]),
                                 torch.from_numpy(nb["ux_stu"]), eps0)
    assert net.training  # the mode is restored
    assert all(p.grad is None for p in tstate.student.parameters())
    moved = np.abs(want - nb["ux_stu"]).max(axis=(1, 2, 3))
    assert (moved > 1e-3 * radius.reshape(-1)).all()  # the direction is not zero
    # float32 itself moves this direction by up to 2.1e-5 of the radius
    # against a float64 evaluation of the same function (the gradient of
    # the var loss cancels): allow 1e-4
    err = np.abs(got.numpy() - want).max(axis=(1, 2, 3)) / radius.reshape(-1)
    assert err.max() <= 1e-4, err


@pytest.mark.parametrize("alpha, n", [(0.1, 100_000), (2.0, 20_000)])
def test_sample_beta_has_no_nan_and_is_beta(alpha, n):
    """10^5 draws at alpha 0.1, where X / (X + Y) of two float32 gammas
    meets 0 / 0: none is NaN, all lie in [0, 1]. The distribution is tested
    on the log-odds, which float32 resolves in both tails (about 10% of
    Beta(0.1, 0.1) lies within 6e-8 of 1, where float32 rounds lambda to 1):
    a Kolmogorov-Smirnov test against scipy's Beta(alpha, alpha) keeps them
    (p > 0.01)."""
    g = torch.Generator().manual_seed(0)
    lam = tict.sample_beta(alpha, (n,), g)
    assert torch.isfinite(lam).all() and (lam >= 0).all() and (lam <= 1).all()
    logit = tict.beta_logit(alpha, (n,), g).numpy().astype(np.float64)
    beta = stats.beta(alpha, alpha)

    def cdf(t):  # P(log-odds <= t), from the nearer tail (Beta(a, a) is symmetric)
        return np.where(t < 0, beta.cdf(special.expit(t)), beta.sf(special.expit(-t)))

    assert stats.kstest(logit, cdf).pvalue > 0.01


def _tiny_state(mean_teacher=True):
    model = SegModel("tiny", DeepLab2(C, layers=(1, 1, 1, 1)), np.zeros(3), np.ones(3),
                     (1, 1), _param_label)
    state, opt = tts.create_train_state(model, tts.OptimizerConfig(learning_rate=LR), 5,
                                        device="cpu", mean_teacher=mean_teacher,
                                        pretrained=False)
    return model, state, opt


@pytest.mark.parametrize("algo", ["ict", "vat"])
def test_sampled_draws_drive_the_step(algo):
    """Without injected draws the step takes lambda / eps0 from the state's
    generator: equal seeds give equal steps, and the generator moves."""
    tb = _to_torch(_batch(algo, seed=5))
    cfg_cls, make = ALGOS[algo][2:]
    out = []
    for _ in range(2):
        model, state, opt = _tiny_state()
        g0 = state.generator.get_state()
        _, m = make(model, opt, cfg_cls(conf_thresh=0.0))(state, tb, 0.5)
        assert not torch.equal(state.generator.get_state(), g0)
        out.append((m, state.student.state_dict()))
    (m0, sd0), (m1, sd1) = out
    assert all(torch.equal(m0[k], m1[k]) and torch.isfinite(m0[k]) for k in m0)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_supervised_only_when_cons_weight_is_zero(algo):
    """cons_weight 0: the CE step alone (no teacher, no draws)."""
    tb = _to_torch(_batch(algo, seed=6))
    cfg_cls, make = ALGOS[algo][2:]
    model, state, opt = _tiny_state()
    g0 = state.generator.get_state()
    _, m = make(model, opt, cfg_cls(cons_weight=0.0))(state, tb, 1.0)
    assert sorted(m) == ["sup_loss"] and state.step == 1
    assert torch.equal(state.generator.get_state(), g0)


@pytest.mark.parametrize("algo", sorted(ALGOS))
@pytest.mark.parametrize("kw", [dict(grad_accum=2)])
def test_unported_options_raise(algo, kw):
    cfg_cls, make = ALGOS[algo][2:]
    model, state, opt = _tiny_state()
    with pytest.raises(NotImplementedError):
        make(model, opt, cfg_cls(**kw))


def test_vat_smoothl1_direction_raises():
    """The power step has no logits_smoothl1 loss (nor has JAX's)."""
    model, state, opt = _tiny_state()
    step = tvat.make_vat_step(model, opt, tvat.VATConfig(cons_loss_fn="logits_smoothl1"))
    with pytest.raises(ValueError, match="unsupported VAT direction loss"):
        step(state, _to_torch(_batch("vat", seed=7)), 1.0)


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_config_fields_match_jax(algo):
    import dataclasses

    jcls, tcls = ALGOS[algo][0], ALGOS[algo][2]
    assert ({f.name: f.default for f in dataclasses.fields(tcls)}
            == {f.name: f.default for f in dataclasses.fields(jcls)})
