"""Gradient accumulation (``grad_accum`` K = 2) in the port's four steps
against ``jax.jit`` of the JAX accumulating steps on the CPU at float32,
over 3 steps, from the same weights and inputs; and the options K > 1
refuses, against the JAX steps' exceptions.

Frozen BN: the tiny DeepLab v2 of test_torch_train_step.py. Training BN and
dropout: the tiny two-BN model of test_torch_trainbn.py. The draws (rects,
lambda, VAT noise) are made for the whole batch from the JAX step's key
split and injected, as the K = 1 tests do. Dropout masks are injected by
call order: the JAX step traces its ``lax.scan`` body once, so every chunk
of a step takes the same masks, and the port's draws wrap at the count of
one chunk, in chunk order.

Tolerances: losses within rtol 5e-6 (atol 1e-7); conf_rate within two
flipped pixels; parameters within Adam's 2 * lr * steps (the K = 1 tests'
``_close_params`` / ``_close``); running statistics within 1e-4 relative.
"""

import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.masks.box_mask import sample_box_rects as jax_sample_box_rects
from cutmix_seg_tpu.semisup import mask_mt as jmm
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig, sample_box_rects_np
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.semisup import mask_mt as tmm
from cutmix_seg_tpu_torch.semisup import stepcore
from tests._torch_tmp import drop_tmp_path_if_passed  # noqa: F401
from tests import test_torch_algorithms as ta
from tests import test_torch_train_step as tts
from tests import test_torch_trainbn as tbn
from tests.test_torch_models_families import patch_dropout
from tests.test_torch_trainer import voc  # noqa: F401

torch.set_num_threads(1)

K = 2
STEPS = 3
RTOL, ATOL = 5e-6, 1e-7
STATS_RTOL = 1e-4
N, HW, LR = tts.N, tts.HW, tts.LR


def _inject(algo, jstate, jcfg, n_unsup, nb):
    """The step's whole-batch draws, replayed from the JAX key split."""
    if algo == "mask_mt":
        k_mask = jax.random.split(jstate.rng, 5)[1]
        return {"rects": torch.from_numpy(
            np.array(jax_sample_box_rects(jcfg.box, k_mask, n_unsup, HW)))}
    if algo == "ict":
        return {"lam": ta._ict_lam(jstate, jcfg.ict_alpha, n_unsup)}
    if algo == "vat":
        return {"eps0": ta._vat_eps0(jstate, nb["ux_stu"].shape)}
    return {}


def _n_unsup(algo, nb):
    return nb[{"mask_mt": "sup_x", "ict": "ux0_stu", "vat": "ux_stu", "aug": "ux0"}[algo]] \
        .shape[0]


def _check_stats(port_module, jax_stats, what):
    want = from_jax_variables({"batch_stats": jax.device_get(jax_stats)}, "tree")
    got = port_module.state_dict()
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1.0)
        d = (got[k] - w).abs().max().item()
        assert d <= STATS_RTOL * scale, (what, k, d)


def _run_steps(algo, jstate, jstep, jcfg, tstate, tstep, nb, masks=None, per_chunk=0):
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = ta._to_torch(nb)
    n_unsup = _n_unsup(algo, nb)
    one_gate = 1.0 / (n_unsup * HW[0] * HW[1])
    for i in range(STEPS):
        inject = _inject(algo, jstate, jcfg, n_unsup, nb)
        jstate, jm = jstep(jstate, jbatch, jnp.float32(1.0))
        if masks is not None:
            assert masks.k > 0 and masks.k % per_chunk == 0  # whole traces of one chunk
            masks.k = 0
        tstate, tm = tstep(tstate, tbatch, 1.0, **inject)
        if masks is not None:
            assert masks.k == K * per_chunk
        assert sorted(tm) == sorted(jm)
        for k in ("sup_loss", "cons_loss"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {k}")
        assert abs(tm["conf_rate"].item() - float(jm["conf_rate"])) <= 2 * one_gate + 1e-7
    assert tstate.step == int(jstate.step) == STEPS
    return jstate, tstate


# ---- frozen BN: the tiny DeepLab v2 ----

FROZEN_CASES = {  # name: (algorithm, config kwargs)
    "mask_mt_mix": ("mask_mt", dict(mask_mode="mix")),
    "mask_mt_zero_per_pixel": ("mask_mt", dict(mask_mode="zero", conf_per_pixel=True)),
    "mask_mt_mix_pi": ("mask_mt", dict(mask_mode="mix", conf_thresh=0.0, mean_teacher=False)),
    "ict": ("ict", dict(cons_loss_fn="var", conf_thresh=0.34, ict_alpha=0.5)),
    "ict_pi_kld": ("ict", dict(cons_loss_fn="kld", conf_thresh=0.0, ict_alpha=1.0,
                               mean_teacher=False)),
    "vat_teacher": ("vat", dict(cons_loss_fn="var", conf_thresh=0.34)),
    "vat_student_adaptive": ("vat", dict(cons_loss_fn="kld", conf_thresh=0.34,
                                         adaptive_vat_radius=True, vat_dir_from_student=True)),
    "aug_mt": ("aug", dict(cons_loss_fn="var", conf_thresh=0.34)),
    "aug_mt_bce_per_pixel": ("aug", dict(cons_loss_fn="bce", conf_thresh=0.34,
                                         conf_per_pixel=True)),
}


def _frozen_setup(algo, kw):
    """(jstate, jitted JAX step, JAX config, port state, port step, numpy batch)."""
    kw = dict(kw, grad_accum=K)
    if algo == "mask_mt":
        mode = kw.pop("mask_mode")
        mean_teacher = kw.pop("mean_teacher", True)
        jstate, jstep, jcfg, tstate, tstep = tts._setup(mode, mean_teacher, **kw)
        return jstate, jstep, jcfg, tstate, tstep, tts._batch(mode)
    jstate, jstep, tstate, tstep, _ = ta._setup(algo, **kw)
    nb = ta._batch(algo, seed={"ict": 1, "vat": 2, "aug": 3}[algo])
    return jstate, jstep, ta.ALGOS[algo][0](**kw), tstate, tstep, nb


@pytest.mark.parametrize("case", sorted(FROZEN_CASES))
def test_accum_step_matches_jax_frozen_bn(case):
    algo, kw = FROZEN_CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the batch-mean gate's warning
        jstate, jstep, jcfg, tstate, tstep, nb = _frozen_setup(algo, kw)
    jstate, tstate = _run_steps(algo, jstate, jstep, jcfg, tstate, tstep, nb)
    tts._close_params(tstate.student, jstate.student.params, jstate.student.batch_stats,
                      STEPS, "student")
    if kw.get("mean_teacher", True):
        tts._close_params(tstate.teacher, jstate.teacher.params, jstate.teacher.batch_stats,
                          STEPS, "teacher")


# ---- training BN and dropout: the tiny two-BN model ----

TRAINBN_CASES = {  # name: (algorithm, config kwargs, dropout draws per chunk)
    **tbn.CASES,
    # pi-model, direction from the teacher: the direction net of chunk 1
    # reads the teacher carry (the student's statistics at the step's start
    # moved by chunk 0's teacher forward), not the student's
    "vat_pi_teacher_direction": ("vat", dict(conf_thresh=0.34, mean_teacher=False), 3),
    "vat_pi_student_direction": ("vat", dict(conf_thresh=0.0, mean_teacher=False,
                                             vat_dir_from_student=True), 3),
}


@pytest.mark.parametrize("case", sorted(TRAINBN_CASES))
def test_accum_step_matches_jax_training_bn(case, monkeypatch):
    algo, kw, per_chunk = TRAINBN_CASES[case]
    masks = tbn.StepMasks()
    masks.per_step = per_chunk
    patch_dropout(monkeypatch, masks)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jstate, jstep, jcfg, tstate, tstep = tbn._setup(algo, dict(kw, grad_accum=K))
    if algo == "mask_mt":
        nb = tts._batch(kw["mask_mode"])
    else:
        nb = ta._batch(algo, seed=1)
    stats0 = {k: v.clone() for k, v in tstate.student.state_dict().items() if "running" in k}
    jstate, tstate = _run_steps(algo, jstate, jstep, jcfg, tstate, tstep, nb, masks, per_chunk)
    assert all(not torch.equal(tstate.student.state_dict()[k], v) for k, v in stats0.items())
    tbn._close(tstate.student, jstate.student.params, jstate.student.batch_stats, "student")
    _check_stats(tstate.student, jstate.student.batch_stats, "student")
    if kw.get("mean_teacher", True):
        tbn._close(tstate.teacher, jstate.teacher.params, jstate.teacher.batch_stats, "teacher")
        _check_stats(tstate.teacher, jstate.teacher.batch_stats, "teacher")


# ---- K = 2 against K = 1 in the port ----

def _uniform_batch(algo):
    """A batch whose per-chunk reductions decompose: no ignore label, so
    every chunk's CE counts the same number of pixels."""
    nb = tts._batch("mix", seed=4) if algo == "mask_mt" else ta._batch(algo, seed=4)
    nb["sup_y"] = np.where(nb["sup_y"] == 255, 0, nb["sup_y"]).astype(np.int32)
    return nb


@pytest.mark.parametrize("algo", ["aug", "ict", "mask_mt", "vat"])
def test_accum_equals_one_chunk_with_per_pixel_gate(algo):
    """With the per-pixel gate and frozen BN every reduction of the step
    decomposes over the chunks, so K = 2 computes what K = 1 does up to
    float32 rounding."""
    nb = _uniform_batch(algo)
    tb = ta._to_torch(nb)
    kw = dict(conf_thresh=0.34, conf_per_pixel=True)
    if algo == "ict":
        kw["ict_alpha"] = 0.5
    cfg_cls, make = (tmm.MaskConsistencyConfig, tmm.make_mask_mt_step) if algo == "mask_mt" \
        else ta.ALGOS[algo][2:]
    g = np.random.RandomState(9)
    n = _n_unsup(algo, nb)
    inject = {"mask_mt": lambda: {"rects": torch.from_numpy(
                  sample_box_rects_np(BoxMaskConfig((0.5, 0.5)), n, HW, g))},
              "ict": lambda: {"lam": torch.from_numpy(g.beta(0.5, 0.5, (n, 1, 1, 1))
                                                      .astype(np.float32))},
              "vat": lambda: {"eps0": torch.from_numpy(
                  1e-6 * g.randn(*nb["ux_stu"].shape).astype(np.float32))},
              "aug": dict}[algo]
    draws = [inject() for _ in range(STEPS)]
    runs = []
    for k_accum in (1, K):
        model, state, opt = ta._tiny_state()
        step = make(model, opt, cfg_cls(grad_accum=k_accum, **kw))
        ms = []
        for d in draws:
            state, m = step(state, tb, 1.0, **d)
            ms.append(m)
        runs.append((ms, state))
    (m1, s1), (m2, s2) = runs
    for a, b in zip(m1, m2):
        assert sorted(a) == sorted(b) == ["conf_rate", "cons_loss", "sup_loss"]
        for k in a:
            np.testing.assert_allclose(b[k].item(), a[k].item(), rtol=1e-5, atol=1e-7, err_msg=k)
    for part in ("student", "teacher"):
        sd1, sd2 = getattr(s1, part).state_dict(), getattr(s2, part).state_dict()
        for k, v in sd1.items():
            assert (sd2[k] - v).abs().max().item() <= 2 * LR * STEPS + 1e-6, (part, k)


# ---- what K > 1 refuses, as the JAX steps refuse it ----

def _make_both(algo, **kw):
    """Build the JAX and the port step with ``kw``; returns the two
    exceptions' types (None where it built) and the two steps."""
    out = []
    jmodel, tmodel = ta._models()
    if algo == "mask_mt":
        jmake = lambda: jmm.make_mask_mt_step(jmodel, None, jmm.MaskConsistencyConfig(**kw))
        tmake = lambda: tmm.make_mask_mt_step(tmodel, None, tmm.MaskConsistencyConfig(**kw))
    else:
        jcls, jfac, tcls, tfac = ta.ALGOS[algo]
        jmake = lambda: jfac(jmodel, None, jcls(**kw))
        tmake = lambda: tfac(tmodel, None, tcls(**kw))
    for make in (jmake, tmake):
        try:
            out.append((None, make()))
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            out.append((type(e), None))
    return out


REFUSED = {  # name: (algorithm, config kwargs)
    **{f"{a}_unsup_batch_ratio2": (a, dict(grad_accum=K, unsup_batch_ratio=2))
       for a in ("mask_mt", "ict", "vat", "aug")},
    "mask_mt_cons_compute_bf16": ("mask_mt", dict(grad_accum=K,
                                                  cons_compute_dtype="bfloat16")),
    "mask_mt_remat_loss_chain": ("mask_mt", dict(grad_accum=K, remat_loss_chain=True)),
    "mask_mt_loss_softmax_bf16": ("mask_mt", dict(grad_accum=K,
                                                  loss_softmax_dtype="bfloat16")),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_accum_refusals_match_jax(case):
    algo, kw = REFUSED[case]
    (jerr, _), (terr, _) = _make_both(algo, **kw)
    assert jerr is ValueError and terr is ValueError


@pytest.mark.parametrize("algo", ["aug", "ict", "mask_mt", "vat"])
def test_accum_batch_mean_gate_warns_as_jax(algo):
    for per_pixel, want in ((False, 1), (True, 0)):
        kw = dict(grad_accum=K, conf_thresh=0.97, conf_per_pixel=per_pixel)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (jerr, _), (terr, _) = _make_both(algo, **kw)
        assert jerr is None and terr is None
        kinds = [(w.category, str(w.message).split(":")[0]) for w in caught]
        name = {"aug": "aug_mt", "vat": "vat_mt"}.get(algo, algo)
        assert kinds == [(UserWarning, name)] * (2 * want), kinds


@pytest.mark.parametrize("algo", ["aug", "ict", "mask_mt", "vat"])
def test_accum_indivisible_batch_raises_as_jax(algo):
    """A batch of 3 at K = 2 raises ValueError in both steps' calls."""
    kw = dict(grad_accum=K, conf_thresh=0.0)
    if algo == "mask_mt":
        jstate, jstep, _, tstate, tstep = tts._setup("mix", True, **kw)
        nb = tts._batch("mix")
    else:
        jstate, jstep, tstate, tstep, _ = ta._setup(algo, **kw)
        nb = ta._batch(algo, seed=5)
    nb = {k: np.concatenate([v, v[:1]]) for k, v in nb.items()}
    with pytest.raises(ValueError, match="not divisible by grad_accum=2"):
        jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()}, jnp.float32(1.0))
    with pytest.raises(ValueError, match="not divisible by grad_accum=2"):
        tstep(tstate, ta._to_torch(nb), 1.0)


def test_accum_crop_shape_mismatch_raises_as_jax():
    """Supervised and unsupervised crops of different shapes: ValueError."""
    kw = dict(grad_accum=K, conf_thresh=0.0)
    jstate, jstep, _, tstate, tstep = tts._setup("mix", True, **kw)
    nb = tts._batch("mix")
    nb["sup_x"], nb["sup_y"] = nb["sup_x"][:, :-1], nb["sup_y"][:, :-1]
    with pytest.raises(ValueError, match="matching supervised/unsupervised crop shapes"):
        jstep(jstate, {k: jnp.asarray(v) for k, v in nb.items()}, jnp.float32(1.0))
    with pytest.raises(ValueError, match="matching supervised/unsupervised crop shapes"):
        tstep(tstate, ta._to_torch(nb), 1.0, rects=torch.zeros((N, 1, 4)))


def test_chunk_strided_matches_jax():
    from cutmix_seg_tpu.semisup.stepcore import chunk_strided as j_chunk

    x = np.arange(6 * 2, dtype=np.float32).reshape(6, 2)
    want = np.asarray(j_chunk(jnp.asarray(x), 3))
    got = stepcore.chunk_strided(torch.from_numpy(x), 3)
    assert [c.tolist() for c in got] == want.tolist()
    with pytest.raises(ValueError):
        stepcore.chunk_strided(torch.from_numpy(x), 4)


def test_accum_zero_metrics_match_jax():
    from cutmix_seg_tpu.semisup.stepcore import accum_zero_metrics as j_zero

    for use_cons in (False, True):
        got, want = stepcore.accum_zero_metrics(use_cons), j_zero(use_cons)
        assert sorted(got) == sorted(want)
        assert all(float(got[k]) == float(want[k]) == 0.0 and got[k].dtype == torch.float32
                   for k in got)


# ---- the four trainers with --grad_accum 2 ----

@pytest.mark.parametrize("name", ["aug_mt", "ict", "mask_mt", "vat_mt"])
def test_trainer_runs_with_grad_accum(name, voc, tmp_path):  # noqa: F811
    """Each trainer takes --grad_accum 2 (the refusal is gone): one epoch
    of 2 iterations on the tiny VOC tree, finite losses and a VAL mIoU."""
    from tests import test_torch_trainer, test_torch_trainer_algos

    kw = dict(grad_accum=K, num_epochs=1, iters_per_epoch=2, save_model=False)
    if name == "mask_mt":
        eng = test_torch_trainer._submit(tmp_path / "results", "accum", **kw)
    else:
        eng = test_torch_trainer_algos._submit(name, tmp_path / "results", "accum", **kw)
    log = (tmp_path / "results" / f"test_torch_{name}" / "accum" / "log_accum.txt").read_text()
    assert "grad_accum=2" in log and "Epoch 1:" in log and "VAL mIoU=" in log
    assert "nan" not in log.split("Epoch 1:")[1].split("\n")[0].lower()
    assert eng.state.step == 2 and eng.algo_cfg.grad_accum == K
