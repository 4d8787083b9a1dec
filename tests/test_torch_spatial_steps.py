"""The four steps with spatial partitioning (``--spatial_train``): two
gloo rank processes splitting each image's rows (world 2, S = 2), and four
(world 4: 2 data indices x 2 model ranks), against ``jax.jit`` of the JAX
step under ``parallel.spatial.jit_spatial_step`` on
``make_mesh(n_data, n_model=2)`` over the same global batch, and against the
port alone on that batch. 2 steps of the tiny DeepLab v2 on 36-row crops
(feature maps of 18, 10 and 5 rows: uneven splits, ASPP windows past the
neighbouring rank), and of the tiny DeepLab v3+ (18, 9 and 5 rows; the
image pooling's mean and its training BN, the half-pixel resizes, the
dropout masks of the full maps).

The cases: CutMix and Cutout (per-pixel gate), the supervised line
(``cons_weight`` 0), unsup_batch_ratio 2, training BN (its statistics
all-reduced over every rank's rows), grad_accum 2 with the per-pixel gate
(frozen and training BN); ICT (frozen and training BN), VAT with the
adaptive radius, the VAT pi-model with training BN at grad_accum 2 (its
teacher statistics carried apart), aug_mt (the gathered warp); CutMix on the v3+ (frozen and
training BN, dropout masks injected by call order for the global batch, as
test_torch_ddp_trainbn.py injects them); and at world 4 CutMix with an
ignore-heavy data index, Cutout at R = 2 (the sub-batches counted in data
indices) and VAT with the fixed radius (its norms summed over a model
group that is not the default group). The rects, lambdas and VAT noise are
replayed from the JAX key split as test_torch_ddp_steps.py does; each rank
takes its data index's rows of the global batch and the step cuts its rows
of them. Held: the ranks end bit-identical; losses within 1e-5 relative and
conf_rate within two flipped pixels of JAX's and of the port alone;
parameters within Adam's 2 * lr * steps of both.
"""

import types
import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.core import train_state as jts
from cutmix_seg_tpu.masks.box_mask import BoxMaskConfig as JBoxMaskConfig
from cutmix_seg_tpu.masks.box_mask import sample_box_rects as jax_sample_box_rects
from cutmix_seg_tpu.models import deeplab3 as jd3
from cutmix_seg_tpu.models.common import SegModel as JSegModel
from cutmix_seg_tpu.models.deeplab2 import DeepLab2 as JDeepLab2
from cutmix_seg_tpu.models.deeplab2 import _param_label as j_param_label
from cutmix_seg_tpu.parallel.mesh import make_mesh
from cutmix_seg_tpu.parallel.spatial import jit_spatial_step
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from tests import _torch_ranks as ranks
from tests import test_torch_trainbn as tbn
from tests.test_torch_algorithms import _ict_lam, _vat_eps0
from tests.test_torch_ddp_steps import (
    ATOL,
    JAX_CFG,
    JAX_STEP,
    RTOL,
    STEPS,
    check_close_to_port,
)
from tests.test_torch_models import random_variables
from tests.test_torch_models_families import patch_dropout
from tests.test_torch_resample import _thetas

torch.set_num_threads(1)

HW, C, LR, S = (36, 22), ranks.C, ranks.LR, 2
CASES = {  # name: (world, algorithm, model, config kwargs, batch options)
    "mix": (2, "mask_mt", "deeplab2", dict(mask_mode="mix", conf_thresh=0.34), {}),
    "zero_per_pixel": (2, "mask_mt", "deeplab2", dict(mask_mode="zero", conf_thresh=0.34,
                                                      conf_per_pixel=True), {}),
    "supervised": (2, "mask_mt", "deeplab2", dict(mask_mode="mix", cons_weight=0.0), {}),
    "zero_ratio2": (2, "mask_mt", "deeplab2", dict(mask_mode="zero", conf_thresh=0.3,
                                                   unsup_batch_ratio=2), dict(ratio=2)),
    "mix_training_bn": (2, "mask_mt", "deeplab2", dict(mask_mode="mix", conf_thresh=0.34,
                                                       freeze_bn=False), {}),
    "mix_accum2_per_pixel": (2, "mask_mt", "deeplab2", dict(
        mask_mode="mix", conf_thresh=0.34, conf_per_pixel=True, grad_accum=2), {}),
    "mix_accum2_per_pixel_training_bn": (2, "mask_mt", "deeplab2", dict(
        mask_mode="mix", conf_thresh=0.34, conf_per_pixel=True, grad_accum=2,
        freeze_bn=False), {}),
    "ict": (2, "ict", "deeplab2", dict(ict_alpha=0.5, conf_thresh=0.34), {}),
    "ict_training_bn": (2, "ict", "deeplab2", dict(ict_alpha=0.5, conf_thresh=0.34,
                                                   freeze_bn=False), {}),
    "vat_adaptive": (2, "vat", "deeplab2", dict(conf_thresh=0.34, adaptive_vat_radius=True,
                                                vat_radius=1.0), {}),
    # the pi-model's own teacher statistics under training BN at grad_accum 2
    # (vat._PiTeacherStats: chunk 1's direction net reads the carry of chunk
    # 0's teacher forward), gate off; one step: at the second the pi-model's
    # direction turns rounding into 2e-3 of consistency loss (the port alone,
    # data-parallel and split differ so at K = 1 too)
    "vat_pi_accum2_training_bn": (2, "vat", "deeplab2", dict(
        conf_thresh=0.0, grad_accum=2, freeze_bn=False, mean_teacher=False),
        dict(steps=1)),
    "aug_mt": (2, "aug", "deeplab2", dict(conf_thresh=0.34), {}),
    # 4 images: the image pooling's training BN sees 4 values per channel;
    # masks: the dropout draws of a step (teacher and student forwards); the
    # gate is off (the random v3+'s confidences sit near 1/C, a gate there
    # flips on ties); one step, whose forwards all run on equal weights: on
    # the v3+'s 24.9M elements Adam's first step turns rounding-level
    # gradients into steps of lr, after which the port alone's second-step
    # consistency loss is 8.6e-5 off JAX's and its ASPP's running means
    # 2.8e-3 (the same in the split port)
    "v3plus_mix": (2, "mask_mt", "deeplabv3plus", dict(mask_mode="mix", conf_thresh=0.0),
                   dict(n=4, masks=2, steps=1)),
    "v3plus_mix_training_bn": (2, "mask_mt", "deeplabv3plus", dict(
        mask_mode="mix", conf_thresh=0.0, freeze_bn=False), dict(n=4, masks=4, steps=1)),
    "2x2_mix_ignore_heavy": (4, "mask_mt", "deeplab2", dict(mask_mode="mix", conf_thresh=0.34),
                             dict(ignore_d1=0.97)),
    "2x2_zero_ratio2": (4, "mask_mt", "deeplab2", dict(mask_mode="zero", conf_thresh=0.3,
                                                       unsup_batch_ratio=2), dict(ratio=2)),
    "2x2_vat_fixed": (4, "vat", "deeplab2", dict(conf_thresh=0.34, vat_radius=0.5), {}),
}
WORLDS = (2, 4)
# each case's batch seed: the first seven cases keep theirs (their order
# among themselves), the later ones follow
SEEDS = {name: i for i, name in enumerate(
    sorted(("mix", "zero_per_pixel", "supervised", "zero_ratio2", "mix_training_bn",
            "2x2_mix_ignore_heavy", "2x2_zero_ratio2"))
    + ["mix_accum2_per_pixel", "mix_accum2_per_pixel_training_bn", "ict", "ict_training_bn",
       "vat_adaptive", "aug_mt", "v3plus_mix", "v3plus_mix_training_bn", "2x2_vat_fixed",
       "vat_pi_accum2_training_bn"])}
JAX_MODELS = {  # model: (JAX module, parameter labels, weight layout)
    "deeplab2": (JDeepLab2, j_param_label, "deeplab2"),
    "deeplabv3plus": (jd3.DeepLabV3Plus, jd3._label_imagenet, "tree"),
}
UNSUP_KEY = {"ict": "ux0_stu", "vat": "ux_stu", "aug": "ux0"}


def make_batch(algo, mode, n, seed, ratio=1, ignore_d1=0.0):
    """A global numpy batch of every key the step reads (n supervised rows,
    n * ratio unsupervised); ``ignore_d1``: data index 1's supervised rows
    that ignore."""
    rng = np.random.RandomState(seed)
    h, w = HW
    labels = rng.randint(0, C, size=(n, h, w)).astype(np.int32)
    labels[rng.rand(n, h, w) < 0.1] = 255
    if ignore_d1:
        half = labels[n // 2:]
        half[rng.rand(*half.shape) < ignore_d1] = 255
    b = {"sup_x": rng.randn(n, h, w, 3).astype(np.float32), "sup_y": labels}
    nu = n * ratio

    def img():
        return rng.randn(nu, h, w, 3).astype(np.float32)

    def mask():
        return (rng.rand(nu, h, w, 1) > 0.2).astype(np.float32)

    if algo == "aug":
        b["ux0"], b["ux1"], b["um0"], b["um1"] = img(), img(), mask(), mask()
        b["xf0_to_1"] = _thetas(rng, nu)
        return b
    keys = ("ux0", "ux1") if algo == "ict" or mode == "mix" else ("ux",)
    for k in keys:
        b[f"{k}_tea"] = img()
        b[f"{k}_stu"] = b[f"{k}_tea"] + (0.0 if algo == "mask_mt" else 0.3 * img())
    for k in (("um0", "um1") if len(keys) == 2 else ("um",)):
        b[k] = mask()
    return b


class SpatialCase:
    """One case: the JAX state, config and global batch, the draws replayed
    from the JAX key split, and ``port_case`` for the port's runs."""

    def __init__(self, name):
        world, algo, model, kw, bkw = CASES[name]
        bkw = dict(bkw)
        self.world, self.name, self.algo = world, name, algo
        self.masks = bkw.pop("masks", None)
        self.steps = bkw.pop("steps", STEPS)
        n = bkw.pop("n", world // S * 2)
        kw = dict({"cons_weight": 1.0, "freeze_bn": True}, **kw)
        jmodule, jlabel, self.layout = JAX_MODELS[model]
        self.jmodel = JSegModel(name="tiny", module=jmodule(num_classes=C, layers=(1, 1, 1, 1)),
                                mean=np.zeros(3), std=np.ones(3), block_size=(1, 1),
                                param_label=jlabel)
        variables = random_variables(self.jmodel.module, HW, 3)
        mean_teacher = kw.get("mean_teacher", True)
        jstate, self.tx = jts.create_train_state(
            self.jmodel, jts.OptimizerConfig(opt_type="adam", learning_rate=LR),
            jax.random.PRNGKey(0), input_hw=HW, mean_teacher=mean_teacher, pretrained=False)
        student = jts.ModelState(params=variables["params"], batch_stats=variables["batch_stats"])
        self.jstate = jstate.replace(student=student,
                                     teacher=student if mean_teacher else jstate.teacher)
        jkw = dict(kw, box=JBoxMaskConfig((0.5, 0.5))) if algo == "mask_mt" else kw
        self.jcfg = JAX_CFG[algo](**jkw)
        self.nb = make_batch(algo, kw.get("mask_mode"), n, SEEDS[name], **bkw)
        unsup = UNSUP_KEY.get(algo, "ux0_stu" if "ux0_stu" in self.nb else "ux_stu")
        n_unsup = self.nb[unsup].shape[0]
        self.gate_px = n_unsup * HW[0] * HW[1]
        draws, rng = [], self.jstate.rng
        for _ in range(self.steps):
            at = types.SimpleNamespace(rng=rng)
            if algo == "mask_mt":
                k_mask = jax.random.split(rng, 5)[1]
                draws.append({"rects": np.array(jax_sample_box_rects(self.jcfg.box, k_mask,
                                                                     n_unsup, HW))})
            elif algo == "ict":
                draws.append({"lam": _ict_lam(at, self.jcfg.ict_alpha, n_unsup).numpy()})
            elif algo == "vat":
                draws.append({"eps0": _vat_eps0(at, self.nb["ux_stu"].shape).numpy()})
            else:
                draws.append({})
            rng = jax.random.split(rng, 5)[0]
        self.port_case = {"model": model, "algo": algo,
                          "cfg": dict(kw, box=BoxMaskConfig((0.5, 0.5))) if algo == "mask_mt"
                          else kw,
                          "state_dict": from_jax_variables(variables, self.layout),
                          "batch": self.nb, "draws": draws}
        if self.masks:
            self.port_case["masks_per_chunk"] = self.masks

    def run_jax(self, bank):
        """(metrics per step, the final student's and teacher's variables as
        the port's state dicts) of jax.jit under jit_spatial_step on
        make_mesh(world / S, n_model=S); ``bank`` gives flax's Dropout its
        masks (one step's, again each step). The compiled step is dropped
        after (the v3+ steps take GBs to compile)."""
        mesh = make_mesh(self.world // S, n_model=S)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jstep = jit_spatial_step(JAX_STEP[self.algo](self.jmodel, self.tx, self.jcfg, mesh)
                                     if self.algo == "mask_mt" else
                                     JAX_STEP[self.algo](self.jmodel, self.tx, self.jcfg),
                                     mesh, self.nb)
        jbatch = {k: jnp.asarray(v) for k, v in self.nb.items()}
        jstate, metrics = self.jstate, []
        bank.per_step = self.masks
        for _ in range(self.steps):
            bank.k = 0
            jstate, jm = jstep(jstate, jbatch, jnp.float32(1.0))
            metrics.append({k: float(v) for k, v in jm.items()})
        final = {part: from_jax_variables({"params": jax.device_get(ms.params),
                                           "batch_stats": jax.device_get(ms.batch_stats)},
                                          self.layout)
                 for part, ms in (("student", jstate.student), ("teacher", jstate.teacher))
                 if part == "student" or self.jcfg.mean_teacher}
        del jstep, jstate
        self.jstate = None
        jax.clear_caches()
        return metrics, final


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(cases, JAX runs, {world: each rank's runs}, the port alone): the
    two spawns (worlds 2 and 4) start first."""
    cases = {name: SpatialCase(name) for name in CASES}
    tmp = tmp_path_factory.mktemp("spatial_steps")
    spawns = {w: ranks.RankProcesses(tmp, {"kind": "steps", "n_model": S, "cases": {
        n: c.port_case for n, c in cases.items() if c.world == w}}, w, timeout=600)
        for w in WORLDS}
    try:
        with pytest.MonkeyPatch.context() as mp:
            bank = tbn.StepMasks()
            patch_dropout(mp, bank)
            jax_out = {n: c.run_jax(bank) for n, c in cases.items()}
        alone = {n: ranks.run_steps(c.port_case, None) for n, c in cases.items()}
    except BaseException:
        for sp in spawns.values():
            sp.kill()
        raise
    return cases, jax_out, {w: sp.wait() for w, sp in spawns.items()}, alone


def check_metrics(got, want, n_gate_px, what):
    """test_torch_ddp_steps.check_metrics, for the keys a step returns (the
    supervised line has no consistency metrics)."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), what
        for k in ("sup_loss", "cons_loss"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{what} step {i} {k}")
        if "conf_rate" in w:
            assert abs(g["conf_rate"] - w["conf_rate"]) <= 2 / n_gate_px + 1e-7, (what, i)


def _ranks_of(runs, name):
    cases, _, by_world, _ = runs
    return [out[name] for out in by_world[cases[name].world]]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_end_bit_identical(runs, name):
    """test_torch_ddp_steps.check_ranks_identical, at the case's steps."""
    outs = _ranks_of(runs, name)
    assert len(outs[0]["digests"]) == runs[0][name].steps
    assert ranks.digest(outs[0]["final"]) == outs[0]["digests"][-1]
    for other in outs[1:]:
        assert other["metrics"] == outs[0]["metrics"]
        assert other["digests"] == outs[0]["digests"]
        assert torch.equal(other["generator"], outs[0]["generator"])


def _off_tight(final, want, what, steps):
    """Every element within Adam's 2 * lr * steps of JAX's (``want``);
    returns how many are not within 1e-6 (+ 1e-5 relative) of it, of how
    many (``test_torch_train_step._close_params``' two bounds)."""
    assert set(final) == set(want)
    n_off = n_all = 0
    for k, w in want.items():
        d = (final[k] - w).abs()
        assert d.max().item() <= 2 * LR * steps + 1e-6, (what, k, d.max().item())
        n_off += int((d > 1e-6 + 1e-5 * w.abs()).sum())
        n_all += d.numel()
    return n_off, n_all


@pytest.mark.parametrize("name", sorted(CASES))
def test_spatial_step_matches_jax_spatial_step(runs, name):
    """Parameters as ``_close_params`` holds them: all but 0.1% within 1e-6.
    With training BN, the port alone already differs from JAX beyond 1e-6
    on 1.5% of this tiny DeepLab v2's elements (Adam's sign effect on
    gradients at rounding noise through the batch statistics), so there the
    split port may add 0.1% to the port alone's count."""
    cases, jax_out, _, alone = runs
    jm, want = jax_out[name]
    got = _ranks_of(runs, name)[0]
    check_metrics(got["metrics"], jm, cases[name].gate_px, name)
    steps = cases[name].steps
    for part in want:
        n_off, n_all = _off_tight(got["final"][part], want[part], part, steps)
        allowed = 0.001 * n_all
        if not cases[name].port_case["cfg"]["freeze_bn"]:
            allowed += _off_tight(alone[name]["final"][part], want[part], part, steps)[0]
        assert n_off <= allowed, (part, n_off, allowed, n_all)


@pytest.mark.parametrize("name", sorted(CASES))
def test_spatial_step_matches_port_alone(runs, name):
    cases, _, _, alone = runs
    got = _ranks_of(runs, name)[0]
    check_metrics(got["metrics"], alone[name]["metrics"], cases[name].gate_px, name)
    check_close_to_port(got["final"], alone[name]["final"], cases[name].steps)
    assert torch.equal(got["generator"], alone[name]["generator"])


def test_every_case_has_its_seed():
    assert sorted(SEEDS) == sorted(CASES) and len(set(SEEDS.values())) == len(CASES)


def test_cases_exercise_the_global_sums(runs):
    """The batch-mean gates are partial, data index 1's supervised rows are
    nearly all ignore, and training BN moved the running statistics."""
    cases, jax_out, _, _ = runs
    for name in ("mix", "2x2_mix_ignore_heavy", "2x2_zero_ratio2"):
        rates = [m["conf_rate"] for m in jax_out[name][0]]
        assert all(0.0 < r < 1.0 for r in rates), (name, rates)
    y = cases["2x2_mix_ignore_heavy"].nb["sup_y"]
    valid = [(half != 255).sum() for half in (y[:2], y[2:])]
    assert valid[1] < 0.1 * valid[0], valid
    final = _ranks_of(runs, "mix_training_bn")[0]["final"]["student"]
    start = cases["mix_training_bn"].port_case["state_dict"]
    assert not torch.equal(final["bn1.running_mean"], start["bn1.running_mean"])
