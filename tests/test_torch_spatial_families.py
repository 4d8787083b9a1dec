"""Spatial partitioning (``parallel.spatial``) of PSPNet, the ResUNets and
DenseUNet: the image H axis split over gloo rank processes on the CPU
(``tests/_torch_ranks.py``), against the JAX package on a 2-device CPU mesh
and against the port alone. One spawn per world size runs every case of
the file (world 2: the ops, the forwards and evals, the steps and the
trainer line; worlds 3 and 4: the ops), started before the JAX runs.

* Ops (``FAMILY_OPS``) at S = 2 and 3, and the one-bin pyramid level at
  S = 4, against the unsplit op, as ``test_torch_spatial_ops.py`` holds
  the others: the nearest 2x upsample where an output range starts on an
  odd row (3 -> 6: output row 3 reads row 1 of the other rank; 7 -> 14),
  the 2x2 average pool where a window straddles the split (6 -> 3,
  14 -> 7), PSPNet's adaptive pool (overlapping bins, and 6 bins on a
  5-row map split 3/2), alone and resized from the whole pooled map back to
  this rank's rows (2 -> 5, 6 -> 5), and into a training BN (its world sums
  count each pooled value S times, its gradient once). Outputs and input
  gradients within 1e-5 (the resize's float32 source index adds
  2**-21 * h_in * max|out|, as in ``test_torch_spatial_ops._tol``), weight
  gradients 1e-5 relative.
* Forwards and evals: the tiny PSPNet (layers (1, 1, 1, 1), 36-row crops:
  feature maps of 18, 9 and 5 rows) and the tiny ResUNet (layers
  (1, 1, 1, 1)) and DenseUNet (DenseNet blocks (2, 2, 2, 2)) at 96-row
  crops (their 1/32 map has 3 rows and splits 2/1; the 6 -> 3 pool and the
  3 -> 6 upsample straddle) in eval mode at world 2: logits within 2e-5 of
  ``jit_spatial_forward`` (relative to max |logit| where that exceeds 1),
  confusion matrices bit-equal to ``make_spatial_eval_fn`` with an odd
  height padded (35 -> 36; 95 -> 96). The JAX DenseUNet fixes DenseNet-161's
  decoder widths, so its tiny twin here (``JTinyDenseUNet``) is the JAX
  module's own code at the tiny taps' widths, from the JAX package's
  DenseNetFeatures, AddSkipDecoderBlock and upsample.
* Steps at world 2 (S = 2) against ``jax.jit`` under ``jit_spatial_step``
  and against the port alone, phase 3's tolerances
  (``test_torch_spatial_steps``): DenseUNet CutMix with training BN and
  host-drawn dropout (the ISIC line), ResUNet aug_mt and PSPNet ICT, both
  with training BN (PSPNet's: on the pooled branches too); ranks
  bit-identical.
* The trainer: the ISIC recipe's CutMix line (training BN, dropout, SGD 0.1
  poly, ``--bin_fill_holes``) with the tiny DenseUNet on a synthetic ISIC
  zip, ``--spatial_train 2 --eval_spatial``, 2 epochs of 2 iterations,
  against world 1 of the same seed in this process (SGD's bounds: see
  ``test_isic_cutmix_line_matches_world1``).
"""

from typing import Any

import flax.linen as fnn
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import types
import warnings

from cutmix_seg_tpu.core import train_state as jts
from cutmix_seg_tpu.core.train_state import ModelState
from cutmix_seg_tpu.masks.box_mask import BoxMaskConfig as JBoxMaskConfig
from cutmix_seg_tpu.masks.box_mask import sample_box_rects as jax_sample_box_rects
from cutmix_seg_tpu.models import common as jmcommon
from cutmix_seg_tpu.models import denseunet as jdu
from cutmix_seg_tpu.models import pspnet as jps
from cutmix_seg_tpu.models import resunet as jru
from cutmix_seg_tpu.models.common import SegModel as JSegModel
from cutmix_seg_tpu.parallel import spatial as jspatial
from cutmix_seg_tpu.parallel.mesh import make_mesh
from cutmix_seg_tpu_torch.data import settings, sources, synthetic
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig
from cutmix_seg_tpu_torch.models import registry
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.parallel import spatial
from tests import _torch_ranks as ranks
from tests import test_torch_trainbn as tbn
from tests.test_torch_algorithms import _ict_lam
from tests.test_torch_ddp_steps import ATOL, JAX_CFG, JAX_STEP, RTOL, check_close_to_port
from tests.test_torch_models import random_variables
from tests.test_torch_models_families import patch_dropout
from tests.test_torch_resample import _thetas
from tests.test_torch_spatial_model import _raw_batch
from tests.test_torch_spatial_steps import _off_tight, check_metrics

torch.set_num_threads(1)

C, LR, S = ranks.C, ranks.LR, 2
MEAN, STD = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
OPS = sorted(ranks.FAMILY_OPS)
OPS_AT = {2: OPS, 3: OPS, 4: ["bins1_5", "ppm1_5", "ppm_bn2_5"]}  # bin 1 at S = 4: 2/1/1/1


class JTinyDenseUNet(fnn.Module):
    """``cutmix_seg_tpu.models.denseunet.DenseUNet.__call__`` with DenseNet
    blocks (2, 2, 2, 2): the decoder takes the tiny taps' widths (192, 192,
    96, 96; line0 192) where the JAX module fixes DenseNet-161's."""

    num_classes: int
    dtype: Any = None

    @fnn.compact
    def __call__(self, x, train: bool, freeze_bn: bool = False):
        use_ra = (not train) or freeze_bn
        feats, taps = jdu.DenseNetFeatures(block_config=(2, 2, 2, 2), dtype=self.dtype,
                                           name="features")(x.astype(self.dtype or x.dtype),
                                                            use_ra)
        y = fnn.relu(feats)
        line0 = fnn.Conv(192, (1, 1), dtype=self.dtype, name="line0_conv")(taps["denseblock3"])
        for name, chn, skip in (("decoder3", 192, line0), ("decoder2", 192, taps["denseblock2"]),
                                ("decoder1", 96, taps["denseblock1"]),
                                ("decoder0", 96, taps["relu0"])):
            y = jmcommon.AddSkipDecoderBlock(chn, dtype=self.dtype, name=name)(y, skip, use_ra)
        y = jmcommon.upsample_nearest_2x(y)
        y = fnn.Conv(64, (3, 3), padding=1, use_bias=False, dtype=self.dtype,
                     name="final_dec_conv")(y)
        y = fnn.Dropout(0.3, deterministic=not train)(y)
        y = jmcommon.batch_norm(use_ra, "final_dec_bn", self.dtype)(y)
        y = fnn.relu(y)
        return fnn.Conv(self.num_classes, (1, 1), dtype=self.dtype, name="final_clf")(y)


JAX_FAMILIES = {  # name: (JAX module, parameter labels, crop (h, w), eval pad rows)
    "pspnet": (lambda: jps.PSPNet(num_classes=C, layers=(1, 1, 1, 1)), jps._param_label,
               (36, 22), 2),
    "resunet": (lambda: jru.ResUNet(num_classes=C, layers=(1, 1, 1, 1)),
                jru._param_label_pretrained, (96, 32), 32),
    "denseunet": (lambda: JTinyDenseUNet(num_classes=C), jdu._param_label_pretrained,
                  (96, 32), 32),
}
BLOCK = {"pspnet": (1, 1), "resunet": (32, 32), "denseunet": (32, 32)}


def _jmodel(family):
    make, label, _, _ = JAX_FAMILIES[family]
    return JSegModel(name="tiny", module=make(), mean=MEAN, std=STD, block_size=BLOCK[family],
                     param_label=label)


# ---- steps ----

STEP_CASES = {  # name: (algorithm, family, config kwargs, dropout draws per step, images)
    # the ISIC line: CutMix, training BN, dropout; the gate is off (the
    # random nets' confidences sit near 1/C, a gate there flips on ties)
    "denseunet_cutmix_training_bn": ("mask_mt", "denseunet",
                                     dict(mask_mode="mix", conf_thresh=0.0, freeze_bn=False),
                                     4, 2),
    # training BN (as the ISIC aug line): each forward draws its own masks in
    # both packages (with frozen BN the port's step runs the student's two
    # forwards as one batch, whose one mask is not JAX's two)
    "resunet_aug_mt_training_bn": ("aug", "resunet", dict(conf_thresh=0.0, freeze_bn=False),
                                   3, 2),
    # 4 images: the one-bin pyramid level's training BN sees 4 values per
    # channel (over 2, rounding turns into O(1e-2) where the two nearly meet)
    "pspnet_ict_training_bn": ("ict", "pspnet", dict(ict_alpha=0.5, conf_thresh=0.0,
                                                     freeze_bn=False), 4, 4),
}
SEEDS = {name: 40 + i for i, name in enumerate(sorted(STEP_CASES))}
# one DenseUNet step: on its 1.0M elements Adam's first step turns
# rounding-level gradients into steps of lr, after which the port alone's
# second-step consistency loss is already 2.5e-5 relative off JAX's (the
# split port's is the same)
STEPS = {"denseunet_cutmix_training_bn": 1, "resunet_aug_mt_training_bn": 2,
         "pspnet_ict_training_bn": 2}


def make_batch(algo, n, hw, seed):
    """A global numpy batch of every key the step reads
    (``test_torch_spatial_steps.make_batch`` at a crop of ``hw``)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    labels = rng.randint(0, C, size=(n, h, w)).astype(np.int32)
    labels[rng.rand(n, h, w) < 0.1] = 255
    b = {"sup_x": rng.randn(n, h, w, 3).astype(np.float32), "sup_y": labels}

    def img():
        return rng.randn(n, h, w, 3).astype(np.float32)

    def mask():
        return (rng.rand(n, h, w, 1) > 0.2).astype(np.float32)

    if algo == "aug":
        b["ux0"], b["ux1"], b["um0"], b["um1"] = img(), img(), mask(), mask()
        b["xf0_to_1"] = _thetas(rng, n)
        return b
    for k in ("ux0", "ux1"):
        b[f"{k}_tea"] = img()
        b[f"{k}_stu"] = b[f"{k}_tea"] + (0.0 if algo == "mask_mt" else 0.3 * img())
    b["um0"], b["um1"] = mask(), mask()
    return b


class StepCase:
    """One case: the JAX state, config and global batch, the draws replayed
    from the JAX key split, and ``port_case`` for the port's runs
    (``test_torch_spatial_steps.SpatialCase`` for these families)."""

    def __init__(self, name, variables):
        algo, family, kw, self.masks, n = STEP_CASES[name]
        self.name, self.algo, self.steps = name, algo, STEPS[name]
        kw = dict({"cons_weight": 1.0, "freeze_bn": True}, **kw)
        self.jmodel = _jmodel(family)
        hw = JAX_FAMILIES[family][2]
        jstate, self.tx = jts.create_train_state(
            self.jmodel, jts.OptimizerConfig(opt_type="adam", learning_rate=LR),
            jax.random.PRNGKey(0), input_hw=hw, mean_teacher=True, pretrained=False)
        student = jts.ModelState(params=variables["params"], batch_stats=variables["batch_stats"])
        self.jstate = jstate.replace(student=student, teacher=student)
        jkw = dict(kw, box=JBoxMaskConfig((0.5, 0.5))) if algo == "mask_mt" else kw
        self.jcfg = JAX_CFG[algo](**jkw)
        self.nb = make_batch(algo, n, hw, SEEDS[name])
        self.gate_px = n * hw[0] * hw[1]
        draws, rng = [], self.jstate.rng
        for _ in range(self.steps):
            at = types.SimpleNamespace(rng=rng)
            if algo == "mask_mt":
                k_mask = jax.random.split(rng, 5)[1]
                draws.append({"rects": np.array(jax_sample_box_rects(self.jcfg.box, k_mask, n,
                                                                     hw))})
            elif algo == "ict":
                draws.append({"lam": _ict_lam(at, self.jcfg.ict_alpha, n).numpy()})
            else:
                draws.append({})
            rng = jax.random.split(rng, 5)[0]
        self.port_case = {"model": family, "algo": algo,
                          "cfg": dict(kw, box=BoxMaskConfig((0.5, 0.5))) if algo == "mask_mt"
                          else kw,
                          "state_dict": from_jax_variables(variables, "tree"),
                          "batch": self.nb, "draws": draws, "masks_per_chunk": self.masks}

    def run_jax(self, bank):
        """(metrics per step, the final student's and teacher's variables as
        the port's state dicts) of jax.jit under jit_spatial_step on
        make_mesh(1, n_model=2); ``bank`` gives flax's Dropout its masks."""
        mesh = make_mesh(1, n_model=S)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jstep = jit_step(self, mesh)
        jbatch = {k: jnp.asarray(v) for k, v in self.nb.items()}
        jstate, metrics = self.jstate, []
        bank.per_step = self.masks
        for _ in range(self.steps):
            bank.k = 0
            jstate, jm = jstep(jstate, jbatch, jnp.float32(1.0))
            metrics.append({k: float(v) for k, v in jm.items()})
        final = {part: from_jax_variables({"params": jax.device_get(ms.params),
                                           "batch_stats": jax.device_get(ms.batch_stats)}, "tree")
                 for part, ms in (("student", jstate.student), ("teacher", jstate.teacher))}
        del jstep, jstate
        self.jstate = None
        jax.clear_caches()
        return metrics, final


def jit_step(case, mesh):
    make = JAX_STEP[case.algo]
    step = (make(case.jmodel, case.tx, case.jcfg, mesh) if case.algo == "mask_mt"
            else make(case.jmodel, case.tx, case.jcfg))
    return jspatial.jit_spatial_step(step, mesh, case.nb)


# ---- the trainer line ----

TINY_DENSEUNET = "tiny_denseunet_spatial_families_test"
ISIC_CANVAS = (72, 72)
# run_isic2017_experiments.sh's CutMix line at a tiny size: crops of 64
# rows (feature maps of 32, 16, 8, 4 and 2 rows, split in halves), eval
# frames of 72 rows padded to 96 (the block size 32)
ISIC_CUTMIX = dict(
    dataset="isic2017", arch=TINY_DENSEUNET, batch_size=2, iters_per_epoch=2, num_epochs=2,
    opt_type="sgd", learning_rate=0.1, sgd_weight_decay=5e-4, lr_sched="poly",
    bin_fill_holes=True, crop_size="64,64", aug_hflip=True, aug_vflip=True, aug_hvflip=True,
    aug_max_scale=1.1, aug_rot_mag=45.0, aug_strong_colour=True, n_sup=4, cons_weight=1.0,
    mask_mode="mix", mask_prop_range="0.5", conf_thresh=0.97, no_pretrained=True,
    compute_dtype="float32", num_workers=1, data_on_device="off", save_model=False,
    device="cpu")


def _trainer_params(**overrides):
    from cutmix_seg_tpu_torch.train import mask_mt

    p = dict(mask_mt.experiment.make_context("experiment", []).params)
    del p["job_desc"]
    p.update(ISIC_CUTMIX, **overrides)
    return p


# ---- the spawns and the references ----


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: each rank's results} (world "alone": one process without a
    mesh, the port alone), the family variables and forwards' inputs, the
    step cases and their JAX runs, the world-1 trainer's engine and the
    results root. The forwards and the steps start from one set of
    variables per family."""
    tmp = tmp_path_factory.mktemp("spatial_families")
    zip_path = synthetic.write_isic_zip(str(tmp / "isic2017.zip"), 8, 3, size=ISIC_CANVAS[0],
                                        seed=5)
    rng = np.random.RandomState(0)
    models = {}
    for i, family in enumerate(sorted(JAX_FAMILIES)):
        _, _, (h, w), pad = JAX_FAMILIES[family]
        variables = random_variables(JAX_FAMILIES[family][0](), (h, w), 20 + i)
        models[family] = {"variables": variables,
                          "state_dict": from_jax_variables(variables, "tree"),
                          "x": rng.randn(2, h, w, 3).astype(np.float32),
                          "batches": [_raw_batch(rng, 2, (h, w)), _raw_batch(rng, 3, (h - 1, w))],
                          "pad_h": pad, "mean": MEAN, "std": STD}
    model_task = {k: {f: v for f, v in m.items() if f != "variables"} for k, m in models.items()}
    cases = {name: StepCase(name, models[STEP_CASES[name][1]]["variables"])
             for name in STEP_CASES}
    port_cases = {n: c.port_case for n, c in cases.items()}
    root = str(tmp / "results")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUTMIX_SEG_CONFIG", synthetic.write_config(str(tmp / "seg.cfg"),
                                                              isic_zip=zip_path))
        mp.setattr(settings, "_config", None)
        mp.setattr(sources.ISIC2017DataSource, "canvas_hw", ISIC_CANVAS)
        mp.setitem(registry._ARCHS, TINY_DENSEUNET, ranks.tiny_denseunet)
        trainer = {"kind": "trainer", "arch": "tiny_deeplab_unused", "root": root,
                   "arch_denseunet": TINY_DENSEUNET, "isic_canvas": ISIC_CANVAS,
                   "params": _trainer_params(spatial_train=2, eval_spatial=True),
                   "runs": [("isic_cutmix", {})], "keep_student": ("isic_cutmix",),
                   "eval": False}
        spawns = {w: ranks.RankProcesses(
            tmp, dict({"kind": "families", "n_model": w, "ops": OPS_AT[w]},
                      **({"models": model_task, "trainer": trainer, "cases": port_cases}
                         if w == 2 else {})), w, timeout=600) for w in OPS_AT}
        spawns["alone"] = ranks.RankProcesses(
            tmp, {"kind": "families", "alone": True, "ops": OPS, "models": model_task,
                  "cases": port_cases}, 1, timeout=600)
        try:
            with pytest.MonkeyPatch.context() as mp2:
                bank = tbn.StepMasks()
                patch_dropout(mp2, bank)
                jax_steps = {n: c.run_jax(bank) for n, c in cases.items()}
            from cutmix_seg_tpu_torch.core import job
            from cutmix_seg_tpu_torch.train import mask_mt

            world1 = job.submit("test_torch_world1", "isic_cutmix",
                                mask_mt.train_seg_semisup_mask_mt, _trainer_params(),
                                results_root=str(tmp / "world1"))
            by_world = {w: sp.wait() for w, sp in spawns.items()}
        except BaseException:
            for sp in spawns.values():
                sp.kill()
            raise
    alone = by_world.pop("alone")[0]
    return {"by_world": by_world, "ops": alone["ops"], "models": models,
            "alone_models": alone["models"], "cases": cases, "jax_steps": jax_steps,
            "alone_steps": alone["steps"], "world1": world1, "root": root}


# ---- ops ----


def _tol(name, want):
    op, h, kw = ranks.FAMILY_OPS[name]
    if op.startswith("ppm"):  # the resize from the bins: its source has kw['bins'] rows
        return 1e-5 + 2.0 ** -21 * kw["bins"] * want.abs().max().item()
    return 1e-5


@pytest.mark.parametrize("S", sorted(OPS_AT))
@pytest.mark.parametrize("name", OPS)
def test_split_op_matches_unsplit(runs, name, S):
    if name not in OPS_AT[S]:
        assert S == 4  # the S = 4 spawn runs the one-bin level and its BN
        return
    op, h, _ = ranks.FAMILY_OPS[name]
    per_rank = [r["ops"][name] for r in runs["by_world"][S]]
    want = runs["ops"][name]
    if op == "bins":  # the pooled map is whole on every rank
        for g in per_rank:
            torch.testing.assert_close(g["out"], want["out"], rtol=0, atol=_tol(name, want["out"]))
    else:
        h_out = want["out"].shape[1]
        assert ([g["out"].shape[1] for g in per_rank]
                == [hi - lo for lo, hi in spatial.split_rows(h_out, S)])
        cat = torch.cat([g["out"] for g in per_rank], dim=1)
        torch.testing.assert_close(cat, want["out"], rtol=0, atol=_tol(name, want["out"]))
    x_grad = torch.cat([g["x_grad"] for g in per_rank], dim=1)
    torch.testing.assert_close(x_grad, want["x_grad"], rtol=0, atol=_tol(name, want["x_grad"]))
    for key in ("w_grad", "bn_w_grad", "bn_b_grad"):
        if key in want:
            total = sum(g[key] for g in per_rank)
            scale = want[key].abs().max().item()
            torch.testing.assert_close(total, want[key], rtol=0, atol=1e-5 * scale, msg=key)
    if "running_var" in want:  # the statistics of the pooled values, once each
        for g in per_rank:
            torch.testing.assert_close(g["running_var"], want["running_var"], rtol=1e-5, atol=0)


def test_op_cases_straddle_the_split():
    """At S = 2 the cases need rows of the other rank: an upsample whose
    output range starts on an odd row, a pool window across the split, 6
    bins on 5 rows (bins wider than a rank's share overlap it)."""
    for name in ("nearest_3_to_6", "nearest_7_to_14"):
        h = ranks.FAMILY_OPS[name][1]
        lo = spatial.split_rows(2 * h, 2)[1][0]
        assert lo % 2 == 1 and lo // 2 < spatial.split_rows(h, 2)[0][1], name
    for name in ("avg_6_to_3", "avg_14_to_7"):
        h = ranks.FAMILY_OPS[name][1]
        hi = spatial.split_rows(h // 2, 2)[0][1]
        assert 2 * hi > spatial.split_rows(h, 2)[0][1], name
    assert ranks.FAMILY_OPS["bins6_5"][2]["bins"] > ranks.FAMILY_OPS["bins6_5"][1]


# ---- forwards and evals ----


@pytest.mark.parametrize("family", sorted(JAX_FAMILIES))
def test_logits_match_jax_spatial_forward(runs, family):
    m = runs["models"][family]
    jmodel = _jmodel(family)
    mstate = ModelState(params=m["variables"]["params"],
                        batch_stats=m["variables"]["batch_stats"])
    mesh = make_mesh(2)
    xs = jax.device_put(jnp.asarray(m["x"]), jspatial.spatial_sharding(mesh))
    want = np.asarray(jspatial.jit_spatial_forward(jmodel, mesh)(mstate, xs))
    got = [r["models"][family]["logits"] for r in runs["by_world"][2]]
    h = m["x"].shape[1]
    assert [g.shape[1] for g in got] == [h // 2] * 2
    got = torch.cat(got, dim=1).numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(got, runs["alone_models"][family]["logits"].numpy(), rtol=0,
                               atol=2e-5 * scale)


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("family", sorted(JAX_FAMILIES))
def test_confusion_matrix_matches_jax_spatial_eval(runs, family, i):
    """Batch 1 has an odd height: both sides pad it (36 rows for PSPNet,
    96 for the U-Nets' block of 32)."""
    m = runs["models"][family]
    jmodel = _jmodel(family)
    mstate = ModelState(params=m["variables"]["params"],
                        batch_stats=m["variables"]["batch_stats"])
    batch = jspatial.pad_batch_h(m["batches"][i], m["pad_h"])
    want = np.asarray(jspatial.make_spatial_eval_fn(jmodel, C, MEAN, STD, make_mesh(2))(
        mstate, {k: batch[k] for k in ("canvas", "labels", "sizes")}))
    for r in runs["by_world"][2]:
        np.testing.assert_array_equal(r["models"][family]["cms"][i].numpy(), want)
    np.testing.assert_array_equal(runs["alone_models"][family]["cms"][i].numpy(), want)
    assert want.sum() > 0


def test_unet_maps_straddle_at_96_rows():
    """96 rows give a 3-row 1/32 map: it splits 2/1, the 6 -> 3 pool's
    rank-0 window reads row 3 of rank 1, and the 3 -> 6 upsample's rank-1
    rows read row 1 of rank 0."""
    assert [h for h in (96 // 2 ** k for k in range(6))] == [96, 48, 24, 12, 6, 3]
    assert spatial.split_rows(3, 2) == [(0, 2), (2, 3)]
    assert spatial.split_rows(6, 2) == [(0, 3), (3, 6)]


# ---- steps ----


def _step_ranks(runs, name):
    return [r["steps"][name] for r in runs["by_world"][2]]


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_ranks_end_bit_identical(runs, name):
    outs = _step_ranks(runs, name)
    assert len(outs[0]["digests"]) == STEPS[name]
    assert ranks.digest(outs[0]["final"]) == outs[0]["digests"][-1]
    assert outs[1]["metrics"] == outs[0]["metrics"]
    assert outs[1]["digests"] == outs[0]["digests"]
    assert torch.equal(outs[1]["generator"], outs[0]["generator"])


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_spatial_step_matches_jax_spatial_step(runs, name):
    """``test_torch_spatial_steps``' bounds: parameters within Adam's
    2 * lr * steps and all but 0.1% within 1e-6, plus, under training BN,
    the port alone's own count of elements past 1e-6."""
    case = runs["cases"][name]
    jm, want = runs["jax_steps"][name]
    got = _step_ranks(runs, name)[0]
    check_metrics(got["metrics"], jm, case.gate_px, name)
    alone = runs["alone_steps"][name]
    for part in want:
        n_off, n_all = _off_tight(got["final"][part], want[part], part, case.steps)
        allowed = 0.001 * n_all
        if not case.port_case["cfg"]["freeze_bn"]:
            allowed += _off_tight(alone["final"][part], want[part], part, case.steps)[0]
        assert n_off <= allowed, (part, n_off, allowed, n_all)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_spatial_step_matches_port_alone(runs, name):
    case = runs["cases"][name]
    got, alone = _step_ranks(runs, name)[0], runs["alone_steps"][name]
    check_metrics(got["metrics"], alone["metrics"], case.gate_px, name)
    check_close_to_port(got["final"], alone["final"], case.steps)
    assert torch.equal(got["generator"], alone["generator"])


def test_step_cases_have_their_seeds():
    assert sorted(SEEDS) == sorted(STEP_CASES) == sorted(STEPS)
    assert len(set(SEEDS.values())) == len(STEP_CASES)


def test_training_bn_moved_the_pooled_branch_statistics(runs):
    """PSPNet's pyramid BN (pool0_bn: the one-bin level) took batch
    statistics in the split step, as in JAX's."""
    final = _step_ranks(runs, "pspnet_ict_training_bn")[0]["final"]["student"]
    start = runs["cases"]["pspnet_ict_training_bn"].port_case["state_dict"]
    want = runs["jax_steps"]["pspnet_ict_training_bn"][1]["student"]
    for k in ("decoder.pool0_bn.running_mean", "decoder.pool3_bn.running_var"):
        assert not torch.equal(final[k], start[k]), k
        torch.testing.assert_close(final[k], want[k], rtol=1e-4, atol=1e-6, msg=k)


# ---- the trainer line ----


def test_isic_cutmix_line_matches_world1(runs):
    """--spatial_train 2 --eval_spatial at N = S = 2 is the world-1 run of
    the same seed split by rows (one data index: the same host streams,
    draws and global batch), up to float32 summation order, which SGD at
    lr 0.1 with training BN grows step over step on this tiny random net
    (its supervised loss falls 0.79 -> 0.15 in two steps; measured on the
    CPU: epoch 1's losses 1e-5 relative apart, epoch 2's 1.5e-4, a running
    mean 7.7e-4 after the 4 steps). Held: the ranks bit-identical; epoch
    1's losses within 1e-4 relative and epoch 2's within 1e-3; the VAL mIoU
    of the fill-holes eval (rows split, gathered for the hole filling)
    equal; every parameter and statistic within 2e-3 x max(|w|, 1)."""
    import json
    import os

    r0, r1 = (r["trainer"] for r in runs["by_world"][2])
    assert r0["runs"]["isic_cutmix"]["digest"] == r1["runs"]["isic_cutmix"]["digest"]
    world1 = runs["world1"]
    run_dir = os.path.join(runs["root"], "test_torch_ddp", "isic_cutmix")
    got = [json.loads(ln) for ln in open(os.path.join(run_dir, "metrics_isic_cutmix.jsonl"))]
    want = [json.loads(ln) for ln in open(os.path.join(world1.ctx.run_dir,
                                                       "metrics_isic_cutmix.jsonl"))]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1, 2]
    for rtol, g, w in zip((1e-4, 1e-3), got, want):
        for k in ("sup_loss", "cons_loss", "conf_rate"):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-7, err_msg=k)
        assert g["val_miou"] == w["val_miou"]
    log = open(os.path.join(run_dir, "log_isic_cutmix.txt")).read()
    assert "spatial_train=2" in log and "eval_spatial=True" in log
    assert "bin_fill_holes=True" in log
    for k, w in world1.state.student.state_dict().items():
        if w.is_floating_point():
            d = (r0["runs"]["isic_cutmix"]["student"][k] - w).abs().max().item()
            assert d <= 2e-3 * max(w.abs().max().item(), 1.0), (k, d)
