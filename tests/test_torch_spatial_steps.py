"""The mask_mt step with spatial partitioning (``--spatial_train``): two
gloo rank processes splitting each image's rows (world 2, S = 2), and four
(world 4: 2 data indices x 2 model ranks), against ``jax.jit`` of the JAX
step under ``parallel.spatial.jit_spatial_step`` on
``make_mesh(n_data, n_model=2)`` over the same global batch, and against the
port alone on that batch. 2 steps of the tiny DeepLab v2 on 36-row crops
(feature maps of 18, 10 and 5 rows: uneven splits, ASPP windows past the
neighbouring rank).

The cases: CutMix and Cutout (per-pixel gate), the supervised line
(``cons_weight`` 0), unsup_batch_ratio 2, training BN (its statistics
all-reduced over every rank's rows), and at world 4 CutMix with an
ignore-heavy data index and Cutout at R = 2 (the sub-batches counted in data
indices). The rects are replayed from the JAX key split as
test_torch_ddp_steps.py does; each rank takes its data index's rows of the
global batch and the step cuts its rows of them. Held: the ranks end bit-
identical; losses within 1e-5 relative and conf_rate within two flipped
pixels of JAX's and of the port alone; parameters within Adam's
2 * lr * steps of both.
"""

import warnings

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.core import train_state as jts
from cutmix_seg_tpu.masks.box_mask import BoxMaskConfig as JBoxMaskConfig
from cutmix_seg_tpu.masks.box_mask import sample_box_rects as jax_sample_box_rects
from cutmix_seg_tpu.models.common import SegModel as JSegModel
from cutmix_seg_tpu.models.deeplab2 import DeepLab2 as JDeepLab2
from cutmix_seg_tpu.models.deeplab2 import _param_label as j_param_label
from cutmix_seg_tpu.parallel.mesh import make_mesh
from cutmix_seg_tpu.parallel.spatial import jit_spatial_step
from cutmix_seg_tpu.semisup import mask_mt as jmm
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from tests import _torch_ranks as ranks
from tests.test_torch_ddp_steps import ATOL, RTOL, STEPS, check_close_to_port, check_ranks_identical
from tests.test_torch_models import random_variables

torch.set_num_threads(1)

HW, C, LR, S = (36, 22), ranks.C, ranks.LR, 2
CASES = {  # name: (world, config kwargs, batch options)
    "mix": (2, dict(mask_mode="mix", conf_thresh=0.34), {}),
    "zero_per_pixel": (2, dict(mask_mode="zero", conf_thresh=0.34, conf_per_pixel=True), {}),
    "supervised": (2, dict(mask_mode="mix", cons_weight=0.0), {}),
    "zero_ratio2": (2, dict(mask_mode="zero", conf_thresh=0.3, unsup_batch_ratio=2),
                    dict(ratio=2)),
    "mix_training_bn": (2, dict(mask_mode="mix", conf_thresh=0.34, freeze_bn=False), {}),
    "2x2_mix_ignore_heavy": (4, dict(mask_mode="mix", conf_thresh=0.34), dict(ignore_d1=0.97)),
    "2x2_zero_ratio2": (4, dict(mask_mode="zero", conf_thresh=0.3, unsup_batch_ratio=2),
                        dict(ratio=2)),
}
WORLDS = (2, 4)


def make_batch(mode, n, seed, ratio=1, ignore_d1=0.0):
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
    keys = ("ux0", "ux1") if mode == "mix" else ("ux",)
    for k in keys:
        b[f"{k}_tea"] = rng.randn(n * ratio, h, w, 3).astype(np.float32)
        b[f"{k}_stu"] = b[f"{k}_tea"]
    for k in (("um0", "um1") if mode == "mix" else ("um",)):
        b[k] = (rng.rand(n * ratio, h, w, 1) > 0.2).astype(np.float32)
    return b


class SpatialCase:
    """One case: the JAX state, config and global batch, the draws replayed
    from the JAX key split, and ``port_case`` for the port's runs."""

    def __init__(self, name):
        world, kw, bkw = CASES[name]
        self.world, self.name = world, name
        kw = dict({"cons_weight": 1.0, "freeze_bn": True}, **kw)
        self.jmodel = JSegModel(name="tiny", module=JDeepLab2(num_classes=C, layers=(1, 1, 1, 1)),
                                mean=np.zeros(3), std=np.ones(3), block_size=(1, 1),
                                param_label=j_param_label)
        variables = random_variables(self.jmodel.module, HW, 3)
        jstate, self.tx = jts.create_train_state(
            self.jmodel, jts.OptimizerConfig(opt_type="adam", learning_rate=LR),
            jax.random.PRNGKey(0), input_hw=HW, mean_teacher=True, pretrained=False)
        student = jts.ModelState(params=variables["params"], batch_stats=variables["batch_stats"])
        self.jstate = jstate.replace(student=student, teacher=student)
        self.jcfg = jmm.MaskConsistencyConfig(**dict(kw, box=JBoxMaskConfig((0.5, 0.5))))
        self.nb = make_batch(kw["mask_mode"], world // S * 2, sorted(CASES).index(name), **bkw)
        n_unsup = self.nb["ux0_stu" if "ux0_stu" in self.nb else "ux_stu"].shape[0]
        self.gate_px = n_unsup * HW[0] * HW[1]
        draws, rng = [], self.jstate.rng
        for _ in range(STEPS):
            k_mask = jax.random.split(rng, 5)[1]
            draws.append({"rects": np.array(jax_sample_box_rects(self.jcfg.box, k_mask,
                                                                 n_unsup, HW))})
            rng = jax.random.split(rng, 5)[0]
        self.port_case = {"model": "deeplab2", "algo": "mask_mt",
                          "cfg": dict(kw, box=BoxMaskConfig((0.5, 0.5))),
                          "state_dict": from_jax_variables(variables), "batch": self.nb,
                          "draws": draws}

    def run_jax(self):
        """(metrics per step, final state) of jax.jit under
        jit_spatial_step on make_mesh(world / S, n_model=S)."""
        mesh = make_mesh(self.world // S, n_model=S)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jstep = jit_spatial_step(jmm.make_mask_mt_step(self.jmodel, self.tx, self.jcfg, mesh),
                                     mesh, self.nb)
        jbatch = {k: jnp.asarray(v) for k, v in self.nb.items()}
        jstate, metrics = self.jstate, []
        for _ in range(STEPS):
            jstate, jm = jstep(jstate, jbatch, jnp.float32(1.0))
            metrics.append({k: float(v) for k, v in jm.items()})
        return metrics, jstate


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(cases, JAX runs, {world: each rank's runs}, the port alone): the
    two spawns (worlds 2 and 4) start first."""
    cases = {name: SpatialCase(name) for name in CASES}
    tmp = tmp_path_factory.mktemp("spatial_steps")
    spawns = {w: ranks.RankProcesses(tmp, {"kind": "steps", "n_model": S, "cases": {
        n: c.port_case for n, c in cases.items() if c.world == w}}, w, timeout=300)
        for w in WORLDS}
    try:
        jax_out = {n: c.run_jax() for n, c in cases.items()}
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
    check_ranks_identical(_ranks_of(runs, name))


def _off_tight(final, js, what):
    """Every element within Adam's 2 * lr * steps of JAX's; returns how
    many are not within 1e-6 (+ 1e-5 relative) of it, of how many
    (``test_torch_train_step._close_params``' two bounds)."""
    want = from_jax_variables({"params": jax.device_get(js.params),
                               "batch_stats": jax.device_get(js.batch_stats)})
    assert set(final) == set(want)
    n_off = n_all = 0
    for k, w in want.items():
        d = (final[k] - w).abs()
        assert d.max().item() <= 2 * LR * STEPS + 1e-6, (what, k, d.max().item())
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
    jm, jstate = jax_out[name]
    got = _ranks_of(runs, name)[0]
    check_metrics(got["metrics"], jm, cases[name].gate_px, name)
    for part, js in (("student", jstate.student), ("teacher", jstate.teacher)):
        n_off, n_all = _off_tight(got["final"][part], js, part)
        allowed = 0.001 * n_all
        if not cases[name].port_case["cfg"]["freeze_bn"]:
            allowed += _off_tight(alone[name]["final"][part], js, part)[0]
        assert n_off <= allowed, (part, n_off, allowed, n_all)


@pytest.mark.parametrize("name", sorted(CASES))
def test_spatial_step_matches_port_alone(runs, name):
    cases, _, _, alone = runs
    got = _ranks_of(runs, name)[0]
    check_metrics(got["metrics"], alone[name]["metrics"], cases[name].gate_px, name)
    check_close_to_port(got["final"], alone[name]["final"], STEPS)
    assert torch.equal(got["generator"], alone[name]["generator"])


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
