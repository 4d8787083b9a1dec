"""The four steps at world 2 (two gloo ranks on the CPU, ``parallel.mesh``)
against ``jax.jit`` of the JAX steps under ``parallel.mesh.jit_sharded_step``
on a 2-device mesh, over the same global batch and injected global draws:
the tiny DeepLab v2 of test_torch_train_step.py with frozen BN, 2 steps
(the other algorithms and grad_accum: test_torch_ddp_algos.py; training BN
and dropout: test_torch_ddp_trainbn.py).

Rank r takes rows [r*n, (r+1)*n) of each global array (the unsupervised
ones have R times the rows), and the draws (boxes, lambdas, VAT noise,
replayed from the JAX key split) are global: each rank keeps its rows. The
cases cover what the global batch changes: the CE's denominator (one rank's
slice nearly all ignore), the batch-mean gate's rate (partial gates 0.3 and
0.4), and the sub-batches at unsup_batch_ratio 2 (the global unsupervised
batch is [rank 0's 2n rows | rank 1's], so rank 0's rows are all of
sub-batch 0).

Each case is held three ways: the ranks end bit-identical; the port at
world 2 against JAX (losses rtol 1e-5, conf_rate within two flipped
pixels, parameters as ``_close_params`` holds them: within Adam's
2 * lr * steps); and against the port at world 1 on the global batch, with
the same tolerances. One spawn of two ranks runs every case of the file,
started before the JAX runs.
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
from cutmix_seg_tpu.models.common import SegModel as JSegModel
from cutmix_seg_tpu.models.deeplab2 import DeepLab2 as JDeepLab2
from cutmix_seg_tpu.models.deeplab2 import _param_label as j_param_label
from cutmix_seg_tpu.parallel.mesh import jit_sharded_step, make_mesh
from cutmix_seg_tpu.semisup import aug_cons as jaug
from cutmix_seg_tpu.semisup import ict as jict
from cutmix_seg_tpu.semisup import mask_mt as jmm
from cutmix_seg_tpu.semisup import vat as jvat
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from tests import _torch_ranks as ranks
from tests.test_torch_algorithms import _ict_lam, _vat_eps0
from tests.test_torch_models import random_variables
from tests.test_torch_resample import _thetas
from tests.test_torch_train_step import _close_params

torch.set_num_threads(1)

N, HW, C, LR = 4, (33, 33), ranks.C, ranks.LR  # N: the global batch, 2 + 2
STEPS = 2
RTOL, ATOL = 1e-5, 1e-7
WORLD = 2
JAX_CFG = {"mask_mt": jmm.MaskConsistencyConfig, "ict": jict.ICTConfig,
           "vat": jvat.VATConfig, "aug": jaug.AugConsConfig}
JAX_STEP = {"mask_mt": jmm.make_mask_mt_step, "ict": jict.make_ict_step,
            "vat": jvat.make_vat_step, "aug": jaug.make_aug_cons_step}

CASES = {  # name: (algorithm, config kwargs, batch options)
    "mask_mt_mix": ("mask_mt", dict(mask_mode="mix", conf_thresh=0.34), {}),
    "mask_mt_zero_per_pixel": ("mask_mt", dict(mask_mode="zero", conf_thresh=0.34,
                                               conf_per_pixel=True), {}),
    # rank 1's supervised rows are 97% ignore: the CE's denominator is global
    "mask_mt_mix_ignore_heavy": ("mask_mt", dict(mask_mode="mix", conf_thresh=0.34),
                                 dict(ignore_rank1=0.97)),
    "mask_mt_zero_ratio2_gate0.3": ("mask_mt", dict(mask_mode="zero", conf_thresh=0.3,
                                                    unsup_batch_ratio=2), dict(ratio=2)),
    "mask_mt_zero_ratio2_gate0.4": ("mask_mt", dict(mask_mode="zero", conf_thresh=0.4,
                                                    unsup_batch_ratio=2), dict(ratio=2)),
    "mask_mt_mix_ratio2": ("mask_mt", dict(mask_mode="mix", conf_thresh=0.0,
                                           unsup_batch_ratio=2), dict(ratio=2)),
}
# cases whose batch-mean gate must be partial at both steps
PARTIAL_GATES = ("mask_mt_mix", "mask_mt_zero_ratio2_gate0.3", "mask_mt_zero_ratio2_gate0.4")


def make_batch(algo, mode=None, ratio=1, seed=0, ignore_rank1=0.0, n=N):
    """A global numpy batch of every key the step reads."""
    rng = np.random.RandomState(seed)
    h, w = HW
    nu = n * ratio
    labels = rng.randint(0, C, size=(n, h, w)).astype(np.int32)
    labels[rng.rand(n, h, w) < 0.1] = 255
    if ignore_rank1:
        half = labels[n // 2:]
        half[rng.rand(*half.shape) < ignore_rank1] = 255
    b = {"sup_x": rng.randn(n, h, w, 3).astype(np.float32), "sup_y": labels}

    def img():
        return rng.randn(nu, h, w, 3).astype(np.float32)

    def mask():
        return (rng.rand(nu, h, w, 1) > 0.2).astype(np.float32)

    if algo in ("mask_mt", "ict"):
        keys = ("ux0", "ux1") if algo == "ict" or mode == "mix" else ("ux",)
        for k in keys:
            b[f"{k}_tea"] = img()
            b[f"{k}_stu"] = b[f"{k}_tea"] + (0.3 * img() if algo == "ict" else 0.0)
        for k in (("um0", "um1") if len(keys) == 2 else ("um",)):
            b[k] = mask()
    elif algo == "vat":
        b["ux_tea"] = img()
        b["ux_stu"] = b["ux_tea"] + 0.3 * img()
        b["um"] = mask()
    else:
        b["ux0"], b["ux1"], b["um0"], b["um1"] = img(), img(), mask(), mask()
        b["xf0_to_1"] = _thetas(rng, nu)
    return b


def n_unsup(algo, nb):
    return nb[{"mask_mt": "ux0_stu" if "ux0_stu" in nb else "ux_stu", "ict": "ux0_stu",
               "vat": "ux_stu", "aug": "ux0"}[algo]].shape[0]


def jax_draws(algo, rng, jcfg, nb):
    """The global draws of the steps that start from key ``rng``, replayed
    from the JAX steps' key split (each step's key is split(key, 5)[0] of
    the one before)."""
    out = []
    n = n_unsup(algo, nb)
    for _ in range(STEPS):
        at = types.SimpleNamespace(rng=rng)
        if algo == "mask_mt":
            k_mask = jax.random.split(rng, 5)[1]
            out.append({"rects": np.array(jax_sample_box_rects(jcfg.box, k_mask, n, HW))})
        elif algo == "ict":
            out.append({"lam": _ict_lam(at, jcfg.ict_alpha, n).numpy()})
        elif algo == "vat":
            out.append({"eps0": _vat_eps0(at, nb["ux_stu"].shape).numpy()})
        else:
            out.append({})
        rng = jax.random.split(rng, 5)[0]
    return out


class JaxCase:
    """One case on the JAX side: the model, the state before the first
    step, the config, the global batch; ``port_case`` is what the port's
    runs take, ``run`` the jitted JAX steps on a 2-device mesh."""

    def __init__(self, jmodel, variables, algo, kw, nb, port_model, tree=False):
        mean_teacher = kw.get("mean_teacher", True)
        jstate, self.tx = jts.create_train_state(
            jmodel, jts.OptimizerConfig(opt_type="adam", learning_rate=LR),
            jax.random.PRNGKey(0), input_hw=HW, mean_teacher=mean_teacher, pretrained=False)
        student = jts.ModelState(params=variables["params"],
                                 batch_stats=variables["batch_stats"])
        self.jstate = jstate.replace(student=student,
                                     teacher=student if mean_teacher else jstate.teacher)
        self.jmodel, self.algo, self.nb = jmodel, algo, nb
        jkw = dict(kw, box=JBoxMaskConfig((0.5, 0.5))) if algo == "mask_mt" else kw
        self.jcfg = JAX_CFG[algo](**jkw)
        self.draws = jax_draws(algo, self.jstate.rng, self.jcfg, nb)
        self.port_case = {
            "model": port_model, "algo": algo,
            "cfg": dict(kw, box=BoxMaskConfig((0.5, 0.5))) if algo == "mask_mt" else dict(kw),
            "state_dict": from_jax_variables(variables, "tree" if tree else "deeplab2"),
            "batch": nb, "draws": self.draws}

    def run(self, masks=None):
        """(metrics per step, final state)."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the batch-mean gate's grad_accum warning
            jstep = jit_sharded_step(JAX_STEP[self.algo](self.jmodel, self.tx, self.jcfg),
                                     make_mesh(WORLD))
        jbatch = {k: jnp.asarray(v) for k, v in self.nb.items()}
        jstate, metrics = self.jstate, []
        for i in range(STEPS):
            if masks is not None:
                masks.k = 0
            rng = np.asarray(jstate.rng)  # the step donates the state
            jstate, jm = jstep(jstate, jbatch, jnp.float32(1.0))
            # the replayed draws came from this step's key
            assert np.array_equal(np.asarray(jstate.rng),
                                  np.asarray(jax.random.split(jnp.asarray(rng), 5)[0])), i
            metrics.append({k: float(v) for k, v in jm.items()})
        return metrics, jstate


def frozen_case(name, cases):
    """The tiny DeepLab v2 with frozen BN."""
    algo, kw, bkw = cases[name]
    kw = dict(kw, cons_weight=1.0, freeze_bn=True)
    jmodel = JSegModel(name="tiny", module=JDeepLab2(num_classes=C, layers=(1, 1, 1, 1)),
                       mean=np.zeros(3), std=np.ones(3), block_size=(1, 1),
                       param_label=j_param_label)
    nb = make_batch(algo, kw.get("mask_mode"), seed=sorted(cases).index(name), **bkw)
    return JaxCase(jmodel, random_variables(jmodel.module, HW, 3), algo, kw, nb, "deeplab2")


def run_all(tmp_path, jcases, masks_for=None):
    """The two ranks' port runs (one spawn, started first), the JAX runs
    and the port's world-1 runs, for every case."""
    spawn = ranks.RankProcesses(tmp_path, {"kind": "steps", "cases": {
        name: jc.port_case for name, jc in jcases.items()}}, WORLD)
    try:
        jax_out, world1 = {}, {}
        for name, jc in jcases.items():
            masks = masks_for(name) if masks_for else None
            jax_out[name] = jc.run(masks)
            world1[name] = ranks.run_steps(jc.port_case, None)
    except BaseException:
        spawn.kill()
        raise
    return jax_out, spawn.wait(), world1


def check_metrics(got, want, n_gate_px, what):
    one_gate = 1.0 / n_gate_px
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), what
        for k in ("sup_loss", "cons_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} step {i} {k}")
        assert abs(g["conf_rate"] - w["conf_rate"]) <= 2 * one_gate + 1e-7, (what, i)


def check_ranks_identical(outs):
    """Every rank's metrics and state after every step, bit for bit (the
    states' digests)."""
    assert len(outs[0]["digests"]) == STEPS
    assert ranks.digest(outs[0]["final"]) == outs[0]["digests"][-1]
    for other in outs[1:]:
        assert other["metrics"] == outs[0]["metrics"]
        assert other["digests"] == outs[0]["digests"]
        assert torch.equal(other["generator"], outs[0]["generator"])


def check_close_to_port(got_states, want_states, steps):
    for part in want_states:
        for k, w in want_states[part].items():
            d = (got_states[part][k] - w).abs().max().item()
            assert d <= 2 * LR * steps + 1e-6, (part, k, d)


def check_ranks_match_jax(jc, got, jax_out, close):
    jm, jstate = jax_out
    check_metrics(got["metrics"], jm, gate_px(jc), jc.algo)
    assert int(jstate.step) == STEPS
    final = got["final"]
    parts = [("student", jstate.student)] + (
        [("teacher", jstate.teacher)] if "teacher" in final else [])
    for part, js in parts:
        module = ranks.MODELS[jc.port_case["model"]]().module
        module.load_state_dict(final[part])
        close(module, js, part)


def check_world2_matches_world1(jc, got, want):
    check_metrics(got["metrics"], want["metrics"], gate_px(jc), jc.algo)
    check_close_to_port(got["final"], want["final"], STEPS)
    assert torch.equal(got["generator"], want["generator"])


def gate_px(jc):
    return n_unsup(jc.algo, jc.nb) * HW[0] * HW[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcases = {name: frozen_case(name, CASES) for name in CASES}
    return (jcases,) + run_all(tmp_path_factory.mktemp("ddp_steps"), jcases)


def _close_frozen(module, js, part):
    _close_params(module, js.params, js.batch_stats, STEPS, part)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_end_bit_identical(runs, name):
    _, _, world2, _ = runs
    check_ranks_identical([out[name] for out in world2])


@pytest.mark.parametrize("name", sorted(CASES))
def test_world2_step_matches_jax_sharded_step(runs, name):
    jcases, jax_out, world2, _ = runs
    check_ranks_match_jax(jcases[name], world2[0][name], jax_out[name], _close_frozen)


@pytest.mark.parametrize("name", sorted(CASES))
def test_world2_step_matches_world1(runs, name):
    jcases, _, world2, world1 = runs
    check_world2_matches_world1(jcases[name], world2[0][name], world1[name])


def test_gates_and_ignore_are_exercised(runs):
    """The cases that test a global denominator would pass without it
    only if it did not matter: the gates are partial and rank 1's CE
    denominator differs from rank 0's."""
    jcases, jax_out, _, _ = runs
    for name in PARTIAL_GATES:
        rates = [m["conf_rate"] for m in jax_out[name][0]]
        assert all(0.0 < r < 1.0 for r in rates), (name, rates)
    y = jcases["mask_mt_mix_ignore_heavy"].nb["sup_y"]
    valid = [(half != 255).sum() for half in (y[:N // 2], y[N // 2:])]
    assert valid[1] < 0.1 * valid[0], valid
