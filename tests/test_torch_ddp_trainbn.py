"""Training BN and dropout at world 2 (two gloo ranks on the CPU) against
``jax.jit`` of the JAX steps under ``parallel.mesh.jit_sharded_step`` on a
2-device mesh: test_torch_trainbn.py's tiny two-BN + dropout model, 2 steps.

The JAX step normalises with the statistics of the global batch; the port's
BatchNorm all-reduces its float32 sums through ``mesh.all_reduce_sum``,
whose backward carries the gradient through the global statistics to both
ranks. Dropout masks are injected by call order for the global batch (mask
k from seed 300 + k, test_torch_trainbn.StepMasks), each rank taking its
rows; at grad_accum 2 the rows of the global chunk, whose masks wrap at one
chunk's count (the JAX scan body is traced once).

Held as test_torch_ddp_steps.py holds its cases, with test_torch_trainbn's
``_close`` for the parameters (within Adam's 2 * lr * steps, all but 1% of
the elements within 1e-6 + 1e-5 relative), and the running statistics of
student and teacher within 1e-5 of JAX's (relative to max(1, |value|)).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.models import common as jcommon
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from tests import _torch_ranks as ranks
from tests import test_torch_trainbn as tbn
from tests.test_torch_ddp_steps import (
    HW,
    STEPS,
    JaxCase,
    check_ranks_identical,
    check_ranks_match_jax,
    check_world2_matches_world1,
    make_batch,
    run_all,
)
from tests.test_torch_models_families import fill, patch_dropout

torch.set_num_threads(1)

STATS_RTOL = 1e-5
CASES = {  # name: (algorithm, config kwargs, dropout draws per chunk)
    "mask_mt_mix": ("mask_mt", dict(mask_mode="mix", conf_thresh=0.34), 4),
    "mask_mt_mix_pi": ("mask_mt", dict(mask_mode="mix", conf_thresh=0.0,
                                       mean_teacher=False), 4),
    "ict": ("ict", dict(ict_alpha=0.5, conf_thresh=0.34), 4),
    "vat_teacher_direction": ("vat", dict(conf_thresh=0.34, vat_radius=0.5), 3),
    "aug_mt": ("aug", dict(conf_thresh=0.34), 3),
    "mask_mt_mix_accum2": ("mask_mt", dict(mask_mode="mix", conf_thresh=0.34,
                                           grad_accum=2), 4),
}


def trainbn_case(name):
    algo, kw, per_chunk = CASES[name]
    kw = dict(kw, cons_weight=1.0, freeze_bn=False)
    jmodel = jcommon.SegModel(name="tiny", module=tbn.JTiny(), mean=np.zeros(3), std=np.ones(3),
                              block_size=(1, 1),
                              param_label=lambda p: jcommon.label_params_by_path(p, tbn.RULES))
    shapes = jax.eval_shape(lambda: tbn.JTiny().init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1,) + HW + (3,)), train=False))
    nb = make_batch(algo, kw.get("mask_mode"), seed=10 + sorted(CASES).index(name))
    jc = JaxCase(jmodel, fill(shapes, 3), algo, kw, nb, "tinybn", tree=True)
    jc.port_case["masks_per_chunk"] = per_chunk
    return jc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcases = {name: trainbn_case(name) for name in CASES}
    with pytest.MonkeyPatch.context() as mp:
        masks = tbn.StepMasks()
        patch_dropout(mp, masks)

        def masks_for(name):
            # the traced step (or scan body) draws one chunk's masks
            masks.per_step = CASES[name][2]
            return masks

        out = run_all(tmp_path_factory.mktemp("ddp_trainbn"), jcases, masks_for)
    return (jcases,) + out


def _close(module, js, part):
    tbn._close(module, js.params, js.batch_stats, part)
    want = from_jax_variables({"batch_stats": jax.device_get(js.batch_stats)}, "tree")
    got = module.state_dict()
    for k, w in want.items():
        d = (got[k] - w).abs().max().item()
        assert d <= STATS_RTOL * max(float(w.abs().max()), 1.0), (part, k, d)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ranks_end_bit_identical(runs, name):
    _, _, world2, _ = runs
    check_ranks_identical([out[name] for out in world2])


@pytest.mark.parametrize("name", sorted(CASES))
def test_world2_step_matches_jax_sharded_step(runs, name):
    jcases, jax_out, world2, _ = runs
    check_ranks_match_jax(jcases[name], world2[0][name], jax_out[name], _close)


@pytest.mark.parametrize("name", sorted(CASES))
def test_world2_step_matches_world1(runs, name):
    jcases, _, world2, world1 = runs
    check_world2_matches_world1(jcases[name], world2[0][name], world1[name])


def test_running_statistics_moved(runs):
    jcases, _, world2, _ = runs
    for name, jc in jcases.items():
        start = jc.port_case["state_dict"]
        final = world2[0][name]["final"]["student"]
        moved = [k for k in start if "running" in k and not torch.equal(final[k], start[k])]
        assert moved, name


def test_bn_gradient_flows_through_global_statistics(tmp_path):
    """BatchNorm in training mode at world 2: each rank's input gradient and
    the summed weight gradients equal a one-process forward/backward over
    the global batch; the ranks' running statistics equal its."""
    out = ranks.run_ranks(tmp_path, {"kind": "bn_grad"}, 2)
    want = ranks.bn_grad_reference()
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["x_grad"], want["x_grad"][r * 3:(r + 1) * 3],
                                   rtol=1e-5, atol=1e-6)
        for k in ("weight_grad", "bias_grad", "running_mean", "running_var"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # statistics outside the gradient (a plain all_reduce under the graph)
    # would give another input gradient: the test can see it
    assert np.abs(want["x_grad"] - want["x_grad_const_stats"]).max() > 1e-2
