"""The tiny DeepLab v2 (layers (1, 1, 1, 1), frozen BN) with its image H
axis split over two gloo rank processes (``parallel.spatial``,
``--eval_spatial`` at world 2), against ``jit_spatial_forward`` /
``make_spatial_eval_fn`` / ``common.evaluate(spatial=True)`` of the JAX
package on a 2-device CPU mesh (H over 'data'), and against the port alone;
and the tiny DeepLab v3 and v3+ (the torchvision stem's floor pool: 36 rows
give 18, 9 and 5 feature rows, split 9/9, 5/4 and 3/2; the image pooling's
global mean; the half-pixel resizes 5 -> 9 and 9 -> 36) the same way, for
the logits and the confusion matrices.

The input's 36 rows give feature maps of 18, 10 and 5 rows: the stem pool's
10 rows and the 5 rows of layer2-4 split 5/5 and 3/2, and the ASPP's
dilation 6 reaches past the neighbouring rank's rows. Held: the logits
within 2e-5 (float32: the spatial form reads the same inputs in another
summation order), the confusion matrices bit-equal (an odd height, 35,
padded to 36 as ``tests/test_spatial.py`` pads 55 to 56), the eval pass's
IoU equal to JAX's spatial pass and to the port's world-1 pass, and with
hole filling equal to world 1.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.core.train_state import ModelState
from cutmix_seg_tpu.models import deeplab3 as jd3
from cutmix_seg_tpu.models.common import SegModel as JSegModel
from cutmix_seg_tpu.models.deeplab2 import DeepLab2 as JDeepLab2
from cutmix_seg_tpu.models.deeplab2 import _param_label as j_param_label
from cutmix_seg_tpu.parallel import spatial as jspatial
from cutmix_seg_tpu.parallel.mesh import make_mesh
from cutmix_seg_tpu.train import common as jcommon
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from tests import _torch_ranks as ranks
from tests.test_torch_models import random_variables

torch.set_num_threads(1)

C = ranks.C
MEAN, STD = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
WORLD = 2


def _raw_batch(rng, n, hw):
    """A raw eval batch with true extents below the canvas (JAX
    test_spatial's ``_raw_batch``)."""
    h, w = hw
    canvas = rng.randint(0, 256, size=(n, h, w, 3)).astype(np.uint8)
    labels = rng.randint(0, C, size=(n, h, w)).astype(np.int32)
    sizes = np.array([[h, w]] + [[h - 1 - (i * 3) % 9, w - 1 - (i * 2) % 5]
                                 for i in range(n - 1)], np.int32)
    for i, (hh, ww) in enumerate(sizes):
        labels[i, hh:, :] = 255
        labels[i, :, ww:] = 255
    return {"canvas": canvas, "labels": labels, "sizes": sizes}


FAMILIES = {"deeplabv3": jd3.DeepLabV3, "deeplabv3plus": jd3.DeepLabV3Plus}


def _jfamily(name):
    return JSegModel(name="tiny", module=FAMILIES[name](num_classes=C, layers=(1, 1, 1, 1)),
                     mean=MEAN, std=STD, block_size=(1, 1), param_label=jd3._label_imagenet)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(task, JAX model and state, the ranks' results, the port alone,
    {v3 family: (JAX model, state)})."""
    jmodel = JSegModel(name="tiny", module=JDeepLab2(num_classes=C, layers=(1, 1, 1, 1)),
                       mean=MEAN, std=STD, block_size=(1, 1), param_label=j_param_label)
    variables = random_variables(jmodel.module, (36, 22), 11)
    fam_vars = {name: random_variables(_jfamily(name).module, (36, 22), 12 + i)
                for i, name in enumerate(sorted(FAMILIES))}
    rng = np.random.RandomState(0)
    task = {"kind": "spatial_model", "state_dict": from_jax_variables(variables),
            "x": rng.randn(2, 36, 22, 3).astype(np.float32), "mean": MEAN, "std": STD,
            "batches": [_raw_batch(rng, 2, (36, 22)), _raw_batch(rng, 3, (35, 20))],
            "source": ranks.ArraySource(7, 5, (36, 26), C),
            "families": {name: from_jax_variables(v, "tree") for name, v in fam_vars.items()},
            "pad_h": WORLD}
    spawn = ranks.RankProcesses(tmp_path_factory.mktemp("spatial_model"), task, WORLD)
    try:
        alone = ranks.spatial_model_run(task, None)
    except BaseException:
        spawn.kill()
        raise
    mstate = ModelState(params=variables["params"], batch_stats=variables["batch_stats"])
    fams = {name: (_jfamily(name), ModelState(params=v["params"], batch_stats=v["batch_stats"]))
            for name, v in fam_vars.items()}
    return task, jmodel, mstate, spawn.wait(), alone, fams


def test_logits_match_jax_spatial_forward(runs):
    task, jmodel, mstate, world2, alone, _ = runs
    mesh = make_mesh(WORLD)
    xs = jax.device_put(jnp.asarray(task["x"]), jspatial.spatial_sharding(mesh))
    want = np.asarray(jspatial.jit_spatial_forward(jmodel, mesh)(mstate, xs))
    got = torch.cat([r["logits"] for r in world2], dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, alone["logits"].numpy(), rtol=0, atol=2e-5)
    # each rank returned its 18 rows
    assert [r["logits"].shape[1] for r in world2] == [18, 18]


@pytest.mark.parametrize("i", [0, 1])
def test_confusion_matrix_matches_jax_spatial_eval(runs, i):
    """Batch 1 has 35 rows: both sides pad it to 36 (pad_batch_h)."""
    task, jmodel, mstate, world2, alone, _ = runs
    mesh = make_mesh(WORLD)
    batch = jspatial.pad_batch_h(task["batches"][i], WORLD)
    want = np.asarray(jspatial.make_spatial_eval_fn(jmodel, C, jmodel.mean, jmodel.std, mesh)(
        mstate, {k: batch[k] for k in ("canvas", "labels", "sizes")}))
    for r in world2:
        np.testing.assert_array_equal(r["cms"][i].numpy(), want)
    np.testing.assert_array_equal(alone["cms"][i].numpy(), want)
    assert want.sum() > 0


def test_eval_pass_matches_jax_and_world1(runs):
    task, jmodel, mstate, world2, alone, _ = runs
    src = task["source"]
    want = jcommon.evaluate(jmodel, mstate, src, np.arange(len(src.images)), 3,
                            make_mesh(WORLD), C, MEAN, STD, (1, 1), spatial=True)
    for r in world2:
        np.testing.assert_array_equal(r["iou"], want)
        np.testing.assert_array_equal(r["iou_holes"], alone["iou_holes"])
    np.testing.assert_array_equal(alone["iou"], want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_v3_logits_match_jax_spatial_forward(runs, family):
    """Each rank returns its 18 rows; 2e-5 as above (the split resizes
    read the float64 matrix, torch's and JAX's place their samples in
    float32: at 36 rows these differ by 2e-6 relative)."""
    task, _, _, world2, alone, fams = runs
    jmodel, mstate = fams[family]
    mesh = make_mesh(WORLD)
    xs = jax.device_put(jnp.asarray(task["x"]), jspatial.spatial_sharding(mesh))
    want = np.asarray(jspatial.jit_spatial_forward(jmodel, mesh)(mstate, xs))
    got = torch.cat([r[family]["logits"] for r in world2], dim=1).numpy()
    assert [r[family]["logits"].shape[1] for r in world2] == [18, 18]
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale)
    np.testing.assert_allclose(got, alone[family]["logits"].numpy(), rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_v3_confusion_matrix_matches_jax_spatial_eval(runs, family, i):
    task, _, _, world2, alone, fams = runs
    jmodel, mstate = fams[family]
    mesh = make_mesh(WORLD)
    batch = jspatial.pad_batch_h(task["batches"][i], WORLD)
    want = np.asarray(jspatial.make_spatial_eval_fn(jmodel, C, jmodel.mean, jmodel.std, mesh)(
        mstate, {k: batch[k] for k in ("canvas", "labels", "sizes")}))
    for r in world2:
        np.testing.assert_array_equal(r[family]["cms"][i].numpy(), want)
    np.testing.assert_array_equal(alone[family]["cms"][i].numpy(), want)
    assert want.sum() > 0
