"""The port's evaluation (ops/iou.py, eval/evaluator.py, train/common.py
``evaluate``) against the JAX package on the CPU.

Confusion matrices are integer counts: bit-equal to both JAX formulations,
also above 2^21 pixels, where the JAX one-hot matmul runs in several
chunks. The eval pass of a tiny DeepLab v2 with weights carried across by
``from_jax_variables`` must give the JAX confusion matrix except at pixels
whose top two JAX logits lie within 1e-4 (a float32 forward in another
summation order may swap their argmax); the test counts those pixels.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.core.train_state import ModelState
from cutmix_seg_tpu.data.loader import eval_batches as j_eval_batches
from cutmix_seg_tpu.eval import evaluator as jev
from cutmix_seg_tpu.models.common import SegModel as JSegModel
from cutmix_seg_tpu.models.deeplab2 import DeepLab2 as JDeepLab2
from cutmix_seg_tpu.models.deeplab2 import _param_label as j_param_label
from cutmix_seg_tpu.ops import iou as jiou
from cutmix_seg_tpu.parallel.mesh import make_mesh
from cutmix_seg_tpu.semisup.stepcore import apply_model
from cutmix_seg_tpu.train import common as jcommon
from cutmix_seg_tpu_torch.data.loader import eval_batches
from cutmix_seg_tpu_torch.eval import evaluator as tev
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.ops import iou as tiou
from cutmix_seg_tpu_torch.train import common as tcommon
from tests.test_torch_models import random_variables

torch.set_num_threads(1)

C = 5
TIE = 1e-4
MEAN, STD = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])


def _labels(shape, c, seed, ignore_frac=0.2):
    rng = np.random.RandomState(seed)
    truth = rng.randint(0, c, size=shape).astype(np.int32)
    truth[rng.rand(*shape) < ignore_frac] = 255
    pred = np.where(rng.rand(*shape) < 0.6, np.where(truth == 255, 0, truth),
                    rng.randint(0, c, size=shape)).astype(np.int32)
    return pred, truth


@pytest.mark.parametrize("shape,c", [((2, 7, 9), 4), ((10, 512, 512), 21)],
                         ids=["small", "10x512x512"])
def test_confusion_matrix_bit_equal_to_both_jax_formulations(shape, c):
    pred, truth = _labels(shape, c, seed=sum(shape))
    if shape[1] == 512:
        assert truth.size > 2 ** 21  # several chunks of the JAX matmul
    cm = tiou.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(truth), c)
    assert cm.dtype == torch.int64 and cm.shape == (c, c)
    j_mm = np.asarray(jiou.confusion_matrix(jnp.asarray(pred), jnp.asarray(truth), c))
    j_sc = np.asarray(jiou._confusion_matrix_scatter(jnp.asarray(pred), jnp.asarray(truth), c))
    np.testing.assert_array_equal(cm.numpy(), j_mm)
    np.testing.assert_array_equal(cm.numpy(), j_sc)
    assert int(cm.sum()) == int((truth != 255).sum())


def test_evaluator_iou_score_matches_jax():
    pred, truth = _labels((3, 11, 13), C, seed=5)
    j, t = jiou.EvaluatorIoU(C), tiou.EvaluatorIoU(C)
    for k in range(3):
        j.update_batch(pred[k:k + 1], truth[k:k + 1])
        t.update_batch(torch.from_numpy(pred[k:k + 1]), torch.from_numpy(truth[k:k + 1]))
    np.testing.assert_array_equal(t.cm, j.cm)
    np.testing.assert_array_equal(t.score(), j.score())
    inter, union = tiou.i_and_u_from_cm(torch.from_numpy(t.cm))
    ji, ju = jiou.i_and_u_from_cm(jnp.asarray(j.cm))
    np.testing.assert_array_equal(inter.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(union.numpy(), np.asarray(ju))


def test_fill_holes_matches_jax():
    pred = np.zeros((2, 12, 12), np.int32)
    pred[:, 2:10, 2:10] = 1
    pred[:, 5:7, 5:7] = 0  # a hole
    truth = np.random.RandomState(6).randint(0, 2, size=pred.shape).astype(np.int32)
    j, t = jiou.EvaluatorIoU(2, fill_holes=True), tiou.EvaluatorIoU(2, fill_holes=True)
    j.update_batch(pred, truth)
    t.update_batch(pred, truth)
    np.testing.assert_array_equal(t.cm, j.cm)
    np.testing.assert_array_equal(t.score(), j.score())
    with pytest.raises(ValueError):
        tiou.EvaluatorIoU(3, fill_holes=True)


def test_normalise_eval_batch_matches_jax():
    rng = np.random.RandomState(7)
    batch = {"canvas": rng.randint(0, 256, size=(3, 10, 12, 3)).astype(np.uint8),
             "labels": rng.randint(0, 256, size=(3, 10, 12)).astype(np.uint8),
             "sizes": np.array([[10, 12], [4, 9], [7, 3]], np.int32)}
    jx, jy, jv = jev.normalise_eval_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                          MEAN, STD)
    tx, ty, tv = tev.normalise_eval_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                                          MEAN, STD)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=2e-6)


class MemorySource:
    """A dataset source held in memory (variable image sizes, 255 borders)."""

    canvas_hw = (40, 44)
    num_classes = C

    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.images, self.labels = [], []
        for _ in range(n):
            h, w = rng.randint(20, 41), rng.randint(20, 45)
            self.images.append(rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8))
            lab = rng.randint(0, C, size=(h, w)).astype(np.int32)
            lab[0] = 255
            self.labels.append(lab)

    def get_image(self, i):
        return self.images[i]

    def get_labels(self, i):
        return self.labels[i]


def test_eval_pass_matches_jax():
    hw = (40, 44)
    jmodel = JSegModel(name="tiny", module=JDeepLab2(num_classes=C, layers=(1, 1, 1, 1)),
                       mean=MEAN, std=STD, block_size=(1, 1), param_label=j_param_label)
    variables = random_variables(jmodel.module, hw, 9)
    jstate = ModelState(params=variables["params"], batch_stats=variables["batch_stats"])
    net = DeepLab2(C, layers=(1, 1, 1, 1))
    net.load_state_dict(from_jax_variables(variables))
    src, indices, bs = MemorySource(5, seed=8), np.arange(5), 2
    mesh = make_mesh(1)

    j_eval = jev.make_sharded_eval_fn(jmodel, C, MEAN, STD, mesh)
    j_cm = np.zeros((C, C), np.int64)
    t_cm = np.zeros((C, C), np.int64)
    n_close = 0
    for jb, tb in zip(j_eval_batches(src, indices, bs), eval_batches(src, indices, bs)):
        for k in ("canvas", "labels", "sizes"):
            np.testing.assert_array_equal(jb[k], tb[k])
        raw = {k: jb[k] for k in ("canvas", "labels", "sizes")}
        j_cm += np.asarray(j_eval(jstate, jcommon._eval_raw_batch(mesh, raw)))
        t_cm += tev.eval_confusion(net, {k: torch.from_numpy(v) for k, v in raw.items()},
                                   C, MEAN, STD).numpy()
        x, y, _ = jev.normalise_eval_batch({k: jnp.asarray(v) for k, v in raw.items()},
                                           MEAN, STD)
        logits, _ = apply_model(jmodel, jstate.params, jstate.batch_stats, x,
                                train=False, freeze_bn=True)
        top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
        n_close += int(((top2[..., 1] - top2[..., 0] < TIE) & (np.asarray(y) != 255)).sum())
    assert j_cm.sum() == t_cm.sum() > 0
    # each near tie can move one count from one cell to another
    assert np.abs(j_cm - t_cm).sum() <= 2 * n_close, (n_close, j_cm - t_cm)

    j_iou = jcommon.evaluate(jmodel, jstate, src, indices, bs, mesh, C, MEAN, STD, (1, 1))
    t_iou = tcommon.evaluate(net, src, indices, bs, C, MEAN, STD, (1, 1), torch.device("cpu"))
    if n_close == 0:
        np.testing.assert_array_equal(t_iou, j_iou)
    else:
        np.testing.assert_allclose(t_iou, j_iou, rtol=0, atol=2 * n_close / t_cm.sum())
