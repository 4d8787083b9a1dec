"""The port's standalone evaluator (tools/evaluate_model.py) on the CPU,
against the JAX package's tool on a tiny synthetic VOC tree
(``data/synthetic.py``): the same weights (a tiny DeepLab v2 registered in
both registries, JAX variables bridged by ``from_jax_variables``) give the
same per-class IoU within 1e-6; ``--checkpoint`` picks a port checkpoint's
student or teacher; the pi-model's teacher, the usage errors and the
trainers' refusals."""

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cutmix_seg_tpu.core import checkpoint as jckpt
from cutmix_seg_tpu.core.train_state import ModelState
from cutmix_seg_tpu.data import settings as jsettings
from cutmix_seg_tpu.data import sources as jsources
from cutmix_seg_tpu.models import common as jcommon
from cutmix_seg_tpu.models import deeplab2 as jdl
from cutmix_seg_tpu.models import registry as jreg
from cutmix_seg_tpu.tools import evaluate_model as jtool
from cutmix_seg_tpu.train import common as jtrain_common
from cutmix_seg_tpu_torch.core import checkpoint as tckpt
from cutmix_seg_tpu_torch.core.train_state import OptimizerConfig, create_train_state
from cutmix_seg_tpu_torch.data import settings as tsettings
from cutmix_seg_tpu_torch.data import sources as tsources
from cutmix_seg_tpu_torch.data.synthetic import write_config, write_voc_tree
from cutmix_seg_tpu_torch.models import registry as treg
from cutmix_seg_tpu_torch.models.common import SegModel
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.parallel import mesh as tmesh
from cutmix_seg_tpu_torch.tools import evaluate_model as ttool
from tests._torch_tmp import drop_tmp_path_if_passed  # noqa: F401
from tests.test_torch_models import random_variables

torch.set_num_threads(1)

ARCH = "tiny_deeplab2_eval_torch_test"
LAYERS = (1, 1, 1, 1)
MEAN, STD = np.asarray([0.45, 0.45, 0.45]), np.asarray([0.25, 0.25, 0.25])
NUM_CLASSES = 21


@pytest.fixture(autouse=True)
def tiny_arch(monkeypatch):
    """The tiny arch in both registries for the test's duration (every
    worker imports every test file: a registration at import would show in
    other files' registry checks)."""
    monkeypatch.setitem(jreg._ARCHS, ARCH, lambda num_classes, dtype=None, pretrained=True:
                        jcommon.SegModel(name=ARCH, module=jdl.DeepLab2(num_classes=num_classes,
                                                                        layers=LAYERS),
                                         mean=MEAN, std=STD, block_size=(1, 1),
                                         param_label=jdl._param_label))
    monkeypatch.setitem(treg._ARCHS, ARCH, lambda num_classes, dtype=None, pretrained=True:
                        SegModel(ARCH, DeepLab2(num_classes, layers=LAYERS, dtype=dtype), MEAN,
                                 STD, (1, 1), _param_label))

COMMON = ["--dataset", "pascal", "--arch", ARCH, "--batch_size", "2",
          "--compute_dtype", "float32"]


@pytest.fixture
def voc(tmp_path, monkeypatch):
    """A tiny VOC tree (6 train + 5 val images, 36-48 px) named by a cfg in
    $CUTMIX_SEG_CONFIG, read by both packages, on a 48x48 canvas."""
    root = write_voc_tree(str(tmp_path / "VOC2012"), 6, 5, size_range=(36, 48), seed=4)
    monkeypatch.setenv("CUTMIX_SEG_CONFIG", write_config(str(tmp_path / "seg.cfg"), root))
    for settings, sources in ((tsettings, tsources), (jsettings, jsources)):
        monkeypatch.setattr(settings, "_config", None)
        monkeypatch.setattr(sources.PascalVOCDataSource, "canvas_hw", (48, 48))
    return root


def _variables(seed):
    return random_variables(jdl.DeepLab2(num_classes=NUM_CLASSES, layers=LAYERS), (33, 33),
                            seed)


def _port_eval(args):
    return ttool.main.main(COMMON + ["--device", "cpu"] + args, standalone_mode=False)


def _jax_eval(args, monkeypatch):
    got = []
    real = jtrain_common.evaluate

    def recording(*a, **kw):
        got.append(real(*a, **kw))
        return got[-1]

    monkeypatch.setattr(jtrain_common, "evaluate", recording)
    res = CliRunner().invoke(jtool.main, COMMON + ["--n_devices", "1"] + args,
                             catch_exceptions=False)
    assert res.exit_code == 0, res.output
    return got[-1], res.output


def test_model_path_matches_jax_tool(voc, tmp_path, monkeypatch, capsys):
    variables = _variables(0)
    jpath, tpath = str(tmp_path / "model.msgpack"), str(tmp_path / "model.pt")
    jckpt.export_params(jpath, ModelState(params=variables["params"],
                                          batch_stats=variables["batch_stats"]))
    torch.save(from_jax_variables(variables), tpath)
    want, jout = _jax_eval(["--model_path", jpath], monkeypatch)
    iou = _port_eval(["--model_path", tpath])
    out = capsys.readouterr().out
    assert iou.shape == (NUM_CLASSES,) and np.nanmax(iou) > 0
    np.testing.assert_allclose(iou, np.asarray(want), rtol=0, atol=1e-6)
    # the same two printed lines as JAX's
    assert out.splitlines()[-2:] == jout.splitlines()[-2:]
    assert out.splitlines()[-2].startswith("VAL mIoU=")


def _port_checkpoint(ckpt_dir, mean_teacher):
    model = treg.get(ARCH)(NUM_CLASSES, pretrained=False)
    state, _ = create_train_state(model, OptimizerConfig(), 0, device="cpu",
                                  mean_teacher=mean_teacher, pretrained=False)
    state.student.load_state_dict(from_jax_variables(_variables(0)))
    if mean_teacher:
        state.teacher.load_state_dict(from_jax_variables(_variables(1)))
    return tckpt.save_checkpoint(ckpt_dir, state, 7)


@pytest.mark.parametrize("net, seed", [("student", 0), ("teacher", 1)])
def test_checkpoint_net_matches_jax_on_that_net(net, seed, voc, tmp_path, monkeypatch):
    ckpt_dir = str(tmp_path / "checkpoints")
    path = _port_checkpoint(ckpt_dir, mean_teacher=True)
    variables = _variables(seed)
    jpath = str(tmp_path / f"{net}.msgpack")
    jckpt.export_params(jpath, ModelState(params=variables["params"],
                                          batch_stats=variables["batch_stats"]))
    want, _ = _jax_eval(["--model_path", jpath], monkeypatch)
    for where in (ckpt_dir, path):  # the directory's newest, or the file
        iou = _port_eval(["--checkpoint", where, "--net", net])
        np.testing.assert_allclose(iou, np.asarray(want), rtol=0, atol=1e-6)


def test_usage_errors(voc, tmp_path):
    path = _port_checkpoint(str(tmp_path / "pi"), mean_teacher=False)
    runner = CliRunner()
    res = runner.invoke(ttool.main, COMMON + ["--device", "cpu", "--checkpoint", path,
                                              "--net", "teacher"])
    assert res.exit_code == 2 and "pi-model" in res.output
    assert _port_eval(["--checkpoint", path, "--net", "student"]).shape == (NUM_CLASSES,)
    for args in ([], ["--model_path", "a.pt", "--checkpoint", path]):
        res = runner.invoke(ttool.main, COMMON + ["--device", "cpu"] + args)
        assert res.exit_code == 2 and "exactly one of" in res.output
    (tmp_path / "empty").mkdir()
    res = runner.invoke(ttool.main, COMMON + ["--device", "cpu", "--checkpoint",
                                              str(tmp_path / "empty")])
    assert res.exit_code == 2 and "no checkpoints" in res.output
    res = runner.invoke(ttool.main, COMMON + ["--device", "cpu", "--model_path", "x.pt",
                                              "--split", "test"])
    assert res.exit_code == 2 and "no test split" in res.output


def test_refusals_follow_the_trainers(voc, tmp_path, monkeypatch):
    """The trainers' refusals before the data loads; over several ranks
    --eval_spatial takes every JAX arch (PSPNet here: the tool reaches its
    data), and a network registered outside them without
    ``supports_spatial`` is refused, naming ROADMAP A6c, where the eval
    first splits it."""
    with pytest.raises(ValueError, match="--n_devices 2"):
        _port_eval(["--model_path", "unused.pt", "--n_devices", "2"])
    monkeypatch.setattr(tmesh, "world", lambda: 2)

    def no_data(*a, **k):
        raise AssertionError("reached the data")

    with monkeypatch.context() as mp:
        mp.setattr(ttool.datasets, "load_dataset", no_data)
        with pytest.raises(AssertionError, match="reached the data"):
            ttool.main.main(["--dataset", "pascal", "--arch", "resnet101_pspnet_imagenet",
                             "--model_path", "unused.pt", "--eval_spatial", "--device", "cpu"],
                            standalone_mode=False)
    no_spatial = type("NoSpatialDeepLab2", (DeepLab2,), {"supports_spatial": False})
    monkeypatch.setitem(treg._ARCHS, ARCH, lambda num_classes, dtype=None, pretrained=True:
                        SegModel(ARCH, no_spatial(num_classes, layers=LAYERS, dtype=dtype), MEAN,
                                 STD, (1, 1), _param_label))
    path = str(tmp_path / "model.pt")
    torch.save(DeepLab2(NUM_CLASSES, layers=LAYERS).state_dict(), path)
    # rank 0 of two (no process group: the refusal comes before any collective)
    monkeypatch.setattr(tmesh, "data_mesh", lambda n_model=1: tmesh.Mesh(2, 0, n_model))
    with pytest.raises(NotImplementedError, match="NoSpatialDeepLab2.*ROADMAP A6c"):
        _port_eval(["--model_path", path, "--eval_spatial"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttool.main.main(COMMON + ["--model_path", "unused.pt"], standalone_mode=False)
