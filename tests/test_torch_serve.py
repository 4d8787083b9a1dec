"""The port's serving path (serve/export.py, serve/http.py,
tools/export_model.py, tools/serve_bench.py) and utils/profiling.py on the
CPU, held to the JAX package's serve/export.py and tools/export_model.py.

The tiny DeepLab v2 (layers (1, 1, 1, 1)) takes JAX variables with random
frozen-BN statistics, bridged by ``from_jax_variables``. Labels must equal
JAX's except where JAX's top-two logit gap is below 1e-5 (both sides sum
the convolutions in another order); float32 logits are within rtol 1e-4 /
atol 1e-5 (the bound of test_torch_models.py). One artifact serves batches
1 and 3. The other families export at 64^2 and are held to the port's own
forward.
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from click.testing import CliRunner
from PIL import Image

from cutmix_seg_tpu.core import checkpoint as jckpt
from cutmix_seg_tpu.core.train_state import ModelState
from cutmix_seg_tpu.models import common as jcommon
from cutmix_seg_tpu.models import deeplab2 as jdl
from cutmix_seg_tpu.models import registry as jreg
from cutmix_seg_tpu.serve import export as jexport
from cutmix_seg_tpu.tools import export_model as jexport_model
from cutmix_seg_tpu_torch.core import checkpoint as tckpt
from cutmix_seg_tpu_torch.models import registry as treg
from cutmix_seg_tpu_torch.models.common import SegModel, init_weights
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label
from cutmix_seg_tpu_torch.models.deeplab3 import DeepLabV3, DeepLabV3Plus
from cutmix_seg_tpu_torch.models.denseunet import DenseUNet
from cutmix_seg_tpu_torch.models.pspnet import PSPNet
from cutmix_seg_tpu_torch.models.resunet import ResUNet
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.parallel import spatial
from cutmix_seg_tpu_torch.parallel.mesh import Mesh
from cutmix_seg_tpu_torch.serve import export as texport
from cutmix_seg_tpu_torch.serve import http as thttp
from cutmix_seg_tpu_torch.tools import export_model as texport_model
from cutmix_seg_tpu_torch.tools import serve_bench
from cutmix_seg_tpu_torch.utils import profiling
from tests._torch_tmp import drop_tmp_path_if_passed  # noqa: F401
from tests.test_torch_models import random_variables

torch.set_num_threads(1)

C = 4
LAYERS = (1, 1, 1, 1)
MEAN, STD = np.asarray([0.4, 0.45, 0.5]), np.asarray([0.2, 0.25, 0.3])
ARCH = "tiny_deeplab2_serve_torch_test"
TIE = 1e-5


def _jax_model():
    return jcommon.SegModel(name=ARCH, module=jdl.DeepLab2(num_classes=C, layers=LAYERS),
                            mean=MEAN, std=STD, block_size=(1, 1), param_label=jdl._param_label)


def _port_model(dtype=None):
    return SegModel(ARCH, DeepLab2(C, layers=LAYERS, dtype=dtype), MEAN, STD, (1, 1),
                    _param_label)


@pytest.fixture(autouse=True)
def tiny_arch(monkeypatch):
    """The tiny arch in both registries for the test's duration (every
    worker imports every test file: a registration at import would show in
    other files' registry checks)."""
    monkeypatch.setitem(jreg._ARCHS, ARCH,
                        lambda num_classes, dtype=None, pretrained=True: _jax_model())
    monkeypatch.setitem(treg._ARCHS, ARCH,
                        lambda num_classes, dtype=None, pretrained=True: _port_model(dtype))


@pytest.fixture(scope="module")
def weights():
    """JAX variables of the tiny DeepLab v2 (random frozen-BN statistics) and
    the port's model holding the same weights."""
    variables = random_variables(_jax_model().module, (33, 33), 0)
    model = _port_model()
    model.module.load_state_dict(from_jax_variables(variables), strict=True)
    return variables, model


def _state(variables):
    return ModelState(params=variables["params"], batch_stats=variables["batch_stats"])


def _images(b, hw, seed):
    return np.random.RandomState(seed).randint(0, 256, (b,) + tuple(hw) + (3,)).astype(np.uint8)


def assert_labels_match_jax(labels, x, variables):
    """Labels equal JAX's serving labels except where JAX's top-two logit
    gap is below TIE."""
    model = _jax_model()
    ref = np.asarray(jexport.make_serving_fn(model, _state(variables))(jnp.asarray(x)))
    logits = np.asarray(jexport.make_serving_fn(model, _state(variables), output="logits")(
        jnp.asarray(x)))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    differ = labels != ref
    assert not (differ & (top2[..., 1] - top2[..., 0] >= TIE)).any()
    assert differ.mean() < 1e-3
    assert len(np.unique(ref)) > 1  # the comparison means something


@pytest.fixture(scope="module")
def artifact(weights, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "tiny.pt2")
    texport.export_serving_artifact(weights[1], (40, 48), path, device="cpu", num_classes=C)
    return path


def test_artifact_serves_batches_1_and_3_as_jax(weights, artifact):
    call, meta = texport.load_serving_artifact(artifact)
    assert meta["input_hw"] == [40, 48] and meta["output"] == "argmax"
    for b in (1, 3):  # symbolic batch: one artifact
        x = _images(b, (40, 48), b)
        labels = call(torch.from_numpy(x))
        assert labels.shape == (b, 40, 48) and labels.dtype == torch.int32
        assert not labels.requires_grad
        assert_labels_match_jax(labels.numpy(), x, weights[0])


def test_logits_artifact_matches_jax(weights, tmp_path):
    path = str(tmp_path / "logits.pt2")
    texport.export_serving_artifact(weights[1], (33, 33), path, output="logits", device="cpu")
    call, meta = texport.load_serving_artifact(path)
    x = _images(2, (33, 33), 7)
    logits = call(torch.from_numpy(x))
    assert logits.dtype == torch.float32 and not logits.requires_grad
    ref = np.asarray(jexport.make_serving_fn(_jax_model(), _state(weights[0]), output="logits")(
        jnp.asarray(x)))
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(logits.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_metadata_has_the_jax_keys(weights, artifact, tmp_path):
    jpath = str(tmp_path / "tiny.jaxexport")
    jexport.export_serving_artifact(_jax_model(), _state(weights[0]), (40, 48), jpath,
                                    platforms=("cpu",), num_classes=C)
    with open(jpath + ".json") as f:
        jmeta = json.load(f)
    with open(artifact + ".json") as f:
        meta = json.load(f)
    assert meta.keys() == jmeta.keys()
    for k in ("model", "input_hw", "input_dtype", "output", "num_classes", "mean", "std"):
        assert meta[k] == jmeta[k], k
    assert meta["platforms"] == ["cpu"]
    assert meta["format"] == "torch.export ExportedProgram"
    assert meta["bytes"] == os.path.getsize(artifact)


def test_export_model_cli_matches_jax_cli(weights, tmp_path):
    variables, model = weights
    tparams, jparams = str(tmp_path / "model.pt"), str(tmp_path / "model.msgpack")
    tckpt.export_params(tparams, model.module)
    jckpt.export_params(jparams, _state(variables))
    common = ["--arch", ARCH, "--num_classes", str(C), "--hw", "33,33", "--dtype", "float32"]
    tout, jout = str(tmp_path / "cli.pt2"), str(tmp_path / "cli.jaxexport")
    res = CliRunner().invoke(texport_model.main, common + [
        "--params", tparams, "--out", tout, "--device", "cpu"])
    assert res.exit_code == 0, res.output
    res = CliRunner().invoke(jexport_model.main, common + [
        "--params", jparams, "--out", jout, "--platforms", "cpu"])
    assert res.exit_code == 0, res.output
    tcall, tmeta = texport.load_serving_artifact(tout)
    jcall, jmeta = jexport.load_serving_artifact(jout)
    x = _images(2, (33, 33), 3)
    labels = tcall(torch.from_numpy(x)).numpy()
    assert_labels_match_jax(labels, x, variables)
    jl = np.asarray(jcall(x))
    assert (labels != jl).mean() < 1e-3
    assert tmeta["model"] == jmeta["model"] == ARCH


def test_export_model_cli_warns_on_fresh_weights(tmp_path):
    res = CliRunner().invoke(texport_model.main, [
        "--arch", ARCH, "--num_classes", str(C), "--hw", "33,33", "--out",
        str(tmp_path / "fresh.pt2"), "--device", "cpu", "--dtype", "float32"])
    assert res.exit_code == 0, res.output
    assert "FRESH weights" in res.output
    assert os.path.exists(tmp_path / "fresh.pt2.json")


def test_artifact_loads_in_a_torch_only_process(weights, artifact, tmp_path):
    """Loading needs torch alone: a process started outside the repo, with
    nothing of either package importable, runs the artifact."""
    x = _images(3, (40, 48), 5)
    torch.save(torch.from_numpy(x), tmp_path / "x.pt")
    script = (
        "import sys, torch\n"
        f"call = torch.export.load({artifact!r}).module()\n"
        f"y = call(torch.load({str(tmp_path / 'x.pt')!r}))\n"
        f"torch.save(y, {str(tmp_path / 'y.pt')!r})\n"
        "assert not [m for m in sys.modules if m.startswith('cutmix_seg_tpu')]\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    y = torch.load(tmp_path / "y.pt")
    call, _ = texport.load_serving_artifact(artifact)
    assert torch.equal(y, call(torch.from_numpy(x)))
    assert_labels_match_jax(y.numpy(), x, weights[0])


def test_http_host_roundtrip(weights, artifact):
    call, meta = texport.load_serving_artifact(artifact)
    server = ThreadingHTTPServer(("127.0.0.1", 0), thttp.make_handler(call, meta))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == meta
        x = _images(1, (40, 48), 9)
        buf = io.BytesIO()
        Image.fromarray(x[0]).save(buf, format="PNG")
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=buf.getvalue())
        with urllib.request.urlopen(req, timeout=60) as r:
            pred = np.asarray(Image.open(io.BytesIO(r.read())))
        assert pred.shape == (40, 48) and pred.dtype == np.uint8
        np.testing.assert_array_equal(pred, call(torch.from_numpy(x))[0].numpy())
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nothing", timeout=30)
    finally:
        server.shutdown()
        server.server_close()


FAMILIES = {
    "densenet161unet": (lambda: DenseUNet(C, block_config=(2, 2, 2, 2)), (32, 32)),
    "resunet": (lambda: ResUNet(C, layers=LAYERS), (32, 32)),
    "deeplabv3": (lambda: DeepLabV3(C, layers=LAYERS), (1, 1)),
    "deeplabv3plus": (lambda: DeepLabV3Plus(C, layers=LAYERS), (1, 1)),
    "pspnet": (lambda: PSPNet(C, layers=LAYERS), (1, 1)),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_each_family_exports_at_64(family, tmp_path):
    make, block = FAMILIES[family]
    model = SegModel(family, make(), MEAN, STD, block, _param_label)
    init_weights(model.module, torch.Generator().manual_seed(1))
    path = str(tmp_path / f"{family}.pt2")
    texport.export_serving_artifact(model, (64, 64), path, device="cpu", num_classes=C)
    call, meta = texport.load_serving_artifact(path)
    serve = texport.make_serving_fn(model)
    for b in (1, 2):
        x = torch.from_numpy(_images(b, (64, 64), b))
        labels = call(x)
        assert labels.shape == (b, 64, 64)
        assert torch.equal(labels, serve(x))
    assert not model.module.training


def test_refusals(weights, tmp_path, monkeypatch):
    dense = SegModel("densenet161unet", DenseUNet(C, block_config=(2, 2, 2, 2)), MEAN, STD,
                     (32, 32), _param_label)
    with pytest.raises(ValueError, match="multiples of"):
        texport.export_serving_artifact(dense, (65, 64), str(tmp_path / "d.pt2"), device="cpu")
    no_stats = SegModel("densenet161unet", dense.module, None, None, (32, 32), _param_label)
    with pytest.raises(ValueError, match="no normalisation statistics"):
        texport.export_serving_artifact(no_stats, (64, 64), str(tmp_path / "d.pt2"), device="cpu")
    with pytest.raises(ValueError, match="output must be"):
        texport.make_serving_fn(weights[1], output="probs")
    # a net whose rows are split over ranks
    monkeypatch.setattr(spatial, "model_group", lambda mesh: None)
    net = DeepLab2(C, layers=LAYERS)
    spatial.set_spatial(net, Mesh(2, 0, 2))
    split = SegModel(ARCH, net, MEAN, STD, (1, 1), _param_label)
    with pytest.raises(ValueError, match="serving is one process"):
        texport.export_serving_artifact(split, (33, 33), str(tmp_path / "s.pt2"), device="cpu")
    assert not os.path.exists(tmp_path / "d.pt2") and not os.path.exists(tmp_path / "s.pt2")
    # a CUDA device without CUDA: the entry points raise, never fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texport.export_serving_artifact(weights[1], (33, 33), str(tmp_path / "c.pt2"))
    res = CliRunner().invoke(texport_model.main, [
        "--arch", ARCH, "--num_classes", str(C), "--out", str(tmp_path / "c.pt2")])
    assert isinstance(res.exception, RuntimeError)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_bench.bench(ARCH, C, (33, 33), [1], 1)


def test_serve_bench_on_the_cpu(capsys):
    res = serve_bench.main.main(["--arch", ARCH, "--num_classes", str(C), "--hw", "33,33",
                                 "--batches", "1,2", "--iters", "2", "--concrete", "2",
                                 "--device", "cpu"],
                                standalone_mode=False)
    assert res is None
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["card"] is None
    assert sorted(out["batches"]) == ["1", "2"] and sorted(out["concrete_batches"]) == ["2"]
    for rec in list(out["batches"].values()) + list(out["concrete_batches"].values()):
        assert rec["ms_per_call"] > 0 and rec["img_per_s"] > 0
    assert out["artifact_mb"] > 0 and out["export_s"] > 0


def test_profiling_helpers(tmp_path):
    """The trainers' profiler start and export: a CPU trace of a span,
    written as ``trace.json``."""
    cpu = torch.device("cpu")
    prof = profiling.start_profile(cpu)
    with torch.profiler.record_function("trainer.step"):
        torch.ones(8).sum()
    profiling.stop_profile(prof, cpu, str(tmp_path / "prof"))
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert [e["name"] for e in events if e.get("name") == "trainer.step"] == ["trainer.step"]
    assert any(e.get("name") == "aten::sum" for e in events)