"""Ground rules of the PyTorch/CUDA port that a CPU host can check: the port
and chip_smoke.py import nothing of JAX or of the JAX package, every module
imports without a GPU, and the entry points refuse to run without a GPU
unless the caller asks for the CPU."""

import ast
import importlib
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cutmix_seg_tpu_torch
from cutmix_seg_tpu_torch.core.train_state import OptimizerConfig, create_train_state
from cutmix_seg_tpu_torch.models.common import SegModel
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label
from cutmix_seg_tpu_torch.ops import build
from cutmix_seg_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cutmix_seg_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cutmix_seg_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "scripts" / "torch_step_profile.py",
                                         ROOT / "scripts" / "torch_trainer_profile.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_every_module_imports_on_cpu():
    names = [m.name for m in pkgutil.walk_packages(cutmix_seg_tpu_torch.__path__,
                                                   "cutmix_seg_tpu_torch.")]
    for mod in ("semisup.mask_mt", "semisup.ict", "semisup.vat", "semisup.aug_cons",
                "ops.resample", "train.ict", "train.vat_mt", "train.aug_mt",
                "tools.synthetic_benchmark", "models.denseunet", "models.resunet",
                "models.deeplab3", "models.pspnet"):
        assert f"cutmix_seg_tpu_torch.{mod}" in names, mod
    for name in names:
        importlib.import_module(name)


def test_entry_points_need_a_gpu_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    model = SegModel("tiny", DeepLab2(3, layers=(1, 1, 1, 1)), np.zeros(3), np.ones(3),
                     (1, 1), _param_label)
    with pytest.raises(RuntimeError):
        create_train_state(model, OptimizerConfig(), 0, pretrained=False)
    state, _ = create_train_state(model, OptimizerConfig(), 0, device="cpu",
                                  pretrained=False)
    assert next(state.student.parameters()).device.type == "cpu"


def test_kernel_sources_and_flags():
    assert build.sources() == ["cutmix_blend"]
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    # the build directory is ignored by git
    assert "build/kernels/" in (ROOT / ".gitignore").read_text().split()


def _run_chip_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_gpu():
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
