"""Serving export (port of cutmix_seg_tpu.serve.export): a self-contained
inference artifact for deployment.

The artifact is a ``torch.export`` ExportedProgram of the whole serving
path, ``uint8 NHWC image -> prediction``: the uint8 -> float conversion, the
mean/std normalisation, the eval net's forward (running-average BN, no
dropout) and, optionally, the argmax, with the weights inside. The batch
dimension is symbolic (one artifact serves any batch size); H and W are
static, one artifact per served resolution. Loading needs torch alone, none
of this package's code: ``torch.export.load(path).module()``.

The program runs on the device it was exported on (``platforms`` in the
metadata): an input on another device raises, it is never moved.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from cutmix_seg_tpu_torch.utils.device import resolve_device

__all__ = [
    "ServingModule",
    "make_serving_fn",
    "export_serving_artifact",
    "load_serving_artifact",
]

_META_SUFFIX = ".json"
# an example batch of 1 would specialise the batch dimension to 1
_EXAMPLE_BATCH = 2


class ServingModule(nn.Module):
    """``forward(x uint8 NHWC) -> (N, H, W) int32`` labels, or the NHWC
    logits in the net's compute dtype with ``output='logits'``. Mean and
    std are buffers; the net runs in eval mode."""

    def __init__(self, net: nn.Module, mean, std, output: str = "argmax"):
        super().__init__()
        if output not in ("argmax", "logits"):
            raise ValueError(f"output must be 'argmax' or 'logits', got {output!r}")
        self.net = net
        self.output = output
        self.register_buffer("mean", torch.as_tensor(np.asarray(mean), dtype=torch.float32))
        self.register_buffer("std", torch.as_tensor(np.asarray(std), dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():  # traced too: the artifact's outputs carry no autograd graph
            x = (x.to(torch.float32) / 255.0 - self.mean) / self.std
            logits = self.net(x)
            if self.output == "argmax":
                return logits.argmax(dim=-1).to(torch.int32)
            return logits


def _check_servable(model, input_hw: Tuple[int, int]) -> None:
    bh, bw = model.block_size
    if input_hw[0] % bh or input_hw[1] % bw:
        raise ValueError(
            f"{model.name} takes H, W in multiples of {model.block_size}; got {tuple(input_hw)} "
            "(export at a block-aligned size; inputs are not padded)")
    if any(m.__dict__.get("spatial") is not None for m in model.module.modules()):
        raise ValueError("the net splits its rows over ranks (set_spatial); serving is one "
                         "process: set_spatial(net, None) first")


def make_serving_fn(model, output: str = "argmax") -> ServingModule:
    """The serving module of ``model.module`` (the weights it holds), in
    eval mode, normalised with the model's mean/std, on the module's
    device. Serving inputs are whole images, not padded training canvases."""
    if model.mean is None or model.std is None:
        raise ValueError(f"{model.name} has no normalisation statistics of its own "
                         "(its recipes take the dataset's); serve the _imagenet variant")
    device = next(model.module.parameters()).device
    return ServingModule(model.module, model.mean, model.std, output).to(device).eval()


def export_serving_artifact(model, input_hw: Tuple[int, int], path: str, *,
                            output: str = "argmax", device=None,
                            num_classes: Optional[int] = None) -> str:
    """Export the serving function of ``model.module`` (moved to ``device``:
    CUDA unless asked otherwise) to ``path`` with ``torch.export.save``,
    written through ``path.tmp``, and its metadata to ``path.json``. The
    batch dimension is symbolic; H, W are static."""
    dev = resolve_device(device)
    input_hw = tuple(int(v) for v in input_hw)
    _check_servable(model, input_hw)
    model.module.to(dev)
    serve = make_serving_fn(model, output)
    x = torch.randint(0, 256, (_EXAMPLE_BATCH,) + input_hw + (3,), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0)).to(dev)
    program = torch.export.export(
        serve, (x,), dynamic_shapes=({0: torch.export.Dim("b", min=1)},))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.export.save(program, f)
    os.replace(tmp, path)

    meta = {
        "model": model.name,
        "input_hw": list(input_hw),
        "input_dtype": "uint8",
        "output": output,
        "num_classes": num_classes,
        "platforms": [dev.type],
        "mean": np.asarray(model.mean, np.float64).tolist(),
        "std": np.asarray(model.std, np.float64).tolist(),
        "format": "torch.export ExportedProgram",
        "bytes": os.path.getsize(path),
    }
    with open(path + _META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=1)
    return path


def load_serving_artifact(path: str):
    """Load an exported artifact: ``(call, meta)``, where ``call(x_uint8)``
    runs the program on the device it was exported on (``meta`` is None
    without the ``.json``). Needs torch alone."""
    call = torch.export.load(path).module()
    meta = None
    if os.path.exists(path + _META_SUFFIX):
        with open(path + _META_SUFFIX) as f:
            meta = json.load(f)
    return call, meta
