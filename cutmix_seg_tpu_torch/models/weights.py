"""Weights bridge (counterpart of cutmix_seg_tpu.models.torch_import).

* ``from_jax_variables``: the JAX package's ``{"params", "batch_stats"}``
  tree (numpy leaves) -> this port's ``state_dict``: flax HWIO kernels ->
  OIHW, ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``.
  DeepLab v2 (``layout='deeplab2'``) takes the Hung flat layout, the inverse
  of the JAX importer's ``map_torch_resnet`` and
  ``map_hung_deeplab_classifier``; every other family (``layout='tree'``)
  keeps the JAX module tree, with torchvision's ``layerN.B`` and
  ``downsample.0/1`` inside a ResNet backbone. The toy-2D MLP
  (``layout='toy2d'``) maps Dense kernels (in, out) to ``weight`` (out, in),
  flax's WeightNorm ``scale`` and SpectralNorm ``u`` / ``sigma`` (stored by
  the wrapper as ``'dense0/kernel/scale'``) to ``dense0.scale`` / ``.u`` /
  ``.sigma``.
* Local-file loaders: ``load_resnet_deeplab2``, ``load_resnet_backbone`` and
  ``load_densenet_features`` fill a module from a torchvision or Hung et al.
  ``.pth`` in ``$CUTMIX_SEG_WEIGHTS``, copying a tensor only where the name
  maps and the shape matches (so the COCO 21-class head is skipped for
  other class counts). No file is fetched.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}
_MODULE = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}

_BN = r"(weight|bias|running_mean|running_var)"
BACKBONE_KEY = re.compile(
    rf"(conv1\.weight|bn1\.{_BN}|layer\d+\.\d+\.(conv\d+\.weight|bn\d+\.{_BN}"
    rf"|downsample\.0\.weight|downsample\.1\.{_BN}))$")
HEAD_KEY = re.compile(r"layer5\.conv2d_list\.\d+\.(weight|bias)$")
DENSENET_KEY = re.compile(
    rf"features\.(conv0\.weight|norm0\.{_BN}|denseblock\d+\.denselayer\d+\."
    rf"(conv[12]\.weight|norm[12]\.{_BN})|transition\d+\.(conv\.weight|norm\.{_BN})"
    rf"|norm5\.{_BN})$")


def torch_key(path: Tuple[str, ...], layout: str = "deeplab2") -> str:
    """JAX leaf path (below 'params'/'batch_stats') -> state_dict key, e.g.
    ('backbone', 'layer1_0', 'downsample_bn', 'scale') ->
    'layer1.0.downsample.1.weight' (deeplab2) or
    'backbone.layer1.0.downsample.1.weight' (tree)."""
    if layout == "toy2d":
        if "/" in path[-1]:  # ('WeightNorm_0', 'dense0/kernel/scale')
            layer, _, leaf = path[-1].split("/")
            return f"{layer}.{leaf}"
        module, leaf = path
        return f"{module}.{_LEAF[leaf]}"
    root, *mods, leaf = path
    if layout == "deeplab2":
        if root == "classifier":  # ('classifier', 'aspp<i>', 'kernel'|'bias')
            return f"layer5.conv2d_list.{int(mods[0][4:])}.{_LEAF[leaf]}"
        if root != "backbone":
            raise KeyError(f"not a DeepLab2 leaf: {path}")
    elif layout == "tree":
        mods = [root] + mods
    else:
        raise ValueError(f"unknown layout {layout!r}")
    parts = []
    for m in mods:
        block = re.fullmatch(r"layer(\d+)_(\d+)", m)
        parts += [f"layer{block[1]}", block[2]] if block else [_MODULE.get(m, m)]
    return ".".join(parts + [_LEAF[leaf]])


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(variables: Mapping, layout: str = "deeplab2") -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of numpy arrays -> state_dict."""
    sd = {}
    for coll in ("params", "batch_stats"):
        for path, val in _flatten(variables.get(coll, {})):
            val = np.asarray(val, dtype=np.float32)
            if path[-1] == "kernel":  # HWIO -> OIHW, or (in, out) -> (out, in)
                val = np.transpose(val, (3, 2, 0, 1) if val.ndim == 4 else (1, 0))
            sd[torch_key(path, layout)] = torch.from_numpy(np.array(val, order="C"))
    return sd


def weights_dir() -> str:
    return os.environ.get(
        "CUTMIX_SEG_WEIGHTS",
        os.path.join(os.path.expanduser("~"), ".cache", "cutmix_seg_tpu"))


def load_torch_state_dict(name: str) -> Dict[str, torch.Tensor]:
    """A local torch state_dict file ``<weights_dir>/<name>.pth``."""
    path = os.path.join(weights_dir(), name + ".pth")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained weights not found: {path}. Place the torch state_dict "
            "there or set CUTMIX_SEG_WEIGHTS.")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def merge_state_dict(module: nn.Module, sd: Mapping[str, torch.Tensor],
                     key_pattern: re.Pattern, verbose: bool = False, prefix: str = ""):
    """Copy the entries of ``sd`` whose key matches ``key_pattern`` into
    ``module`` (under ``prefix`` + key) where the name exists and the shape
    matches; others are skipped. Keys the pattern rejects (``fc.*``,
    ``num_batches_tracked``) are neither. Returns (n_loaded, n_skipped)."""
    own = module.state_dict()
    loaded = skipped = 0
    with torch.no_grad():
        for key, val in sd.items():
            if not key_pattern.match(key):
                continue
            dst = own.get(prefix + key)
            if dst is not None and tuple(dst.shape) == tuple(val.shape):
                dst.copy_(val)
                loaded += 1
            else:
                skipped += 1
                if verbose:
                    print(f"  shape/name mismatch at {prefix + key}")
    return loaded, skipped


def load_resnet_deeplab2(module: nn.Module, source: str, verbose: bool = False):
    """Fill a DeepLab2 module from a torch checkpoint: 'resnet101_imagenet'
    (backbone only) or 'resnet101_deeplab_coco' (backbone + ASPP head where
    shapes match)."""
    sd = load_torch_state_dict(source)
    n, s = merge_state_dict(module, sd, BACKBONE_KEY, verbose)
    if source == "resnet101_deeplab_coco":
        n2, s2 = merge_state_dict(module, sd, HEAD_KEY, verbose)
        n, s = n + n2, s + s2
    if verbose:
        print(f"loaded {n} tensors, skipped {s}")
    return n, s


def load_resnet_backbone(module: nn.Module, source: str, backbone_name: str = "backbone",
                         verbose: bool = False):
    """Fill the ResNet submodule ``backbone_name`` from a torchvision-format
    ResNet state dict (top-level ``conv1``, ``layerN`` keys)."""
    n, s = merge_state_dict(module, load_torch_state_dict(source), BACKBONE_KEY, verbose,
                            prefix=backbone_name + ".")
    if verbose:
        print(f"loaded {n} tensors, skipped {s}")
    return n, s


def load_densenet_features(module: nn.Module, source: str, verbose: bool = False):
    """Fill the ``features`` submodule from a torchvision densenet state dict
    (its ``features.*`` keys; ``classifier.*`` is dropped)."""
    n, s = merge_state_dict(module, load_torch_state_dict(source), DENSENET_KEY, verbose)
    if verbose:
        print(f"loaded {n} tensors, skipped {s}")
    return n, s
