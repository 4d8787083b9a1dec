"""Architecture registry: name -> SegModel factory (port of
cutmix_seg_tpu.models.registry), so ``--arch`` values carry over unchanged.

The port has the three DeepLab v2 names so far. The JAX package's other
names raise with the list of names still to port.
"""

from __future__ import annotations

from typing import Callable, Dict

from cutmix_seg_tpu_torch.models import deeplab2

_ARCHS: Dict[str, Callable] = {
    "resnet101_deeplab_imagenet": deeplab2.resnet101_deeplab_imagenet,
    "resnet101_deeplab_imagenet_mittal_std": deeplab2.resnet101_deeplab_imagenet_mittal_std,
    "resnet101_deeplab_coco": deeplab2.resnet101_deeplab_coco,
}

# the JAX package's other architectures (ROADMAP A5)
NOT_PORTED = (
    "densenet161unet", "densenet161unet_imagenet", "resnet101_deeplabv3_coco",
    "resnet101_deeplabv3_imagenet", "resnet101_deeplabv3plus_imagenet",
    "resnet101_pspnet_imagenet", "resnet101unet_imagenet", "resnet50unet_imagenet",
)


def register(name: str):
    def deco(fn):
        _ARCHS[name] = fn
        return fn

    return deco


def get(name: str) -> Callable:
    if name not in _ARCHS:
        raise KeyError(
            f"architecture {name!r} is not in the port: it has {sorted(_ARCHS)}; "
            f"still to port (ROADMAP A5): {list(NOT_PORTED)}")
    return _ARCHS[name]


def names():
    return sorted(_ARCHS)
