"""Architecture registry: name -> SegModel factory (port of
cutmix_seg_tpu.models.registry), so ``--arch`` values carry over unchanged:
the JAX package's 11 names.
"""

from __future__ import annotations

from typing import Callable, Dict

from cutmix_seg_tpu_torch.models import deeplab2, deeplab3, denseunet, pspnet, resunet

_ARCHS: Dict[str, Callable] = {
    "resnet101_deeplab_imagenet": deeplab2.resnet101_deeplab_imagenet,
    "resnet101_deeplab_imagenet_mittal_std": deeplab2.resnet101_deeplab_imagenet_mittal_std,
    "resnet101_deeplab_coco": deeplab2.resnet101_deeplab_coco,
    "resnet50unet_imagenet": resunet.resnet50unet_imagenet,
    "resnet101unet_imagenet": resunet.resnet101unet_imagenet,
    "densenet161unet": denseunet.densenet161unet,
    "densenet161unet_imagenet": denseunet.densenet161unet_imagenet,
    "resnet101_deeplabv3_imagenet": deeplab3.resnet101_deeplabv3_imagenet,
    "resnet101_deeplabv3_coco": deeplab3.resnet101_deeplabv3_coco,
    "resnet101_deeplabv3plus_imagenet": deeplab3.resnet101_deeplabv3plus_imagenet,
    "resnet101_pspnet_imagenet": pspnet.resnet101_pspnet_imagenet,
}


def register(name: str):
    def deco(fn):
        _ARCHS[name] = fn
        return fn

    return deco


def get(name: str) -> Callable:
    if name not in _ARCHS:
        raise KeyError(f"unknown architecture {name!r}; available: {sorted(_ARCHS)}")
    return _ARCHS[name]


def names():
    return sorted(_ARCHS)
