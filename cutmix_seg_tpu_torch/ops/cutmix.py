"""Fused box-mask rasterisation + CutMix blend: the wrapper of the CUDA kernel
``csrc/cutmix_blend.cu`` (port of cutmix_seg_tpu/ops/pallas_cutmix.py).

``cutmix_blend`` dispatches on the tensors' device: CPU tensors take
``cutmix_blend_plain`` (``rasterise_masks`` + the blend, the kernel's
reference semantics), CUDA tensors launch the kernel or raise. There is no
fallback from a failed build or launch. The kernel streams the batch as one
flat run, so it takes any batch size up to 2^31 - 1 elements per tensor;
inputs whose addresses are not 16-byte aligned take its one-element variant,
chosen inside the launch.

The kernel needs no backward: it blends input images (no gradient) and
produces the mask, and the teacher-logit blend that reuses the mask is
outside the gradient.
"""

from __future__ import annotations

import ctypes

import torch

from cutmix_seg_tpu_torch.masks.box_mask import rasterise_masks
from cutmix_seg_tpu_torch.ops import build

KERNEL = "cutmix_blend"
_ENTRY = {torch.float32: "cutmix_blend_f32", torch.bfloat16: "cutmix_blend_bf16"}
_MAX_ELEMS = 2 ** 31 - 1  # the kernel indexes in 32 bits


def cutmix_blend_plain(x0: torch.Tensor, x1: torch.Tensor, rects: torch.Tensor,
                       invert: bool = True):
    """Plain PyTorch version of the kernel: (x_mix, mask (N, H, W, 1))."""
    m = rasterise_masks(rects, tuple(x0.shape[1:3]), invert=invert, dtype=x0.dtype)
    return x0 * (1.0 - m) + x1 * m, m


def _check(x0: torch.Tensor, x1: torch.Tensor, rects: torch.Tensor) -> None:
    if x0.dim() != 4 or x1.shape != x0.shape:
        raise ValueError(f"x0, x1 must be equal (N, H, W, C), got "
                         f"{tuple(x0.shape)} and {tuple(x1.shape)}")
    n = x0.shape[0]
    if rects.dim() != 3 or rects.shape[0] != n or rects.shape[2] != 4 \
            or rects.shape[1] < 1:
        raise ValueError(f"rects must be (N={n}, B>=1, 4), got {tuple(rects.shape)}")
    if x0.dtype not in _ENTRY or x1.dtype != x0.dtype:
        raise TypeError(f"x0, x1 must both be float32 or bfloat16, got "
                        f"{x0.dtype} and {x1.dtype}")
    if rects.dtype != torch.float32:
        raise TypeError(f"rects must be float32, got {rects.dtype}")
    if not (x0.device == x1.device == rects.device):
        raise ValueError("x0, x1 and rects must be on one device")
    if not (x0.is_contiguous() and x1.is_contiguous() and rects.is_contiguous()):
        raise ValueError("x0, x1 and rects must be contiguous (NHWC)")
    if x0.requires_grad or x1.requires_grad or rects.requires_grad:
        raise ValueError("cutmix_blend has no backward; pass tensors that "
                         "do not require grad")
    if n < 1 or x0.numel() == 0:
        raise ValueError("batch must hold at least one non-empty image")
    if x0.numel() > _MAX_ELEMS:
        raise ValueError(f"cutmix_blend takes at most {_MAX_ELEMS} elements per "
                         f"tensor, got {x0.numel()}")


def _kernel_fn(dtype: torch.dtype):
    lib = build.load(KERNEL)
    fn = getattr(lib, _ENTRY[dtype])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        # every pointer and the stream as c_void_p: ctypes would pass a bare
        # Python int as a 32-bit int and cut the address
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    return fn


def cutmix_blend(x0: torch.Tensor, x1: torch.Tensor, rects: torch.Tensor,
                 invert: bool = True):
    """Fused mask rasterisation + blend.

    :param x0, x1: (N, H, W, C) float32 or bfloat16, contiguous
    :param rects: (N, n_boxes, 4) float32 box params (y0, x0, y1, x1)
    :param invert: boxes -> 1 on a 0 base (else boxes -> 0 on a 1 base)
    :return: (x_mix (N, H, W, C), mask (N, H, W, 1)), both in x0's dtype
    """
    _check(x0, x1, rects)
    if x0.device.type == "cpu":
        return cutmix_blend_plain(x0, x1, rects, invert)
    if x0.device.type != "cuda":
        raise ValueError(f"cutmix_blend runs on cpu or cuda, not {x0.device}")
    n, h, w, c = x0.shape
    out = torch.empty_like(x0)
    mask = torch.empty((n, h, w, 1), dtype=x0.dtype, device=x0.device)
    fn = _kernel_fn(x0.dtype)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x0.data_ptr(), x1.data_ptr(), rects.data_ptr(), out.data_ptr(),
                 mask.data_ptr(), n, h, w, c, rects.shape[1], int(invert), stream)
    if err != 0:
        raise RuntimeError(f"cutmix_blend kernel launch failed: CUDA error {err}")
    build.launch_counts[KERNEL] += 1
    return out, mask
