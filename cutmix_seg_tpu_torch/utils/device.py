"""Device resolution for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the GPU: ``cuda:LOCAL_RANK`` in a process that torchrun
    started, else ``cuda``. A CUDA device on a host without one raises: the
    entry points never carry on silently on the CPU. Pass ``"cpu"`` to run
    the plain PyTorch versions (as the tests do)."""
    if device is None:
        device = f"cuda:{os.environ['LOCAL_RANK']}" if "LOCAL_RANK" in os.environ else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
