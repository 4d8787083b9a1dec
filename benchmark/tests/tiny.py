"""Tiny cells for the CPU tests: the benchmark's two configurations at one
block per stage and small crops, registered in the port's architecture
registry under names of their own, on small written data."""

from __future__ import annotations

import copy

import numpy as np

from benchmark import recipe

TINY_ARCHS = {"deeplab2": "bench_tiny_deeplab2", "denseunet": "bench_tiny_denseunet"}
# the tiny cells' limits, above their sound runs' readings on the CPU
# (bf16 program against the float32 reference; seeds 11, 2147483901 and
# 987654321: DeepLab sup 0.0022-0.011, cons 0.04-0.19, grad 0.006-0.025,
# change 0.0016-0.0037; DenseUNet, whose batch of 2 at 64^2 makes training
# BN noisy, sup 0.0018-0.022, cons 0.0027-0.0097, grad 0.06-0.12, change
# 0.06-0.12; the teacher's change as the student's) and below what the
# faults read there (a teacher left unchanged reads 1)
TINY_LIMITS = {
    "deeplab2": {"sup_loss_gap": 0.03, "cons_loss_gap": 0.5, "grad_gap": 0.08,
                 "change_gap": 0.006, "teacher_change_gap": 0.1},
    "denseunet": {"sup_loss_gap": 0.035, "cons_loss_gap": 0.015, "grad_gap": 0.3,
                  "change_gap": 0.3, "teacher_change_gap": 0.5},
}

# what the card's control test compares at the tiny sizes, where the
# CPU's limits do not hold: bf16 convolutions round otherwise on the card
# and its reference is not bit-reproducible (4 seeds on the card: DenseUNet
# sound runs read sup_loss_gap_step1 0.0020-0.0042, the control
# 0.0104-0.0332; DeepLab sound runs grad_diff_median_gap 0.024-0.039, the
# control 0.10-0.25)
TINY_CARD_LIMITS = {
    "deeplab2": {"grad_diff_median_gap": 0.06},
    "denseunet": {"sup_loss_gap_step1": 0.007},
}


def register_tiny_archs() -> None:
    from cutmix_seg_tpu_torch.models import common, deeplab2, denseunet, registry

    def tiny_deeplab2(num_classes, dtype=None, pretrained=True):
        module = deeplab2.DeepLab2(num_classes, layers=(1, 1, 1, 1), dtype=dtype)
        return common.SegModel(name=TINY_ARCHS["deeplab2"], module=module,
                               mean=np.asarray(common.IMAGENET_MEAN),
                               std=np.asarray(common.IMAGENET_STD), block_size=(1, 1),
                               param_label=deeplab2._param_label)

    def tiny_denseunet(num_classes, dtype=None, pretrained=True):
        module = denseunet.DenseUNet(num_classes, block_config=(1, 1, 1, 1), dtype=dtype)
        return common.SegModel(name=TINY_ARCHS["denseunet"], module=module,
                               mean=np.asarray(common.IMAGENET_MEAN),
                               std=np.asarray(common.IMAGENET_STD), block_size=(32, 32),
                               param_label=denseunet._param_label_pretrained)

    registry.register(TINY_ARCHS["deeplab2"])(tiny_deeplab2)
    registry.register(TINY_ARCHS["denseunet"])(tiny_denseunet)


def _set_flag(flags, key, value):
    out = [f for f in flags if not f.startswith(f"--{key}=")]
    return out + [f"--{key}={value}"]


def tiny_cell(name: str) -> dict:
    """The named cell of BENCHMARK.json cut to a CPU test's size."""
    cell = copy.deepcopy(recipe.load_cell(name))
    cfg = cell["config"]
    fam = cfg["model"]["family"]
    flags = _set_flag(cfg["flags"], "arch", TINY_ARCHS[fam])
    flags = _set_flag(flags, "batch_size", 2)
    if fam == "deeplab2":
        cfg["model"]["layers"] = [1, 1, 1, 1]
        flags = _set_flag(flags, "crop_size", "33,33")
        cfg["data"].update(written=6, val=2, size_range=[40, 60])
        # the tiny net's logits are smaller: open the teacher's gate
        cfg["init"]["classifier_gain"] = 8.0
    else:
        cfg["model"]["block_config"] = [1, 1, 1, 1]
        flags = _set_flag(flags, "crop_size", "64,64")
        flags = _set_flag(flags, "n_sup", 4)
        cfg["data"].update(train=8, val=2, size=72)
    cfg["flags"] = flags
    cell["workload"].update(warmup_iterations=1, trace_seconds=1)
    cell["workload"]["limits"] = dict(TINY_LIMITS[fam])
    return cell
