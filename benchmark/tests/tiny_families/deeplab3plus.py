"""The tiny cut of the ``deeplab3plus`` family: DeepLab v3+ at one block per
stage and its full widths, 49^2 crops, six written images."""

import numpy as np

ARCH = "bench_tiny_deeplab3plus"
FLAGS = {"crop_size": "49,49"}

# the tiny cells' limits, above their sound runs' readings on the CPU
# (bf16 program against the float32 reference; seeds 11, 2147483901 and
# 987654321: sup 0.0009-0.0048, cons 0.0098-0.021, cons ungated
# 0.0016-0.0030, grad 0.015-0.042, change 0.0094-0.0125, teacher change
# 0.012-0.018, grad_diff_median 0.031-0.036) and below what the faults and
# the control read there (seed 987654321): a state left unchanged reads 1
# on change_gap, a teacher left unchanged 1 on teacher_change_gap, half the
# batch 0.117 on sup_loss_gap, the unmixed blend 0.087 on cons_ungated_gap,
# the control 0.145 on cons_loss_gap (0.127 at seed 2147483901) and 0.158
# on grad_diff_median_gap
LIMITS = {"sup_loss_gap": 0.03, "cons_loss_gap": 0.05, "cons_ungated_gap": 0.02,
          "grad_gap": 0.1, "change_gap": 0.03, "teacher_change_gap": 0.05,
          "grad_diff_median_gap": 0.08}

# what the card's control test compares at the tiny sizes, where the CPU's
# limits do not hold: bf16 convolutions round otherwise on the card and its
# reference is not bit-reproducible (4 seeds on the card: sound runs read
# grad_diff_median_gap 0.021-0.030, the control 0.107-0.152)
CARD_LIMITS = {"grad_diff_median_gap": 0.06}

# With the reference's nearest taps rounded as the program's, the v3+ step
# (frozen BN statistics with trained affines, dropout from the step's
# generator, Adam and the EMA teacher) agrees to float32 rounding: up to
# 7.7e-4 on seeds 11, 2147483901 and 987654321 (the teacher change of a BN
# weight near 1, where the EMA's rounding is of the size of three steps'
# change; the float32 reference reads 0.36 there against itself in
# float64); nearest taps left unmatched read 3.4e-3 (a label pixel of the
# third step).
F32_TOLERANCE = 3e-3


def f32_patches(patcher) -> None:
    """The reference's nearest taps rounded as the program's
    (``faults.tie_matched_reference``)."""
    from benchmark import faults

    faults.tie_matched_reference(patcher)


def cut(cfg: dict) -> None:
    cfg["model"]["layers"] = [1, 1, 1, 1]
    cfg["data"].update(written=6, val=2, size_range=[40, 60])
    # the tiny net's logits are smaller: open the teacher's gate
    cfg["init"]["classifier_gain"] = 8.0


def register() -> None:
    from cutmix_seg_tpu_torch.models import common, deeplab3, registry

    def tiny_deeplab3plus(num_classes, dtype=None, pretrained=True):
        module = deeplab3.DeepLabV3Plus(num_classes, layers=(1, 1, 1, 1), dtype=dtype)
        return common.SegModel(name=ARCH, module=module, mean=np.asarray(common.IMAGENET_MEAN),
                               std=np.asarray(common.IMAGENET_STD), block_size=(1, 1),
                               param_label=deeplab3._label_imagenet)

    registry.register(ARCH)(tiny_deeplab3plus)
