"""The tiny cut of the ``deeplab2`` family: DeepLab v2 at one block per
stage, 33^2 crops, six written images."""

import numpy as np

ARCH = "bench_tiny_deeplab2"
FLAGS = {"crop_size": "33,33"}

# the tiny cells' limits, above their sound runs' readings on the CPU
# (bf16 program against the float32 reference; seeds 11, 2147483901 and
# 987654321: sup 0.0022-0.011, cons 0.04-0.19, grad 0.006-0.025, change
# 0.0016-0.0037; the teacher's change as the student's) and below what the
# faults read there (a teacher left unchanged reads 1)
LIMITS = {"sup_loss_gap": 0.03, "cons_loss_gap": 0.5, "grad_gap": 0.08,
          "change_gap": 0.006, "teacher_change_gap": 0.1}

# what the card's control test compares at the tiny sizes, where the CPU's
# limits do not hold: bf16 convolutions round otherwise on the card and its
# reference is not bit-reproducible (4 seeds on the card: sound runs read
# grad_diff_median_gap 0.024-0.039, the control 0.10-0.25)
CARD_LIMITS = {"grad_diff_median_gap": 0.06}

# Loader order, crops, decode, warp, colour, boxes, blend, gate, losses,
# the first gradient element by element, Adam and EMA agree to float32
# rounding: every reading of the float32 program lies under this.
F32_TOLERANCE = 1e-4


def f32_patches(patcher) -> None:
    """Nothing to patch: the scale-crop's taps are bilinear."""


def cut(cfg: dict) -> None:
    cfg["model"]["layers"] = [1, 1, 1, 1]
    cfg["data"].update(written=6, val=2, size_range=[40, 60])
    # the tiny net's logits are smaller: open the teacher's gate
    cfg["init"]["classifier_gain"] = 8.0


def register() -> None:
    from cutmix_seg_tpu_torch.models import common, deeplab2, registry

    def tiny_deeplab2(num_classes, dtype=None, pretrained=True):
        module = deeplab2.DeepLab2(num_classes, layers=(1, 1, 1, 1), dtype=dtype)
        return common.SegModel(name=ARCH, module=module, mean=np.asarray(common.IMAGENET_MEAN),
                               std=np.asarray(common.IMAGENET_STD), block_size=(1, 1),
                               param_label=deeplab2._param_label)

    registry.register(ARCH)(tiny_deeplab2)
