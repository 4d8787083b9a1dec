"""The tiny cut of the ``denseunet`` family: DenseUNet at one layer per
dense block, 64^2 crops, eight train images of 72^2."""

import numpy as np

ARCH = "bench_tiny_denseunet"
FLAGS = {"crop_size": "64,64", "n_sup": 4}

# the tiny cells' limits, above their sound runs' readings on the CPU
# (bf16 program against the float32 reference; seeds 11, 2147483901 and
# 987654321; the batch of 2 at 64^2 makes training BN noisy: sup
# 0.0018-0.022, cons 0.0027-0.0097, grad 0.06-0.12, change 0.06-0.12; the
# teacher's change as the student's) and below what the faults read there
# (a teacher left unchanged reads 1)
LIMITS = {"sup_loss_gap": 0.035, "cons_loss_gap": 0.015, "grad_gap": 0.3,
          "change_gap": 0.3, "teacher_change_gap": 0.5}

# what the card's control test compares at the tiny sizes, where the CPU's
# limits do not hold: bf16 convolutions round otherwise on the card and its
# reference is not bit-reproducible (4 seeds on the card: sound runs read
# sup_loss_gap_step1 0.0020-0.0042, the control 0.0104-0.0332)
CARD_LIMITS = {"sup_loss_gap_step1": 0.007}

# With the reference's nearest taps rounded as the program's, the DenseUNet
# step (training BN, dropout, the decoder, SGD with weight decay and the
# poly rate, the EMA teacher) agrees to float32 rounding through a
# training-BN net: the reference in float32 reads up to 1.2e-3 against
# itself in float64 here (the worst leaf's teacher change), the program
# 1.3e-3 (the worst leaf's change); nearest taps left unmatched read
# 0.10-0.17, half a batch 0.2-1.6.
F32_TOLERANCE = 3e-3


def f32_patches(patcher) -> None:
    """The reference's nearest taps rounded as the program's
    (``faults.tie_matched_reference``)."""
    from benchmark import faults

    faults.tie_matched_reference(patcher)


def cut(cfg: dict) -> None:
    cfg["model"]["block_config"] = [1, 1, 1, 1]
    cfg["data"].update(train=8, val=2, size=72)


def register() -> None:
    from cutmix_seg_tpu_torch.models import common, denseunet, registry

    def tiny_denseunet(num_classes, dtype=None, pretrained=True):
        module = denseunet.DenseUNet(num_classes, block_config=(1, 1, 1, 1), dtype=dtype)
        return common.SegModel(name=ARCH, module=module, mean=np.asarray(common.IMAGENET_MEAN),
                               std=np.asarray(common.IMAGENET_STD), block_size=(32, 32),
                               param_label=denseunet._param_label_pretrained)

    registry.register(ARCH)(tiny_denseunet)
