"""cutmix_seg_tpu_torch — the CutMix mean-teacher system in PyTorch for one
NVIDIA H100.

A port of ``cutmix_seg_tpu`` (JAX/Flax/Pallas), which stays in the repository
as the reference. Module paths mirror the JAX package so each counterpart is
easy to find. Public functions keep the JAX package's NHWC layout (batch
dicts, logits, masks); inside the models an NHWC tensor is permuted to a
channels_last NCHW view, which cuDNN takes without a copy.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a GPU and without that argument they raise:
  * the trainer, ``python -m cutmix_seg_tpu_torch.train.mask_mt`` (the JAX
    CLI's flags; ``train.mask_mt.train_seg_semisup_mask_mt``);
  * the step alone, ``core.train_state.create_train_state`` and
    ``semisup.mask_mt.make_mask_mt_step``.

The one hand-written kernel is the fused box-mask rasterise + CutMix blend
(``csrc/cutmix_blend.cu``, wrapped by ``ops.cutmix.cutmix_blend``). It is
built with ``nvcc`` at first use (``ops.build``). A CPU tensor takes the
kernel's plain PyTorch version; a CUDA tensor launches the kernel or raises.

Layout:
  aug/       geometry samplers (host, copies) and the warp + colour + normalise
             augmentation (device)
  core/      train state, two-group optimiser, schedules, checkpoints, run dirs
  csrc/      CUDA C++ kernel sources (sm_90a)
  data/      dataset sources, splits, the threaded host loader (copies), a
             synthetic VOC tree
  eval/      normalise + forward + argmax + confusion matrix
  masks/     box mask (CutMix/Cutout) rect sampling + rasterisation
  models/    DeepLab v2 (dilated ResNet-101 + summed ASPP), weights bridge,
             registry
  ops/       kernel build/load, the CutMix kernel wrapper, colour jitter, IoU
  semisup/   losses, EMA teacher, shared step pieces, the mask_mt step
  train/     the CLI options, the training engine, the mask_mt trainer
  utils/     device resolution, consistency ramp-up
"""
