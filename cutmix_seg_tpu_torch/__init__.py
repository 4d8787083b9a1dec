"""cutmix_seg_tpu_torch — the CutMix mean-teacher system in PyTorch for one
NVIDIA H100.

A port of ``cutmix_seg_tpu`` (JAX/Flax/Pallas), which stays in the repository
as the reference. Module paths mirror the JAX package so each counterpart is
easy to find. Public functions keep the JAX package's NHWC layout (batch
dicts, logits, masks); inside the models an NHWC tensor is permuted to a
channels_last NCHW view, which cuDNN takes without a copy.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a GPU and without that argument they raise:
  * the trainers, ``python -m cutmix_seg_tpu_torch.train.<algorithm>`` for
    mask_mt (CutMix / Cutout), ict, vat_mt and aug_mt (the JAX CLIs' flags;
    ``train.<algorithm>.train_seg_semisup_<algorithm>``);
  * the steps alone, ``core.train_state.create_train_state`` and
    ``semisup.{mask_mt,ict,vat,aug_cons}.make_*_step``;
  * ``python -m cutmix_seg_tpu_torch.tools.synthetic_benchmark`` (``--device
    cpu`` for the CPU);
  * serving: ``tools.export_model`` (a ``torch.export`` artifact of the eval
    net, ``serve.export``), ``serve.http`` (its HTTP host),
    ``tools.serve_bench``, and ``tools.evaluate_model`` (a model.pt or a
    checkpoint on a val or test split);
  * ``python -m cutmix_seg_tpu_torch.toy2d.train``, the toy-2D trainer.

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
  ops/       kernel build/load, the CutMix kernel wrapper, colour jitter, IoU,
             affine grid sampling (aug_mt's warps)
  semisup/   losses, EMA teacher, shared step pieces, the mask_mt, ICT, VAT and
             aug_mt steps
  serve/     the serving export and its HTTP host
  tools/     the synthetic convergence benchmark, the data converters,
             export_model, evaluate_model, serve_bench
  toy2d/     the toy-2D datasets (a copy), MLP and trainer
  train/     the CLI options, the training engine, the four trainers
  utils/     device resolution, consistency ramp-up, profiling
"""
