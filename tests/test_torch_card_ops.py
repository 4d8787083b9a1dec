"""The port's device operations on the card against their plain version or
the CPU (``-m cuda``; without a GPU every test skips).

The CutMix kernel (``csrc/cutmix_blend.cu``) against its plain PyTorch
version on the card, masks and blends bit-equal in float32 and bf16, one
launch a call: at the main path's 10x321x321x3, the ISIC path's
10x224x224x3, the Cityscapes path's 4x256x512x3, the convergence sweep's
8x64x64x3, and the edge cases (two boxes, odd height without inversion,
boxes outside the bounds, inputs one element past a 16-byte boundary, a
ragged end with vectors across samples, 21 channels, 70,000 images).

Augmentation and eval, card against CPU: host batches of a synthetic VOC
tree from the port's loader (10 images, 321x321 crops) through
``augment_batch`` on the gather path (crop_rotate_scale, reflect101) and
the separable path (crop_scale_hung), with labels and with the same
injected colour draws on both devices, TF32 allowed for matrix products
(the separable warp must not take it): labels bit-equal, images and valid
masks within float32 rounding; ``confusion_matrix`` at 10x512x512
bit-equal. Imports no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from cutmix_seg_tpu_torch.aug.device import augment_batch, border_for_mode
from cutmix_seg_tpu_torch.aug.params import GeomConfig
from cutmix_seg_tpu_torch.data.loader import HostBatchBuilder, train_stream
from cutmix_seg_tpu_torch.data.sources import PascalVOCDataSource
from cutmix_seg_tpu_torch.data.synthetic import write_voc_tree
from cutmix_seg_tpu_torch.models.common import IMAGENET_MEAN, IMAGENET_STD
from cutmix_seg_tpu_torch.ops import build
from cutmix_seg_tpu_torch.ops.colour import (
    ColourJitterConfig,
    ColourParams,
    sample_colour_params,
)
from cutmix_seg_tpu_torch.ops.cutmix import KERNEL, cutmix_blend, cutmix_blend_plain
from cutmix_seg_tpu_torch.ops.iou import confusion_matrix
from cutmix_seg_tpu_torch.train import common
from tests import _torch_card as card

HALF = dict(prop_range=(0.5, 0.5))
# name: (n, h, w, c, box config, invert, storage offset of x0 and x1)
CUTMIX_CASES = {
    "main_path": (*card.MAIN_SHAPE, HALF, True, 0),
    "isic_224": (*card.ISIC_SHAPE, HALF, True, 0),
    "cityscapes_256x512": (*card.CITY_SHAPE, HALF, True, 0),
    "sweep_64": (*card.SWEEP_SHAPE, HALF, True, 0),
    "two_boxes_64": (4, 64, 64, 3, dict(prop_range=(0.25, 0.75), n_boxes=2), True, 0),
    "odd_height_no_invert": (2, 33, 48, 1, dict(prop_range=(0.5, 0.5), invert=False), False, 0),
    "outside_bounds": (6, 40, 52, 3, dict(prop_range=(0.3, 0.9), n_boxes=2,
                                          within_bounds=False), True, 0),
    # not 16-byte aligned: the kernel's one-element variant
    "offset_view": (*card.MAIN_SHAPE, HALF, True, 1),
    # 2907 elements: a ragged end in f32 and bf16, vectors across samples
    "tail_and_straddle": (3, 17, 19, 3, HALF, True, 0),
    "c21": (2, 41, 41, 21, HALF, True, 0),
    # past the 65,535 grid-y limit of a per-sample grid
    "batch_70000": (70000, 2, 3, 1, HALF, True, 0),
}
# (geometry, with labels): the gather path and the separable one, each with
# labels and with colour jitter; the case's index is the loader's seed
AUG_CASES = [(mode, labels) for mode in ("crop_rotate_scale", "crop_scale_hung")
             for labels in (True, False)]
# augmented images agree within float32 rounding: source coordinates to a
# few ulps, times a step of up to 255 between neighbouring pixels, is 2e-3
# on the 0-255 scale, 5e-5 after normalisation (std 0.224); a valid mask
# moves by the coordinate's own error (1e-5)
AUG_NORM_ATOL, AUG_MASK_ATOL = 5e-5, 1e-5


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CUTMIX_CASES))
def test_cutmix_kernel_is_its_plain_version(gpu, name, dtype):
    n, h, w, c, box_kw, invert, offset = CUTMIX_CASES[name]
    x0, x1, rects = card.case_inputs(n, h, w, c, box_kw, dtype,
                                     sorted(CUTMIX_CASES).index(name), offset)
    if name == "outside_bounds":
        assert bool((rects < 0).any()), "the case has no negative coordinate"
    before = build.launch_counts[KERNEL]
    mix_k, m_k = cutmix_blend(x0, x1, rects, invert)
    assert build.launch_counts[KERNEL] == before + 1
    mix_p, m_p = cutmix_blend_plain(x0, x1, rects, invert)
    assert torch.equal(mix_k, mix_p) and torch.equal(m_k, m_p)


@pytest.fixture(scope="module")
def voc_source(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the card)")
    root = write_voc_tree(str(tmp_path_factory.mktemp("voc") / "VOC2012"), 40, 10, seed=0)
    return PascalVOCDataSource(-1, np.random.RandomState(0), None, root=root)


def _host_batch(source, mode: str, with_labels: bool, seed: int):
    """One host batch of 10 images from the port's loader: (geom, batch)."""
    rotate = mode == "crop_rotate_scale"
    geom = GeomConfig.from_cli((card.CROP, card.CROP), mode == "crop_scale_hung",
                               1.5 if rotate else 1.0, 20.0 if rotate else 0.0, False, True,
                               False, False)
    assert geom.mode == mode
    stream = train_stream(HostBatchBuilder(source, geom, with_labels=with_labels, n_threads=4),
                          source.train_ndx, card.BATCH, seed=seed)
    try:
        return geom, next(stream)
    finally:
        stream.close()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(len(AUG_CASES)),
                         ids=[f"{m}-{'labels' if lab else 'colour'}" for m, lab in AUG_CASES])
def test_augment_batch_on_the_card_is_the_cpus(voc_source, seed):
    mode, with_labels = AUG_CASES[seed]
    geom, host = _host_batch(voc_source, mode, with_labels, seed)
    params = None
    if not with_labels:
        params = sample_colour_params(torch.Generator().manual_seed(seed), card.BATCH,
                                      ColourJitterConfig())
    outs = {}
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        for d in ("cpu", "cuda"):
            b = common.to_device(host, torch.device(d))
            p = None if params is None else ColourParams(
                **{f.name: getattr(params, f.name).to(d) for f in dataclasses.fields(params)})
            out = augment_batch(b["canvas"], b.get("labels"), b["m"], b["sizes"], b["interp"],
                                IMAGENET_MEAN, IMAGENET_STD, p, (card.CROP, card.CROP),
                                with_labels, border=border_for_mode(geom.mode),
                                separable=common.separable_for_geom(geom))
            outs[d] = {k: v.cpu() for k, v in out.items()}
    finally:
        torch.set_float32_matmul_precision(prev)
    ref, got = outs["cpu"], outs["cuda"]
    assert sorted(ref) == sorted(got)
    if with_labels:
        assert torch.equal(got["labels"], ref["labels"])
    for k in ref:
        if k != "labels":
            err = (got[k].double() - ref[k].double()).abs().max().item()
            assert err <= (AUG_MASK_ATOL if k == "mask" else AUG_NORM_ATOL), (k, err)


@pytest.mark.cuda
def test_confusion_matrix_on_the_card_is_the_cpus(gpu):
    rng = np.random.RandomState(5)
    truth = rng.randint(0, card.NUM_CLASSES, size=(card.BATCH, 512, 512))
    truth[rng.rand(*truth.shape) < 0.2] = 255
    pred = rng.randint(0, card.NUM_CLASSES, size=truth.shape)
    want = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(truth), card.NUM_CLASSES)
    got = confusion_matrix(torch.from_numpy(pred).cuda(), torch.from_numpy(truth).cuda(),
                           card.NUM_CLASSES)
    assert torch.equal(got.cpu(), want)
    assert int(want.sum()) == int((truth != 255).sum())
