"""What calibration plants and the tests plant alike: the faults that a
one-chip training cell can have, the control, and a diagnostic reference.

A fault takes a patcher with ``setattr(obj, name, value)`` (pytest's
``monkeypatch``, or ``Patch`` below) and breaks the timed path underneath
the harness:

* ``state_unchanged``: the step leaves the student, its optimiser and the
  teacher as they were;
* ``teacher_unchanged``: the EMA teacher is never updated;
* ``half_batch``: half of each batch left out, the mean taken over the rest;
* ``blend_altered``: the CutMix kernel's answer altered where it is
  produced: its image comes back unmixed, its mask as drawn.

``control`` is the reference computed through float8 in the program's
place, read against the float32 reference. ``tie_matched_reference`` makes
the reference's nearest taps round as the program's do (up from 4 ulps at
the canvas size below a half pixel), so that what remains between the two
is the step's arithmetic.
"""

from __future__ import annotations

import tempfile


class Patch:
    """Module attributes replaced for one run, then restored."""

    def __init__(self):
        self.undo = []

    def setattr(self, obj, name, value):
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore(self):
        for obj, name, value in reversed(self.undo):
            setattr(obj, name, value)
        self.undo = []


def state_unchanged(p) -> None:
    from cutmix_seg_tpu_torch.semisup import mask_mt

    def finish(state, opt, cfg):
        opt.zero_grad()
        state.step += 1
        return state

    p.setattr(mask_mt, "finish_step", finish)


def teacher_unchanged(p) -> None:
    from cutmix_seg_tpu_torch.semisup import stepcore

    p.setattr(stepcore, "ema_update", lambda teacher, student, alpha: None)


def half_batch(p) -> None:
    from cutmix_seg_tpu_torch.semisup import mask_mt

    orig = mask_mt.accumulate

    def accumulate(K, student, batch, one_chunk, mesh=None):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return orig(K, student, half, one_chunk, mesh)

    p.setattr(mask_mt, "accumulate", accumulate)


def blend_altered(p) -> None:
    from cutmix_seg_tpu_torch.semisup import mask_mt

    orig = mask_mt.cutmix_blend

    def blend(x0, x1, rects, invert=True):
        _, m = orig(x0, x1, rects, invert)
        return x0.clone(), m

    p.setattr(mask_mt, "cutmix_blend", blend)


FAULTS = {"state_unchanged": state_unchanged, "teacher_unchanged": teacher_unchanged,
          "half_batch": half_batch, "blend_altered": blend_altered}


def control(cell: dict, seed: int, device: str, precision: str = "fp8",
            as_reference: bool = False) -> dict:
    """The reference in ``precision`` in the program's place against the
    float32 reference, at the cell's size: ``check.readings`` of the pair,
    with each run's losses. ``as_reference``: the other way round, the
    float32 reference judged against the one in ``precision``."""
    import shutil

    from benchmark import check, datagen, recipe, weights
    from benchmark.reference import models, pipeline, steps

    hp = recipe.hyperparameters(cell)
    geom = recipe.geometry(hp)
    tmp = tempfile.mkdtemp(prefix="cutmix_bench_ctl_")
    try:
        w = datagen.write(cell["config"]["data"], tmp, seed)
        ds = pipeline.Dataset(w["kind"], w["path"], hp["n_sup"], hp["split_path"],
                              hp["split_seed"])
        leaves = models.leaves_of(cell["config"]["model"])
        W = weights.make(leaves, seed, cell["config"]["init"], device)
        ref = steps.run(cell["config"]["model"], hp, ds, geom, W, seed, device)
        other = steps.run(cell["config"]["model"], hp, ds, geom, W, seed, device,
                          precision=precision)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if as_reference:
        other, ref = ref, other
    read = check.readings(other, ref)
    return {"readings": read, "losses": {"program": other["losses"], "reference": ref["losses"]}}


def tie_matched_reference(p) -> None:
    from benchmark.reference import pipeline

    orig = pipeline.warp

    def warp(img, lab, m, bilinear, crop, reflect, device):
        import torch

        floor = torch.floor

        def biased(x):
            return floor(x + 256 * 2.0 ** -21) if x.dtype == torch.float64 else floor(x)

        torch.floor = biased
        try:
            return orig(img, lab, m, bilinear, crop, reflect, device)
        finally:
            torch.floor = floor

    p.setattr(pipeline, "warp", warp)
