"""Checkpoint / resume of the full train state (port of
cutmix_seg_tpu.core.checkpoint, with ``torch.save``).

A checkpoint ``ckpt_{step:09d}.pt`` holds the student and teacher
``state_dict``s, the optimiser's moments and count, ``state.step`` and the
state of the generator that draws the CutMix boxes. It is written through a
``.tmp`` file renamed atomically, and only the newest ``keep`` (2) stay.
``export_params`` writes the eval net's ``state_dict`` for deployment.

The train step updates tensors in place, so a save copies the state to the
host on the caller's thread, before the next step can run (the counterpart
of ``jax.device_get``); the background writer only serialises and writes.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Optional

import torch

from cutmix_seg_tpu_torch.core.train_state import TrainState

_CKPT = re.compile(r"ckpt_\d+\.pt$")


def _host_copy(tensors):
    """Detached host copies; from a CUDA device the copy is synchronous, so
    the values are those of this moment."""
    if isinstance(tensors, dict):
        return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}
    return [t.detach().to("cpu", copy=True) for t in tensors]


def state_to_host(state: TrainState) -> dict:
    """The train state as a dict of host tensors and Python numbers."""
    opt = state.optimizer
    return {
        "student": _host_copy(state.student.state_dict()),
        "teacher": (None if state.teacher is None
                    else _host_copy(state.teacher.state_dict())),
        "optimizer": {"count": opt.count,
                      "groups": [{k: _host_copy(v) for k, v in g.state.items()}
                                 for g in opt.groups]},
        "step": state.step,
        "generator": state.generator.get_state(),
    }


def _write(ckpt_dir: str, host_state: dict, step: int, keep: int) -> str:
    path = os.path.join(ckpt_dir, f"ckpt_{step:09d}.pt")
    tmp = path + ".tmp"
    torch.save(host_state, tmp)
    os.replace(tmp, path)
    _prune(ckpt_dir, keep)
    return path


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int, keep: int = 2) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    return _write(ckpt_dir, state_to_host(state), step, keep)


# one writer slot per checkpoint directory: independent trainers in one
# process never join or error-contaminate each other. Guarded by
# _writers_lock; each slot holds (thread, error-box).
_writers: dict = {}
_writers_lock = threading.Lock()


def save_checkpoint_async(ckpt_dir: str, state: TrainState, step: int,
                          keep: int = 2) -> None:
    """Overlap serialising and writing a checkpoint with training.

    The host copy runs on the caller's thread; ``torch.save`` and the file
    write run on a background thread. At most one save per directory is in
    flight: a new call joins the previous one first, and a writer's error
    surfaces on the next call or on ``wait_pending_saves``. Call
    ``wait_pending_saves(ckpt_dir)`` before reading the checkpoint back or
    exiting."""
    key = os.path.abspath(ckpt_dir)
    wait_pending_saves(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    host_state = state_to_host(state)
    box: list = []

    def work():
        try:
            _write(ckpt_dir, host_state, step, keep)
        except BaseException as e:  # surfaced by wait_pending_saves
            box.append(e)

    t = threading.Thread(target=work, name="ckpt-writer", daemon=True)
    with _writers_lock:
        _writers[key] = (t, box)
    t.start()


def wait_pending_saves(ckpt_dir: Optional[str] = None) -> None:
    """Join in-flight checkpoint writes, re-raising the first error: that
    directory's writer with ``ckpt_dir``, every writer without."""
    with _writers_lock:
        if ckpt_dir is None:
            items = list(_writers.items())
        else:
            key = os.path.abspath(ckpt_dir)
            items = [(key, _writers[key])] if key in _writers else []
    first_error = None
    for key, (t, box) in items:
        t.join()
        with _writers_lock:
            # pop only our slot: another thread may have registered a fresh
            # writer for this directory while we were joining
            if _writers.get(key) == (t, box):
                del _writers[key]
        if box and first_error is None:
            first_error = box[0]
    if first_error is not None:
        raise first_error


def _list(ckpt_dir: str):
    return sorted(f for f in os.listdir(ckpt_dir) if _CKPT.match(f))


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    ckpts = _list(ckpt_dir)
    return os.path.join(ckpt_dir, ckpts[-1]) if ckpts else None


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into a freshly built state of the same structure
    (in place; returns it)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if (data["teacher"] is None) != (state.teacher is None):
        raise ValueError(f"{path}: mean-teacher mode differs from the state's")
    state.student.load_state_dict(data["student"])
    if state.teacher is not None:
        state.teacher.load_state_dict(data["teacher"])
    opt = state.optimizer
    if len(data["optimizer"]["groups"]) != len(opt.groups):
        raise ValueError(f"{path}: optimiser groups differ from the state's")
    with torch.no_grad():
        for g, saved in zip(opt.groups, data["optimizer"]["groups"]):
            for name, tensors in g.state.items():
                for dst, src in zip(tensors, saved[name], strict=True):
                    dst.copy_(src)
    opt.count = int(data["optimizer"]["count"])
    state.step = int(data["step"])
    state.generator.set_state(data["generator"])
    return state


def export_params(path: str, module: torch.nn.Module) -> None:
    """Export the eval net's ``state_dict`` (the reference's final
    save_model)."""
    tmp = path + ".tmp"
    torch.save(_host_copy(module.state_dict()), tmp)
    os.replace(tmp, path)


def _prune(ckpt_dir: str, keep: int):
    for f in _list(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, f))
