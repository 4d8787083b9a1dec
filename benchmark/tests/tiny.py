"""Tiny cells for the CPU tests: a benchmark cell at one block per stage
and small crops, on small written data, cut by its family's module,
``benchmark/tests/tiny_families/<family>.py``, which holds:

* ``ARCH`` and ``register()``: the tiny port architecture, registered in
  the port's architecture registry under a name of its own;
* ``FLAGS`` and ``cut(config)``: the flags it sets and its cut of the
  configuration's model, data and initialisation;
* ``LIMITS``: the tiny cell's limits on the CPU, and ``CARD_LIMITS`` what
  the card's tests compare at the tiny sizes;
* ``F32_TOLERANCE`` and ``f32_patches(patcher)``: the bound on every
  reading of the float32 program against the reference, and what that
  lockstep patches first."""

from __future__ import annotations

import copy
from types import ModuleType
from typing import List

from benchmark import named, recipe


def cells() -> List[str]:
    """The cells of BENCHMARK.json, which the tests are parametrised by."""
    return [w["name"] for w in recipe.manifest()["workloads"]]


def family(cell: dict) -> ModuleType:
    """The tiny module of the cell's model family."""
    return named.module_of("benchmark.tests.tiny_families", cell["config"]["model"]["family"])


def register_tiny_archs() -> None:
    """Register the tiny architecture of every family that a cell runs."""
    for mod in {family(recipe.load_cell(name)) for name in cells()}:
        mod.register()


def _set_flag(flags: List[str], key: str, value) -> List[str]:
    out = [f for f in flags if not f.startswith(f"--{key}=")]
    return out + [f"--{key}={value}"]


def tiny_cell(name: str, manifest_data: dict = None, root: str = recipe.ROOT) -> dict:
    """The named cell of BENCHMARK.json cut to a CPU test's size."""
    cell = copy.deepcopy(recipe.load_cell(name, manifest_data, root))
    cfg = cell["config"]
    fam = family(cell)
    flags = _set_flag(cfg["flags"], "arch", fam.ARCH)
    flags = _set_flag(flags, "batch_size", 2)
    for key, value in fam.FLAGS.items():
        flags = _set_flag(flags, key, value)
    cfg["flags"] = flags
    fam.cut(cfg)
    cell["workload"].update(warmup_iterations=1, trace_seconds=1)
    cell["workload"]["limits"] = dict(fam.LIMITS)
    return cell
