"""The one generator of the benchmark's data: a configuration's ``data``
block names a kind and its sizes, and the run's seed makes the files. Each
kind is a module of its own, ``benchmark/kinds/<kind>.py``, whose
``write(data, root, seed)`` writes under ``root`` and returns
{'kind', 'path', 'config_name'} (the program's config-file entry). The
writers are frozen copies of the program's ``data/synthetic.py``, so that
the program can change without changing the benchmark's inputs.
"""

from __future__ import annotations

from benchmark import named


def write(data: dict, root: str, seed: int) -> dict:
    """Write a configuration's data under ``root`` from ``seed``; returns
    {'kind', 'path', 'config_name'} (the program's config-file entry)."""
    return named.module_of("benchmark.kinds", data["kind"]).write(
        data, root, seed % (1 << 32))


def write_paths_config(path: str, written: dict) -> str:
    """The program's dataset-path file naming the written data."""
    with open(path, "w") as f:
        f.write(f"[paths]\n{written['config_name']} = {written['path']}\n")
    return path
