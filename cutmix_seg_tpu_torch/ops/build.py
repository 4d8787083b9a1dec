"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into ``build/kernels/lib<name>.so``
at the checkout root (a directory that ``.gitignore`` lists) with a plain C
interface, for ``sm_90a``. This takes seconds per source, against minutes for
an extension that includes PyTorch's headers. A library is rebuilt when it is
missing or older than its source; ``build`` starts one ``nvcc`` per stale
source, all together, and waits for all of them.

Kernel wrappers count their launches in ``launch_counts`` (one per launch of
the kernel, nowhere else), so a run can show that its path went through them.
A CUDA graph's replay counts the launches its capture recorded
(``semisup.step_graph``); the capture itself launches nothing and counts none.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> launches since the last clear(); the wrappers add to it
launch_counts: collections.Counter = collections.Counter()
# source name -> nvcc output of its last build in this process (ptxas report)
build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return nvcc


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) whose library is stale.

    Returns {name: seconds} for the sources actually compiled. Raises with
    the compiler's output if any compile fails, after every ``nvcc`` it
    started has ended."""
    names = sources() if names is None else list(names)
    stale = []
    for name in names:
        src, lib = CSRC_DIR / f"{name}.cu", _lib_path(name)
        if not src.exists():
            raise FileNotFoundError(src)
        if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
            stale.append(name)
    if not stale:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in stale:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, t0) in jobs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built first if stale."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
