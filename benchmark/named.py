"""Where the benchmark finds what belongs to one name: a configuration's
model family (``reference/families/<family>.py``), its data kind (the
writer and the reference's reader, ``kinds/<kind>.py``), a family's tiny
cut for the CPU tests
(``tests/tiny_families/<family>.py``) and a per-layer metric's reader
(``metrics/<metric>.py``). A new configuration or metric brings these as
new files; no file that is there needs an edit."""

from __future__ import annotations

import importlib
import os
import re
from types import ModuleType

# the benchmark's name pattern (BENCHMARK.json's names, families, kinds)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def module_of(package: str, name: str) -> ModuleType:
    """The module ``<package>.<name>``, with ``.`` and ``-`` in the name
    read as ``_``. A name outside the benchmark's name pattern raises
    ValueError; a name with no module, LookupError naming the file to add."""
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name ({NAME.pattern})")
    full = f"{package}.{name.replace('.', '_').replace('-', '_')}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
    path = os.path.join(*full.split(".")) + ".py"
    raise LookupError(f"no module for {name!r}: add {path}")
