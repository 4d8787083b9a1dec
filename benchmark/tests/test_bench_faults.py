"""``correct`` comes out false when the timed path is broken underneath a
whole run (the harness's look for a card skipped, the run on the CPU at a
tiny size), once for each fault a training cell on one chip can have
(``benchmark/faults.py``), and for the control: the reference in float8
put in the program's place."""

import json

import pytest

from benchmark import check, faults, run
from benchmark.tests.tiny import cells, tiny_cell

SEED = 987654321


@pytest.mark.parametrize("name", cells())
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_fails(tiny_archs, monkeypatch, name, fault):
    faults.FAULTS[fault](monkeypatch)
    res = run.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu")
    assert not res["correct"], json.dumps(res["checks"])


@pytest.mark.parametrize("name", cells())
def test_sound_run_passes_the_tiny_limits(tiny_archs, name):
    res = run.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu")
    assert res["correct"], json.dumps(res["checks"])


@pytest.mark.parametrize("name", cells())
def test_control_fails(tiny_archs, name):
    cell = tiny_cell(name)
    ver = check.verdict(faults.control(cell, SEED, "cpu")["readings"],
                        cell["workload"]["limits"])
    assert not all(v["ok"] for v in ver.values()), json.dumps(ver)
