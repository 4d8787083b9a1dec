"""The tiny cells on the card (skipped without one): a run goes through
set-up, window and check, reports finite readings (the tiny limits are
the CPU's, where bf16 convolutions round otherwise) and passes the card's
tiny limits (its family's ``CARD_LIMITS`` in ``tiny_families/``), which
the control, the reference through float8 in the program's place, fails.
Run on the card with ``python3 -m pytest benchmark/tests -m card``."""

import json
import math

import pytest

from benchmark import check, faults, run
from benchmark.tests.tiny import cells, family, tiny_cell

SEED = 2147483901


@pytest.mark.card
@pytest.mark.parametrize("name", cells())
def test_tiny_run_on_the_card(card, tiny_archs, name):
    import torch

    torch.cuda.reset_peak_memory_stats()
    cell = tiny_cell(name)
    res = run.run_cell(cell, SEED, 0.5, False, card)
    assert all(math.isfinite(c["value"]) for c in res["checks"].values()), \
        json.dumps(res["checks"])
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
    ver = check.verdict(res["readings"], family(cell).CARD_LIMITS)
    assert all(v["ok"] for v in ver.values()), json.dumps(ver)


@pytest.mark.card
@pytest.mark.parametrize("name", cells())
def test_control_fails_on_the_card(card, tiny_archs, name):
    cell = tiny_cell(name)
    ver = check.verdict(faults.control(cell, SEED, card)["readings"], family(cell).CARD_LIMITS)
    assert not all(v["ok"] for v in ver.values()), json.dumps(ver)
