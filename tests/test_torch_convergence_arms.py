"""The Cutout, ICT, VAT and aug_mt arms of the port's
tools/multi_seed_convergence.py against ``jax.jit`` of the JAX tool's
``make_arm_runner`` on the CPU: 4 iterations of 2 seeds, draws replayed from
the JAX key chains, the tolerances of test_torch_convergence.py (whose
helpers this file runs; the supervised and CutMix arms are there)."""

import pytest
import torch

from tests.test_torch_convergence import check_arm, record_sweep

torch.set_num_threads(1)

ARMS = ["cutout", "ict", "vat_mt", "aug_mt"]


@pytest.fixture(scope="module")
def jax_sweep(tmp_path_factory):
    return record_sweep(tmp_path_factory, ",".join(ARMS), colour=False)


@pytest.mark.parametrize("arm", ARMS)
def test_arm_matches_jax_runner(arm, jax_sweep, monkeypatch):
    check_arm(arm, jax_sweep, monkeypatch)
