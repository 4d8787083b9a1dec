"""The port's tools/synthetic_benchmark.py against the JAX tool on the CPU:
the generated task and the aug_mt crop pairs are bit-equal for a seed, and
every algorithm trains a few finite steps through the port's steps."""

import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cutmix_seg_tpu.tools import synthetic_benchmark as jbench
from cutmix_seg_tpu_torch.tools import synthetic_benchmark as tbench

torch.set_num_threads(1)


@pytest.mark.parametrize("seed, hw", [(0, (64, 64)), (7, (80, 80))])
def test_make_image_bit_equal_to_jax(seed, hw):
    r_t, r_j = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(3):
        (ti, tl), (ji, jl) = tbench.make_image(r_t, hw), jbench.make_image(r_j, hw)
        assert ti.dtype == ji.dtype and tl.dtype == jl.dtype
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_aug_pair_batch_bit_equal_to_jax():
    src = np.random.RandomState(0).rand(6, 80, 80, 3).astype(np.float32)
    idx = np.array([0, 3, 5, 3])
    got = tbench._aug_pair_batch(src, idx, np.random.RandomState(2), (64, 64))
    want = jbench._aug_pair_batch(src, idx, np.random.RandomState(2), (64, 64))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("algorithm", list(tbench.ALGORITHMS))
def test_run_is_finite_for_each_algorithm(algorithm):
    miou, loss = tbench.run(iters=3, n_sup=2, n_unsup=6, n_val=4, batch=2,
                            algorithm=algorithm, device="cpu")
    assert 0.0 <= miou <= 1.0 and np.isfinite(loss)


def test_cli_prints_the_jax_keys(monkeypatch):
    """--algorithm all: one JSON line with the JAX tool's keys (its rounding
    of the same fields) plus the device."""
    full_run = tbench.run

    def tiny_run(**kw):
        return full_run(**dict(kw, n_unsup=6, n_val=4, batch=2))

    monkeypatch.setattr(tbench, "run", tiny_run)
    res = CliRunner().invoke(tbench.main, ["--iters", "2", "--n_sup", "2", "--algorithm",
                                           "all", "--device", "cpu"])
    assert res.exit_code == 0, res.output
    out = json.loads(res.output.strip().splitlines()[-1])
    want = {"task", "n_sup", "iters", "supervised_miou", "cutmix_semisup_miou", "gain",
            "seconds"} | {f"{a}_{k}" for a in tbench.ALGORITHMS for k in ("semisup_miou", "gain")}
    assert set(out) == want | {"device"} and out["device"] == "cpu"


def test_cli_needs_a_gpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = CliRunner().invoke(tbench.main, ["--iters", "1"])
    assert res.exit_code != 0 and "CUDA is not available" in str(res.exception)
