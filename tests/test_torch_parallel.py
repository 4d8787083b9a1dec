"""The port's data-parallel layer (parallel/mesh.py) on the CPU: which rows
a rank holds against the JAX package's batch sharding, the eval batch's
rounding against JAX's, the global sub-batches of unsup_batch_ratio R (Trap
3: the global unsupervised batch is the ranks' batches in rank order, cut
into R), the collectives in two gloo ranks (``tests/_torch_ranks.py``),
what a process without a group sees, and that a stalled rank fails the
spawn instead of hanging it."""

import os
import time

import numpy as np
import pytest
import jax
import torch

from cutmix_seg_tpu.parallel.mesh import batch_sharding, make_mesh
from cutmix_seg_tpu.train import common as jcommon
from cutmix_seg_tpu_torch.parallel import mesh as mesh_mod
from cutmix_seg_tpu_torch.parallel.mesh import Mesh, eval_slice, global_rows, local_rows
from cutmix_seg_tpu_torch.semisup.stepcore import ConsistencyCommon, _subbatch_of_rows
from cutmix_seg_tpu_torch.train import common
from cutmix_seg_tpu_torch.utils.device import resolve_device
from tests import _torch_ranks as ranks


@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_rows_are_the_jax_shards(world):
    """Rank r holds the rows that device r holds of a batch sharded over
    the 'data' axis (and that JAX process r contributes)."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    arr = jax.device_put(x, batch_sharding(make_mesh(world)))
    devices = list(make_mesh(world).devices.flat)
    for shard in arr.addressable_shards:
        r = devices.index(shard.device)
        np.testing.assert_array_equal(local_rows(x, Mesh(world, r)), np.asarray(shard.data))
    assert local_rows(x, None) is x and global_rows(4, Mesh(world, 0)) == 4 * world
    batch = {"canvas": x, "sizes": x[:, :2]}
    assert all(np.array_equal(v, local_rows(batch[k], Mesh(world, world - 1)))
               for k, v in eval_slice(batch, Mesh(world, world - 1)).items())
    if world > 1:
        with pytest.raises(ValueError):
            local_rows(x[:7], Mesh(world, 0))


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_eval_batch_size_matches_jax(world):
    for bs in (1, 5, 10):
        assert common.eval_batch_size(bs, Mesh(world, 0)) == \
            jcommon.eval_batch_size(bs, make_mesh(world))
    assert common.eval_batch_size(5, None) == 5
    # the real images of a rank's slice of a padded batch
    assert [common.local_count(5, 3, Mesh(2, r)) for r in (0, 1)] == [3, 2]
    assert [common.local_count(2, 3, Mesh(2, r)) for r in (0, 1)] == [2, 0]


@pytest.mark.parametrize("world, ratio, n", [(2, 2, 3), (2, 3, 2), (4, 2, 1), (3, 2, 2)])
def test_global_subbatches_match_jax_reshape(world, ratio, n):
    """Rank r's rows of the global unsupervised batch (ratio * n each) fall
    in the sub-batches that JAX's reshape(R, -1) of the global batch cuts."""
    cfg = ConsistencyCommon(unsup_batch_ratio=ratio)
    rows = world * ratio * n
    want = np.arange(rows).reshape(ratio, -1)
    for r in range(world):
        got = _subbatch_of_rows(cfg, ratio * n, Mesh(world, r), "cpu").numpy()
        for i, g in enumerate(range(r * ratio * n, (r + 1) * ratio * n)):
            assert g in want[got[i]]
    if world == ratio == 2:  # rank 0's rows are all of sub-batch 0
        assert set(_subbatch_of_rows(cfg, ratio * n, Mesh(2, 0), "cpu").tolist()) == {0}


def test_collectives_over_two_ranks(tmp_path):
    """all_reduce_sum sums forward and backward; all_reduce_grads sums the
    gradients (a missing one as zero) with the extra vector; gather_rows
    and the host helpers gather in rank order."""
    out = ranks.run_ranks(tmp_path, {"kind": "collectives"}, 2)
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["y"], [3.0, 6.0])
        # d/dx_r of sum_q (y * w * (q + 1)): the backward sums over the ranks
        np.testing.assert_array_equal(o["x_grad"], np.array([3.0, 5.0]) * 3)
        np.testing.assert_array_equal(o["weight_grad"], [[3.0, 3.0]])
        np.testing.assert_array_equal(o["bias_grad"], [0.0])
        np.testing.assert_array_equal(o["extra"], [3.0])
        np.testing.assert_array_equal(o["rows"], [[0.0] * 3] * 2 + [[1.0] * 3] * 2)
        assert o["gather_host"] == [10.0, 11.0] and o["lead_value"] == 7.0
        assert (o["world"], o["rank"], o["is_lead"]) == (2, r, r == 0)
        assert o["data_mesh"] == Mesh(2, r)


def test_alone_without_a_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not mesh_mod.maybe_initialize_distributed("cpu")
    assert (mesh_mod.world(), mesh_mod.rank(), mesh_mod.is_lead()) == (1, 0, True)
    assert mesh_mod.data_mesh() is None
    assert mesh_mod.gather_host(3.0) == [3.0] and mesh_mod.lead_value(4.0) == 4.0
    np.testing.assert_array_equal(mesh_mod.host_sum([1.0, 2.0]), [1.0, 2.0])


def test_torchrun_local_rank_picks_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device() == torch.device("cuda", 1)
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_a_stalled_rank_fails_the_spawn(tmp_path):
    """Rank 1 never joins: the spawn fails at its deadline, and no rank
    process is left running."""
    t0 = time.monotonic()
    spawn = ranks.RankProcesses(tmp_path, {"kind": "stall", "timeout": 5}, 2, timeout=20)
    with pytest.raises(AssertionError, match="outlived 20"):
        spawn.wait()
    assert time.monotonic() - t0 < 40
    assert all(p.poll() is not None for p in spawn.procs)
    assert not os.path.exists(spawn.d / "out_1.pt")
