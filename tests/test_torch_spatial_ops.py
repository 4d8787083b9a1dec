"""The row exchange and the spatial forms of the cross-row operations of
DeepLab v2 and v3/v3+ (``parallel.spatial``, ``models.common``) at S = 2
and 3 model ranks (gloo rank processes on the CPU,
``tests/_torch_ranks.py``), against the unsplit operation in this process:
every conv shape of DeepLab v2 (the 7x7/2 stem, the 1x1/2 projections, 1x1,
the 3x3 dilations 1, 2 and 4 and the ASPP's 6-24), the ceil-mode max pool
and the align-corners upsample; v3's floor-mode stem pool, the image
pooling's global mean (also feeding a training BN, whose world-wide sums
see each pooled value S times) and the half-pixel resizes (up and down); on
heights that split unevenly (33, 65, 129, 5, 9) and where a window reaches past the
neighbouring rank (dilation 6 on 5 rows, 24 on 33). Each rank's output
rows, input gradient and partial weight gradient must give, concatenated
or summed, the unsplit op's: outputs and input gradients within 1e-5 (the
resizes' wider: torch's source index is computed in float32, the spatial
form's from a float64 matrix, ``_tol``), weight gradients within 1e-5
relative. The layout helpers are held to the JAX module's.
"""

import numpy as np
import pytest
import torch

from cutmix_seg_tpu.parallel import spatial as jspatial
from cutmix_seg_tpu.parallel.mesh import make_mesh
from cutmix_seg_tpu_torch.parallel import spatial
from cutmix_seg_tpu_torch.parallel.mesh import Mesh
from tests import _torch_ranks as ranks

torch.set_num_threads(1)

WAYS = (2, 3)


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    """{S: each rank's results} for S = 2 and 3 (both spawns started first),
    and the unsplit results."""
    tmp = tmp_path_factory.mktemp("spatial_ops")
    spawns = {S: ranks.RankProcesses(tmp, {"kind": "spatial_ops", "n_model": S}, S)
              for S in WAYS}
    try:
        alone = {name: ranks.spatial_op_run(name, None) for name in ranks.SPATIAL_OPS}
    except BaseException:
        for sp in spawns.values():
            sp.kill()
        raise
    return {S: sp.wait() for S, sp in spawns.items()}, alone


def _tol(name, want):
    """1e-5, but the resizes': the align-corners upsample's 3e-5, and the
    half-pixel resize's 1e-5 + 2**-21 * h_in * max|want|. Torch computes
    that source index, (y + 0.5) * h_in / h_out - 0.5, in float32, off by
    up to h_in * 2**-24 from the float64 matrix's; a weight off by that
    moves an output by it times a difference of two rows (2 * max|x|), and
    an input's gradient sums up to 2 * h_out / h_in + 2 such terms."""
    if name.startswith("half_"):
        return 1e-5 + 2.0 ** -21 * ranks.SPATIAL_OPS[name][1] * want.abs().max().item()
    return 3e-5 if name.startswith("up_") else 1e-5


@pytest.mark.parametrize("S", WAYS)
@pytest.mark.parametrize("name", sorted(ranks.SPATIAL_OPS))
def test_split_op_matches_unsplit(split_runs, name, S):
    per_rank, alone = split_runs[0][S], split_runs[1]
    want = alone[name]
    got = [r[name] for r in per_rank]
    h_out = want["out"].shape[1]
    # each rank holds its balanced share of the output rows
    assert [g["out"].shape[1] for g in got] == [hi - lo for lo, hi in spatial.split_rows(h_out, S)]
    for key in ("out", "x_grad"):
        cat = torch.cat([g[key] for g in got], dim=1)
        assert cat.shape == want[key].shape, key
        torch.testing.assert_close(cat, want[key], rtol=0, atol=_tol(name, want[key]), msg=key)
    for key in ("w_grad", "b_grad", "bn_w_grad", "bn_b_grad"):
        if key in want:
            total = sum(g[key] for g in got)
            scale = want[key].abs().max().item()
            torch.testing.assert_close(total, want[key], rtol=0, atol=1e-5 * scale, msg=key)
    if "running_var" in want:  # the statistics of the pooled values, once each
        for g in got:
            torch.testing.assert_close(g["running_var"], want["running_var"], rtol=1e-5, atol=0)


def test_cases_cover_uneven_splits_and_long_halos():
    """The cases split unevenly at S = 2 and 3, and a conv window reaches
    past the neighbouring rank's rows."""
    uneven = {S: [n for n, (_, h, _) in ranks.SPATIAL_OPS.items() if h % S] for S in WAYS}
    assert all(len(v) >= 4 for v in uneven.values()), uneven
    _, h, kw = ranks.SPATIAL_OPS["aspp_d6_halo_gt_shard"]
    assert kw["d"] > max(hi - lo for lo, hi in spatial.split_rows(h, 2))
    _, h, kw = ranks.SPATIAL_OPS["aspp_d24_33"]
    assert kw["d"] > max(hi - lo for lo, hi in spatial.split_rows(h, 2))


@pytest.mark.parametrize("h,ways,want", [
    (33, 2, [(0, 17), (17, 33)]), (65, 2, [(0, 33), (33, 65)]), (5, 3, [(0, 2), (2, 4), (4, 5)]),
    (36, 2, [(0, 18), (18, 36)]), (8, 4, [(0, 2), (2, 4), (4, 6), (6, 8)])])
def test_split_rows(h, ways, want):
    assert spatial.split_rows(h, ways) == want


def test_even_split_is_jax_shard():
    """An H that the ways divide splits as JAX shards it."""
    import jax
    import jax.numpy as jnp

    mesh = make_mesh(1, n_model=2)
    x = np.arange(2 * 36 * 3).reshape(2, 36, 3).astype(np.float32)
    arr = jax.device_put(jnp.asarray(x), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", "model")))
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[1].start or 0)
    for m, shard in enumerate(shards):
        np.testing.assert_array_equal(spatial.slice_h(x, Mesh(2, m, 2)), np.asarray(shard.data))


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2), (4, 1), (2, 1), (1, 4)])
def test_axis_sizes_match_jax(n_data, n_model):
    jmesh = make_mesh(n_data, n_model=n_model)
    mesh = Mesh(n_data * n_model, 0, n_model)
    assert spatial.spatial_h_axis_size(mesh) == jspatial.spatial_h_axis_size(jmesh)
    assert spatial.spatial_batch_axis_size(mesh) == jspatial.spatial_batch_axis_size(jmesh)
    em = spatial.eval_mesh(mesh)
    assert (em.n_data, em.n_model) == ((n_data, n_model) if n_model > 1 else (1, n_data))


def test_mesh_indices_are_model_minor():
    """Rank r's data index is r // S and its model index r % S (JAX's
    make_mesh lays 'model' minor)."""
    jmesh = make_mesh(2, n_model=2)
    devs = np.asarray(jmesh.devices)
    for r in range(4):
        m = Mesh(4, r, 2)
        assert devs[m.data_index, m.model_index] == jmesh.devices.flat[r]
        assert (m.n_data, m.data_index, m.model_index) == (2, r // 2, r % 2)


@pytest.mark.parametrize("h,multiple", [(55, 8), (56, 8), (33, 2), (36, 6)])
def test_pad_batch_h_matches_jax(h, multiple):
    rng = np.random.RandomState(h)
    batch = {"canvas": rng.randint(0, 256, (2, h, 5, 3)).astype(np.uint8),
             "labels": rng.randint(0, 4, (2, h, 5)).astype(np.int32),
             "sizes": np.array([[h, 5], [h - 3, 4]], np.int32), "count": 2}
    got, want = spatial.pad_batch_h(batch, multiple), jspatial.pad_batch_h(batch, multiple)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    if h % multiple == 0:
        assert got is batch


@pytest.mark.parametrize("n_in,n_out", [(5, 9), (9, 36), (36, 17), (7, 7), (1, 4), (4, 1),
                                        (65, 257)])
def test_half_pixel_matrix_matches_jax_resize(n_in, n_out):
    """Each row of ``interp_matrix_half_pixel`` is jax.image.resize's
    'linear' (antialias off) of a one-hot column, edges included, within
    n_in * 2**-22: JAX places the samples in float32."""
    import jax
    import jax.numpy as jnp

    eye = jnp.eye(n_in, dtype=jnp.float32)[None, :, :, None]  # (1, n_in, n_in, 1)
    want = np.asarray(jax.image.resize(eye, (1, n_out, n_in, 1), method="linear",
                                       antialias=False))[0, :, :, 0]
    np.testing.assert_allclose(spatial.interp_matrix_half_pixel(n_in, n_out), want,
                               rtol=0, atol=2.0 ** -22 * n_in)


def test_interp_matrix_matches_jax():
    from cutmix_seg_tpu.models.common import _interp_matrix_align_corners

    for n_in, n_out in ((33, 256), (5, 36), (9, 9), (1, 4), (4, 1), (65, 33)):
        np.testing.assert_array_equal(spatial.interp_matrix_align_corners(n_in, n_out),
                                      _interp_matrix_align_corners(n_in, n_out))


def test_set_spatial_refuses_networks_without_spatial_forms():
    """TinyBN (no ``supports_spatial``) is refused, naming ROADMAP A6c;
    every family of the JAX package's archs is taken (tiny here: the
    attribute is the class's)."""
    net = ranks.TinyBN()
    spatial.set_spatial(net, None)  # the plain forward is always fine
    spatial.set_spatial(net, Mesh(2, 0, 1))
    with pytest.raises(NotImplementedError, match="TinyBN.*ROADMAP A6c"):
        spatial.check_supported(net)
    with pytest.raises(NotImplementedError, match="ROADMAP A6c"):
        spatial.set_spatial(net, Mesh(2, 0, 2))
    for family in ("deeplab2", "deeplabv3", "deeplabv3plus", "pspnet", "resunet", "denseunet"):
        spatial.check_supported(ranks.MODELS[family]().module)
