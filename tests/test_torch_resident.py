"""The port's device-resident training store (data/resident.py, the index
mode of data/loader.py, ``--data_on_device`` in train/engine.py) against the
JAX package on the CPU: the staged arrays and the index-mode host batches
bit-equal to JAX's, the store's augmented batch against the streaming one
(labels bit-equal, images within 1e-5, as JAX's tests/test_data.py holds
it), ``auto``'s decision equal to JAX's ``_setup_resident``, and the trainer
with the store on against off."""

import types

import numpy as np
import pytest
import torch

from cutmix_seg_tpu.aug.params import GeomConfig as JGeomConfig
from cutmix_seg_tpu.data import loader as jloader
from cutmix_seg_tpu.data import resident as jresident
from cutmix_seg_tpu.parallel.mesh import make_mesh
from cutmix_seg_tpu.train import engine as jengine
from cutmix_seg_tpu_torch.aug.params import GeomConfig
from cutmix_seg_tpu_torch.data import loader, resident
from cutmix_seg_tpu_torch.train import common, engine
from tests._torch_tmp import drop_tmp_path_if_passed  # noqa: F401
from tests.test_torch_trainer import _submit, voc  # noqa: F401
from tests.test_torch_trainer_algos import both_sources  # noqa: F401

torch.set_num_threads(1)

CROP = (32, 32)


@pytest.fixture
def stores(both_sources):  # noqa: F811
    """Each package's store over the 'pascal' train indices but the last
    two: (JAX split, JAX store, port split, port store)."""
    j, t = both_sources
    idx = t["ds_src"].train_ndx[:-2]
    return (j, jresident.ResidentDataset(j["ds_src"], idx, make_mesh(1), with_labels=True),
            t, resident.ResidentDataset(t["ds_src"], idx, "cpu", with_labels=True))


def test_store_matches_jax(stores):
    j, jres, t, tres = stores
    assert set(tres.data) == set(jres.device) == {"canvas", "labels"}
    for k, v in tres.data.items():
        assert v.dtype == torch.uint8 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(jres.device[k]), err_msg=k)
    idx = t["ds_src"].train_ndx[:-2]
    np.testing.assert_array_equal(tres.rows(idx[::-1]), jres.rows(idx[::-1]))
    assert tres.rows(idx).dtype == np.int32
    np.testing.assert_array_equal(tres.sizes_of(idx), jres.sizes_of(idx))
    assert resident.resident_nbytes(t["ds_src"], len(idx), True) \
        == jresident.resident_nbytes(j["ds_src"], len(idx), True)
    assert resident.DEFAULT_MAX_BYTES == jresident.DEFAULT_MAX_BYTES == 1 << 30
    for bad in ([t["ds_src"].train_ndx[-1]], [-1], [10 ** 6]):  # not staged
        with pytest.raises(KeyError):
            jres.rows(np.asarray(bad))
        with pytest.raises(KeyError, match="not staged"):
            tres.rows(np.asarray(bad))


# geometry mode, pair geometry (aug_mt), labels
INDEX_CASES = {
    "hung_sup": ("crop_scale_hung", False, True),
    "hung_unsup": ("crop_scale_hung", False, False),
    "rotate_pair": ("crop_rotate_scale", True, False),
}


def _geoms(mode):
    kw = dict(crop_size=CROP, aug_scale_hung=mode == "crop_scale_hung",
              aug_max_scale=1.3 if mode == "crop_rotate_scale" else 1.0,
              aug_rot_mag=15.0 if mode == "crop_rotate_scale" else 0.0,
              aug_scale_non_uniform=False, aug_hflip=True, aug_vflip=False, aug_hvflip=False)
    return GeomConfig.from_cli(**kw), JGeomConfig.from_cli(**kw)


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_index_mode_batches_bit_equal_to_jax(stores, case):
    """The index-mode host batches of a stream (rows, sizes, matrices,
    interpolation flags) equal JAX's, key for key and dtype for dtype."""
    mode, pair, labels = INDEX_CASES[case]
    j, jres, t, tres = stores
    geom, jgeom = _geoms(mode)
    tb = loader.HostBatchBuilder(t["ds_src"], geom, labels, pair_geom=pair, n_threads=2,
                                 resident=tres)
    jb = jloader.HostBatchBuilder(j["ds_src"], jgeom, labels, pair_geom=pair, n_threads=2,
                                  resident=jres)
    assert tb.window_hw is None
    idx = t["ds_src"].train_ndx[:-2]
    ts, js = loader.train_stream(tb, idx, 3, seed=20), jloader.train_stream(jb, idx, 3, seed=20)
    try:
        for _ in range(4):
            got, want = next(ts), next(js)
            assert sorted(got) == sorted(want) and "idx" in got and "canvas" not in got
            for k, v in want.items():
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    finally:
        ts.close()
        js.close()


@pytest.mark.parametrize("mode", ["crop_scale_hung", "crop_rotate_scale"])
def test_gathered_batch_matches_streaming(stores, mode):
    """The store's batch, gathered and augmented, against the streaming
    batch of the same draws: labels bit-equal, images and valid masks within
    1e-5 (the streaming path re-anchors its matrices to the transfer
    window)."""
    _, _, t, tres = stores
    geom, _ = _geoms(mode)
    src = t["ds_src"]
    idx = np.asarray(src.train_ndx[:4])
    host = loader.HostBatchBuilder(src, geom, True, n_threads=2).build(
        idx, np.random.RandomState(3))
    part = loader.HostBatchBuilder(src, geom, True, n_threads=2, resident=tres).build(
        idx, np.random.RandomState(3))
    aug = common.DeviceAugmentor(torch.zeros(3), torch.ones(3), CROP, geom.mode,
                                 separable=common.separable_for_geom(geom))
    o_stream = aug.sup(common.to_device(host, torch.device("cpu")))
    gathered = resident.gather_part(tres.data, common.to_device(part, torch.device("cpu")),
                                    with_labels=True)
    assert sorted(gathered) == sorted(host)
    o_res = aug.sup(gathered)
    assert torch.equal(o_res["labels"], o_stream["labels"])
    for k in ("image", "mask"):
        if k in o_res:
            np.testing.assert_allclose(o_res[k].numpy(), o_stream[k].numpy(), atol=1e-5, err_msg=k)


# name: (canvas, train images, unsupervised images, consistency on)
DECIDE_SIZES = {
    "fits": ((256, 256), 2000, 2000, True),  # the ISIC recipe: 524 MB
    "pascal_aug": ((512, 512), 10582, 10582, True),  # 11.1 GB
    "just_over": ((512, 512), 1023, 1024, True),
    "sup_only_fits": ((512, 512), 1023, 1024, False),
}


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("size", sorted(DECIDE_SIZES))
def test_data_on_device_decides_as_jax(size, mode, monkeypatch, capsys):
    """The port's _setup_resident stages exactly when JAX's does, for the
    same indices, and prints the same line (the stores are stubbed)."""
    canvas, n_sup, n_unsup, use_cons = DECIDE_SIZES[size]
    src = types.SimpleNamespace(canvas_hw=canvas)
    staged = {}

    def stub(name):
        def make(source, indices, *a, **k):
            staged[name] = np.asarray(indices)
            return name
        return make

    monkeypatch.setattr(jresident, "ResidentDataset", stub("jax"))
    monkeypatch.setattr(resident, "ResidentDataset", stub("port"))
    sup = np.arange(n_sup)
    unsup = np.arange(n_sup - n_unsup // 2, n_sup + n_unsup // 2)  # overlapping
    lines = {}
    for name, cls in (("jax", jengine.TrainEngine), ("port", engine.TrainEngine)):
        eng = types.SimpleNamespace(ds=src, sup_ndx=sup, unsup_ndx=unsup, use_cons=use_cons,
                                    mesh=None, device="cpu")
        capsys.readouterr()
        cls._setup_resident(eng, {"data_on_device": mode})
        lines[name] = (eng.resident, capsys.readouterr().out)
    assert (lines["port"][0] is None) == (lines["jax"][0] is None)
    assert lines["port"][1] == lines["jax"][1]
    if lines["port"][0] is not None:
        np.testing.assert_array_equal(staged["port"], staged["jax"])
        assert lines["port"][1].startswith("Data on device: ")
    if mode == "auto":
        assert (lines["port"][0] is None) == (size in ("pascal_aug", "just_over"))


def test_data_on_device_rejects_unknown_mode():
    eng = types.SimpleNamespace()
    with pytest.raises(ValueError, match="auto/on/off"):
        engine.TrainEngine._setup_resident(eng, {"data_on_device": "maybe"})


def _first_batch(eng):
    eng._open_epoch_streams(0)
    try:
        return eng.make_batch(eng.make_raw_batch())
    finally:
        eng.close_streams()


def test_trainer_store_on_matches_off(voc, tmp_path):  # noqa: F811
    """The trainer's first augmented batch with --data_on_device on against
    off (the same samples and draws): labels bit-equal, images within 1e-5;
    then an 'on' run trains through its epochs."""
    from cutmix_seg_tpu_torch.core import job
    from cutmix_seg_tpu_torch.train import mask_mt
    from tests.test_torch_trainer import _params

    batches = {}
    for mode in ("off", "on"):
        p = _params(data_on_device=mode)
        spec, cfg = mask_mt.build_spec(p)
        ctx = job.RunContext(str(tmp_path / mode), mode)
        eng = engine.TrainEngine(ctx, spec, cfg, p, "cpu")
        assert eng.setup()
        assert (eng.resident is not None) == (mode == "on")
        batches[mode] = _first_batch(eng)
    on, off = batches["on"], batches["off"]
    assert sorted(on) == sorted(off)
    assert torch.equal(on["sup_y"], off["sup_y"])
    for k, v in off.items():
        if k != "sup_y":
            np.testing.assert_allclose(on[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    eng = _submit(tmp_path / "results", "on", data_on_device="on", save_model=False)
    log = (tmp_path / "results" / "test_torch_mask_mt" / "on" / "log_on.txt").read_text()
    assert "Data on device: 10 canvases (0 MB) staged in HBM" in log
    assert "Epoch 2:" in log and eng.state.step == 6
