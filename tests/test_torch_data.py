"""The port's copies of the host data pipeline (data/{settings,sources,
datasets,loader}.py, aug/{params,affine}.py) against the JAX package's
modules on the CPU: for one seed both yield the same host batches, bit for
bit. The images are JPEGs of a synthetic VOC tree, decoded by PIL in the
port and by the JAX package's own decoder there."""

import numpy as np
import pytest

from cutmix_seg_tpu.aug.params import GeomConfig as JGeomConfig
from cutmix_seg_tpu.data import datasets as jdatasets
from cutmix_seg_tpu.data import loader as jloader
from cutmix_seg_tpu.data import settings as jsettings
from cutmix_seg_tpu.data import sources as jsources
from cutmix_seg_tpu_torch.aug.params import GeomConfig
from cutmix_seg_tpu_torch.data import datasets, loader, settings, sources
from cutmix_seg_tpu_torch.data.synthetic import write_config, write_voc_tree

CROP = (24, 32)
GEOM = {
    "crop": dict(crop_size=CROP, aug_scale_hung=False, aug_max_scale=1.0, aug_rot_mag=0.0),
    "crop_scale_hung": dict(crop_size=CROP, aug_scale_hung=True, aug_max_scale=1.0,
                            aug_rot_mag=0.0),
    "crop_rotate_scale": dict(crop_size=CROP, aug_scale_hung=False, aug_max_scale=1.5,
                              aug_rot_mag=20.0),
}


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("voc")
    root = write_voc_tree(str(tmp / "VOC2012"), 12, 3, size_range=(30, 60), seed=2)
    return root, write_config(str(tmp / "seg.cfg"), root)


@pytest.fixture
def both_sources(voc, monkeypatch):
    """The 'pascal' dataset through each package's load_dataset, both named
    by one cfg through $CUTMIX_SEG_CONFIG, on a 64x64 canvas."""
    _, cfg = voc
    monkeypatch.setenv("CUTMIX_SEG_CONFIG", cfg)
    for mod in (settings, jsettings):
        monkeypatch.setattr(mod, "_config", None)
    for cls in (sources.PascalVOCDataSource, jsources.PascalVOCDataSource):
        monkeypatch.setattr(cls, "canvas_hw", (64, 64))
    args = ("pascal", -1, 131, 4, -1, 12345, None)
    return jdatasets.load_dataset(*args), datasets.load_dataset(*args)


def test_splits_and_decoded_arrays_match(both_sources):
    j, t = both_sources
    for k in ("sup_ndx", "unsup_ndx", "val_ndx_tgt"):
        np.testing.assert_array_equal(t[k], j[k])
    assert t["test_ndx_tgt"] is None and j["test_ndx_tgt"] is None
    js, ts = j["ds_src"], t["ds_src"]
    assert ts.sample_names == js.sample_names and ts.num_classes == 21
    for i in range(len(ts.sample_names)):
        np.testing.assert_array_equal(ts.get_image(i), js.get_image(i))
        np.testing.assert_array_equal(ts.get_labels(i), js.get_labels(i))
        assert ts.get_labels(i).dtype == np.int32


def _assert_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("mode", sorted(GEOM))
def test_train_stream_bit_equal_to_jax(both_sources, mode):
    j, t = both_sources
    flags = dict(aug_scale_non_uniform=False, aug_hflip=True, aug_vflip=False,
                 aug_hvflip=False)
    geom = GeomConfig.from_cli(**GEOM[mode], **flags)
    jgeom = JGeomConfig.from_cli(**GEOM[mode], **flags)
    assert geom.mode == mode
    for with_labels, seed in ((True, 10), (False, 20)):
        tb = loader.HostBatchBuilder(t["ds_src"], geom, with_labels=with_labels, n_threads=2)
        jb = jloader.HostBatchBuilder(j["ds_src"], jgeom, with_labels=with_labels, n_threads=2)
        assert tb.window_hw == jb.window_hw
        assert (tb.window_hw is None) == (mode == "crop_rotate_scale")
        ts = loader.train_stream(tb, t["unsup_ndx"], 3, seed=seed)
        js = jloader.train_stream(jb, j["unsup_ndx"], 3, seed=seed)
        try:
            for _ in range(5):  # past one pass over the 12 names: a reshuffle
                _assert_batches_equal(next(ts), next(js))
        finally:
            ts.close()
            js.close()


def test_eval_batches_pad_the_last_batch(both_sources):
    j, t = both_sources
    idx = t["val_ndx_tgt"]
    assert len(idx) == 3
    tbs = list(loader.eval_batches(t["ds_src"], idx, 2))
    jbs = list(jloader.eval_batches(j["ds_src"], idx, 2))
    assert [b["count"] for b in tbs] == [2, 1]
    for a, b in zip(tbs, jbs):
        assert a["count"] == b["count"]
        _assert_batches_equal({k: v for k, v in a.items() if k != "count"},
                              {k: v for k, v in b.items() if k != "count"})
    last = tbs[-1]
    assert last["canvas"].shape == (2, 64, 64, 3)
    assert (last["labels"][1:] == 255).all()  # the padded repeat cannot count
    np.testing.assert_array_equal(last["indices"], [idx[2], idx[2]])
