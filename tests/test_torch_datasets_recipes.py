"""The recipes' own datasets in the port against the JAX package on the CPU:
pascal_aug (the SBD split with data/splits/pascal_aug/split_0.pkl),
Cityscapes (raw zips through both converters) and CamVid, as the sources
read them (indices and decoded arrays bit for bit); the ported tools
(convert_cityscapes, convert_isic, download_pascal_aug_names --from_dir)
against the JAX tools; and the CutMix trainer on each dataset with its own
flags and a tiny model."""

import io
import os
import pickle
import zipfile

import numpy as np
import pytest
from click.testing import CliRunner
from PIL import Image

from cutmix_seg_tpu.data import datasets as jdatasets
from cutmix_seg_tpu.data import settings as jsettings
from cutmix_seg_tpu.data import sources as jsources
from cutmix_seg_tpu.tools import convert_cityscapes as jconv_city
from cutmix_seg_tpu.tools import convert_isic as jconv_isic
from cutmix_seg_tpu.tools import download_pascal_aug_names as jnames
from cutmix_seg_tpu_torch.data import datasets, settings, sources, synthetic
from cutmix_seg_tpu_torch.tools import convert_cityscapes, convert_isic, download_pascal_aug_names
from tests._torch_tmp import drop_tmp_path_if_passed  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = os.path.join(ROOT, "data", "splits", "pascal_aug", "split_0.pkl")
CITY_RAW_HW = (64, 128)  # x2-downsampled to the (32, 64) canvas below


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The SBD tree (10,582 train_aug names over 6 + 4 written pairs),
    raw Cityscapes zips and both converters' outputs, and a CamVid zip."""
    d = tmp_path_factory.mktemp("recipes")
    voc = synthetic.write_voc_tree(str(d / "VOC2012"), 6, 4, size_range=(36, 48), seed=3,
                                   sbd_train=synthetic.SBD_TRAIN_AUG)
    x_zip, y_zip = synthetic.write_cityscapes_zips(str(d), 5, 3, size=CITY_RAW_HW, seed=1)
    city = str(d / "cityscapes.zip")
    convert_cityscapes.convert_cityscapes(x_zip, y_zip, city, 2, progress=False)
    jcity = str(d / "cityscapes_jax.zip")
    jconv_city.convert_cityscapes(x_zip, y_zip, jcity, 2, progress=False)
    camvid = synthetic.write_camvid_zip(str(d / "camvid.zip"), 5, 3, 2, size=(36, 48), seed=2)
    cfg = synthetic.write_config(str(d / "seg.cfg"), voc, cityscapes_zip=city, camvid_zip=camvid)
    return {"voc": voc, "city": city, "city_jax": jcity, "camvid": camvid, "cfg": cfg,
            "raw": (x_zip, y_zip)}


@pytest.fixture
def configured(data_dir, monkeypatch):
    """Both packages read data_dir's cfg; the sources' canvases fit its
    images."""
    monkeypatch.setenv("CUTMIX_SEG_CONFIG", data_dir["cfg"])
    for mod in (settings, jsettings):
        monkeypatch.setattr(mod, "_config", None)
    for mod in (sources, jsources):
        monkeypatch.setattr(mod.PascalVOCDataSource, "canvas_hw", (48, 48))
        monkeypatch.setattr(mod.CityscapesDataSource, "canvas_hw", (32, 64))
        monkeypatch.setattr(mod.CamVidDataSource, "canvas_hw", (48, 48))
    return data_dir


def _same_split(jd, td):
    for k in ("sup_ndx", "unsup_ndx", "val_ndx_tgt", "test_ndx_tgt"):
        if jd[k] is None:
            assert td[k] is None, k
        else:
            np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    js, ts = jd["ds_src"], td["ds_src"]
    assert list(ts.sample_names) == list(js.sample_names)
    assert ts.num_classes == js.num_classes
    for a, b in zip(ts.get_mean_std(), js.get_mean_std()):
        np.testing.assert_array_equal(a, b)
    return js, ts


def _same_arrays(js, ts, indices):
    for i in indices:
        for get in ("get_image", "get_labels"):
            a, b = getattr(ts, get)(int(i)), getattr(js, get)(int(i))
            assert a.dtype == b.dtype, get
            np.testing.assert_array_equal(a, b, err_msg=f"{get}({i})")


@pytest.mark.parametrize("n_val, n_sup", [(-1, 100), (2, 10)])
def test_pascal_aug_split_matches_jax(configured, n_val, n_sup):
    """--dataset=pascal_aug --split_path=split_0.pkl: the SBD lists, the
    pickled 10,582-entry permutation, the sup/unsup/val/test indices and the
    decoded arrays."""
    args = ("pascal_aug", n_val, 131, n_sup, -1, 12345, SPLIT)
    jd, td = jdatasets.load_dataset(*args), datasets.load_dataset(*args)
    js, ts = _same_split(jd, td)
    assert len(ts.sample_names) == synthetic.SBD_TRAIN_AUG + 4
    assert len(td["sup_ndx"]) == n_sup
    assert len(td["unsup_ndx"]) == synthetic.SBD_TRAIN_AUG - max(n_val, 0)
    _same_arrays(js, ts, list(td["sup_ndx"][:4]) + list(td["val_ndx_tgt"]))


def test_converters_write_equal_zips(data_dir):
    """Both convert_cityscapes tools on the same raw zips: the same entries,
    decoding to equal arrays (the labels' majority vote included)."""
    with zipfile.ZipFile(data_dir["city"]) as t, zipfile.ZipFile(data_dir["city_jax"]) as j:
        assert sorted(t.namelist()) == sorted(j.namelist())
        assert len(t.namelist()) == 2 * 8
        for name in j.namelist():
            a = np.array(Image.open(io.BytesIO(t.read(name))))
            b = np.array(Image.open(io.BytesIO(j.read(name))))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("factor", [1, 2, 4])
@pytest.mark.parametrize("n_ids", [1, 3, 34])
def test_label_downsampling_matches_jax(n_ids, factor):
    y = np.random.RandomState(n_ids * 10 + factor).randint(0, n_ids, size=(32, 48)) \
        .astype(np.uint8)
    got, want = convert_cityscapes.downsample_label_img(y, factor), \
        jconv_city.downsample_label_img(y, factor)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("factor", [1, 2, 3])
@pytest.mark.parametrize("shape", [(33, 50, 3), (20, 31)], ids=["rgb", "grey"])
def test_image_downsampling_matches_jax(shape, factor):
    x = np.random.RandomState(factor).randint(0, 256, size=shape).astype(np.uint8)
    got, want = convert_cityscapes.downsample_image(x, factor), \
        jconv_city.downsample_image(x, factor)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_val", [-1, 2])
def test_cityscapes_source_matches_jax(configured, n_val):
    args = ("cityscapes", n_val, 131, 2, -1, 12345, None)
    jd, td = jdatasets.load_dataset(*args), datasets.load_dataset(*args)
    js, ts = _same_split(jd, td)
    assert ts.num_classes == 19 and ts.canvas_hw == (32, 64)
    _same_arrays(js, ts, range(len(ts.sample_names)))
    labels = np.stack([ts.get_labels(i) for i in range(len(ts.sample_names))])
    assert (labels == 255).any() and set(np.unique(labels)) <= set(range(19)) | {255}


@pytest.mark.parametrize("n_val", [-1, 2])
def test_camvid_source_matches_jax(configured, n_val):
    args = ("camvid", n_val, 131, 2, -1, 12345, None)
    jd, td = jdatasets.load_dataset(*args), datasets.load_dataset(*args)
    js, ts = _same_split(jd, td)
    assert len(ts.train_ndx) == 5 and len(ts.test_ndx) == 2
    assert len(ts.val_ndx) == (2 if n_val == 2 else 3)
    np.testing.assert_array_equal(ts.class_weights, js.class_weights)
    assert ts.class_names == js.class_names and ts.num_classes == 11
    _same_arrays(js, ts, range(len(ts.sample_names)))
    assert (np.stack([ts.get_labels(i) for i in ts.train_ndx]) == 255).any()


def _png(arr, fmt="PNG"):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt)
    return buf.getvalue()


def _write_isic_raw(d):
    """The four official ISIC-2017 zips, with a superpixel file the
    converter skips; images 30x40 (JPEG) and 0/255 masks."""
    rng = np.random.RandomState(0)
    for split, folder, n in (("Training", "Training", 4), ("Validation", "Validation", 2)):
        with zipfile.ZipFile(d / f"ISIC-2017_{split}_Data.zip", "w") as xz, \
                zipfile.ZipFile(d / f"ISIC-2017_{split}_Part1_GroundTruth.zip", "w") as yz:
            for i in range(n):
                name = f"ISIC_{split[0]}{i:06d}"
                img = rng.randint(0, 256, size=(30, 40, 3), dtype=np.uint8)
                xz.writestr(f"ISIC-2017_{folder}_Data/{name}.jpg", _png(img, "JPEG"))
                xz.writestr(f"ISIC-2017_{folder}_Data/{name}_superpixels.png", _png(img))
                mask = ((rng.rand(30, 40) > 0.5) * 255).astype(np.uint8)
                yz.writestr(f"ISIC-2017_{folder}_Part1_GroundTruth/{name}_segmentation.png",
                            _png(mask))


@pytest.mark.parametrize("out_size", [(24, 24), 20, None], ids=["hw", "min_side", "none"])
def test_convert_isic_matches_jax(tmp_path, out_size):
    _write_isic_raw(tmp_path)
    paths = {}
    for name, mod in (("port", convert_isic), ("jax", jconv_isic)):
        paths[name] = str(tmp_path / f"isic_{name}.zip")
        mod.convert_isic(str(tmp_path), paths[name], out_size)
    with zipfile.ZipFile(paths["port"]) as t, zipfile.ZipFile(paths["jax"]) as j:
        names = sorted(j.namelist())
        assert sorted(t.namelist()) == names and len(names) == 2 * 6 + 1
        for name in names:
            if name.endswith(".pkl"):
                a, b = pickle.loads(t.read(name)), pickle.loads(j.read(name))
                for k in ("rgb_mean", "rgb_std"):
                    np.testing.assert_array_equal(a[k], b[k])
            else:
                np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(t.read(name)))),
                                              np.array(Image.open(io.BytesIO(j.read(name)))))
    # the port's ISIC source reads its output
    src = sources.ISIC2017DataSource(-1, np.random.RandomState(0), None, zip_path=paths["port"])
    assert len(src.train_ndx) == 4 and len(src.val_ndx) == 2


def test_download_pascal_aug_names_from_dir(tmp_path, monkeypatch):
    """--from_dir installs the two lists under ImageSets/SegmentationAug of
    the configured pascal_voc root, as the JAX tool does (the other path
    fetches from the network and is not run)."""
    lists = tmp_path / "lists"
    lists.mkdir()
    (lists / "train_aug.txt").write_text("2007_000032\n2007_000039\n")
    (lists / "val.txt").write_text("2007_000033\n")
    out = {}
    for name, mod, tool in (("port", settings, download_pascal_aug_names),
                            ("jax", jsettings, jnames)):
        voc = tmp_path / name / "VOC2012"
        voc.mkdir(parents=True)
        monkeypatch.setenv("CUTMIX_SEG_CONFIG", synthetic.write_config(
            str(tmp_path / f"{name}.cfg"), str(voc)))
        monkeypatch.setattr(mod, "_config", None)
        res = CliRunner().invoke(tool.main, ["--from_dir", str(lists)])
        assert res.exit_code == 0, res.output
        out[name] = {f: (voc / "ImageSets" / "SegmentationAug" / f).read_text()
                     for f in ("train_aug.txt", "val.txt")}
        assert res.output.count("Copied ") == 2
    assert out["port"] == out["jax"]
    assert out["port"]["train_aug.txt"] == (lists / "train_aug.txt").read_text()


# the CutMix line of each recipe, tiny: name -> flags beside test_torch_trainer._params
RECIPE_LINES = {
    # run_pascal_aug_experiments.sh: PARAMS_PASCALAUG_DEEPLAB2I + REG_MASK_CUTMIX
    "pascal_aug": dict(dataset="pascal_aug", split_path=SPLIT, n_sup=8, batch_size=2,
                       crop_size="32,32", aug_scale_hung=True),
    # run_cityscapes_experiments.sh: PARAMS_CITYSCAPES_DEEPLAB2I (batch 4) +
    # AUG_CITYSCAPES (a crop of half the canvas, no scale) + REG_MASK_CUTMIX
    "cityscapes": dict(dataset="cityscapes", n_sup=2, batch_size=4, crop_size="16,32",
                       aug_scale_hung=False),
    "camvid": dict(dataset="camvid", n_sup=2, batch_size=2, crop_size="32,32",
                   aug_scale_hung=False),
}


@pytest.mark.parametrize("name", sorted(RECIPE_LINES))
def test_cutmix_trainer_on_recipe_dataset(configured, name, tmp_path):
    """The CutMix trainer with the dataset's own flags, a tiny DeepLab v2:
    one epoch of 2 iterations, eval over the val names, a checkpoint."""
    from tests.test_torch_trainer import _submit

    eng = _submit(tmp_path / "results", name, num_epochs=1, iters_per_epoch=2,
                  save_model=False, mask_prop_range="0.5", **RECIPE_LINES[name])
    log = (tmp_path / "results" / "test_torch_mask_mt" / name / f"log_{name}.txt").read_text()
    assert "Epoch 1:" in log and "VAL mIoU=" in log and eng.state.step == 2
    assert eng.n_classes == {"pascal_aug": 21, "cityscapes": 19, "camvid": 11}[name]
    if name == "pascal_aug":
        assert f"len(unsup_ndx)={synthetic.SBD_TRAIN_AUG}" in log and "len(val_ndx)=4" in log
        # 10,582 canvases of 48^2 fit in 1 GiB: auto stages them
        assert "Data on device: 10582 canvases" in log
