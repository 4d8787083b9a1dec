"""The port's analysis package (patch_dist and the three scripts built on it)
against cutmix_seg_tpu.analysis on the CPU.

The NumPy parts (boundary maps, patch extraction, anchor choice, the host
ranking) are bit-equal. The symmetric pad is exact. The float32 device parts
are held to JAX's float32 results within stated tolerances. A box sum is a
difference of integral-image entries, float32 prefix sums that both
frameworks accumulate in their own order, so it is held within
``SUM_EPS`` times the integral image's total S (the sum of the summed map).
A squared distance adds the cross term, p * q * C products of values in
[0, 1], so it is held within SUM_EPS * (S + p * q * C); a distance
d = sqrt(max(sqr, 0)) then moves by at most the square root of that near 0
and by that / (2 d) elsewhere, which ``_dist_close`` applies.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cutmix_seg_tpu.analysis import intra_inter_class_patch_dist as jstudy
from cutmix_seg_tpu.analysis import patch_dist as jpd
from cutmix_seg_tpu.analysis import plot_patch_distances as jplot
from cutmix_seg_tpu.ops import colour as jcolour
from cutmix_seg_tpu_torch.analysis import colour_aug_study as tcolour_study
from cutmix_seg_tpu_torch.analysis import input_distribution_study as tinput
from cutmix_seg_tpu_torch.analysis import intra_inter_class_patch_dist as tstudy
from cutmix_seg_tpu_torch.analysis import patch_dist as tpd
from cutmix_seg_tpu_torch.analysis import plot_patch_distances as tplot
from cutmix_seg_tpu_torch.ops import colour as tcolour
from tests.test_torch_aug import jax_colour_params

torch.set_num_threads(1)

SUM_EPS = 4 * float(np.finfo(np.float32).eps)
PATCHES = [(3, 3), (5, 5), (7, 7), (5, 7), (4, 6)]  # odd, non-square, even


def _dist_close(got, want, sqr_tol, what=""):
    tol = sqr_tol
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = np.minimum(np.sqrt(tol), tol / np.maximum(2 * want, 1e-30))
    assert (np.abs(got - want) <= bound + 1e-7).all(), (what, np.abs(got - want).max())


def _labels(rng, h, w, n_cls=4, block=5):
    lab = np.kron(rng.randint(0, n_cls, size=(-(-h // block), -(-w // block))),
                  np.ones((block, block), np.int64))[:h, :w].astype(np.int32)
    lab[rng.rand(h, w) < 0.03] = 255
    return lab


class TinySet:
    """A dataset source of a few random uint8 images with block labels."""

    def __init__(self, n=4, seed=0, sizes=((26, 30), (29, 25), (24, 24), (31, 27))):
        rng = np.random.RandomState(seed)
        self.images = [rng.randint(0, 256, size=sizes[i % len(sizes)] + (3,), dtype=np.uint8)
                       for i in range(n)]
        self.labels = [_labels(rng, *sizes[i % len(sizes)]) for i in range(n)]
        self.train_ndx = np.arange(n)

    def get_image(self, i):
        return self.images[i]

    def get_labels(self, i):
        return self.labels[i]


def test_boundaries_and_patches_bit_equal():
    ds = TinySet()
    for y, x in zip(ds.labels, ds.images):
        for g, w in zip(tpd.neighbouring_pixels_class_change(y),
                        jpd.neighbouring_pixels_class_change(y)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tpd.boundary_pixels(y), jpd.boundary_pixels(y))
        for hw in PATCHES:
            np.testing.assert_array_equal(tpd.extract_patch(x, hw, (12, 11)),
                                          jpd.extract_patch(x, hw, (12, 11)))


@pytest.mark.parametrize("n", [1, 2, 5, 9])
def test_symmetric_pad_exact(n):
    x = np.random.RandomState(n).rand(n, n + 1, 3).astype(np.float32)
    for pads in [(0, 0), (1, 1), (2, 3), (n, n + 2), (2 * n + 1, 1)]:
        want = np.asarray(jnp.pad(jnp.asarray(x), [pads, pads[::-1], (0, 0)], mode="symmetric"))
        np.testing.assert_array_equal(want, np.pad(x, [pads, pads[::-1], (0, 0)],
                                                   mode="symmetric"))
        got = tpd.symmetric_pad(torch.from_numpy(x), [pads, pads[::-1]]).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("box", [(1, 1), (3, 3), (5, 7), (4, 2)])
def test_box_sum_matches_jax(box):
    x = np.random.RandomState(1).rand(23, 31).astype(np.float32)
    got = tpd.box_sum(torch.from_numpy(x), box).numpy()
    want = np.asarray(jpd.box_sum(jnp.asarray(x), box))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=SUM_EPS * x.sum())


@pytest.mark.parametrize("patch", PATCHES)
def test_neighbour_distance_maps_match_jax(patch):
    """The float64 input is rounded to float32 on both sides."""
    x = np.random.RandomState(2).rand(21, 26, 3)
    got = tpd.neighbouring_patch_distance_maps(tpd.as_f32(x, "cpu"), patch)
    want = jpd.neighbouring_patch_distance_maps(jnp.asarray(x), patch)
    pad = (np.asarray(patch) - 1) // 2 + 1
    padded = np.pad(x, [(pad[0], pad[0]), (pad[1], pad[1]), (0, 0)], mode="symmetric")
    # the largest integral-image total of the four squared-difference maps
    total = max((np.diff(padded, axis=a) ** 2).sum() for a in (0, 1))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _dist_close(g.numpy(), np.asarray(w), SUM_EPS * total, patch)
    avg = tpd.patch_average_distance_map(x, patch, "cpu")
    _dist_close(avg.numpy(), np.asarray(jpd.patch_average_distance_map(x, patch)),
                SUM_EPS * total)


def _sliding_tol(image, patch):
    pad = (np.asarray(patch) - 1) // 2
    padded = np.pad(image, [(pad[0], pad[0]), (pad[1], pad[1]), (0, 0)], mode="symmetric")
    return SUM_EPS * ((padded ** 2).sum() + patch[0] * patch[1] * image.shape[2])


@pytest.mark.parametrize("patch", PATCHES)
def test_sliding_distances_match_jax(patch):
    rng = np.random.RandomState(3)
    image = rng.randint(0, 256, size=(19, 23, 3)).astype(np.float64) / 255.0
    if patch[0] % 2 and patch[1] % 2:  # windows of the image itself: near-zero distances
        patches = np.stack([tpd.extract_patch(image, patch, (9, 11)),
                            rng.rand(*patch, 3), tpd.extract_patch(image, patch, (5, 6))])
    else:  # an even side: extract_patch gives odd sides
        patches = rng.rand(3, *patch, 3)
    got = tpd.sliding_window_distance_to_patches(image, patches, "cpu")
    want = jpd.sliding_window_distance_to_patches(image, patches)
    assert got.dtype == np.float32 and got.shape == want.shape == (3,) + got.shape[1:]
    _dist_close(got, want, _sliding_tol(image, patch), patch)
    one = tpd.sliding_window_distance_to_patch(image, patches[1], "cpu")
    _dist_close(one, want[1], _sliding_tol(image, patch))


def test_sliding_distances_do_not_depend_on_the_chunk():
    """Chunking the patches changes only the convolution's own rounding
    (the backend blocks its sums by the number of output channels)."""
    rng = np.random.RandomState(4)
    image = rng.rand(20, 22, 3).astype(np.float32)
    patches = torch.from_numpy(rng.rand(7, 5, 5, 3).astype(np.float32))
    whole = tpd._sliding_distances(torch.from_numpy(image), patches)
    for chunk in (1, 3):
        _dist_close(tpd._sliding_distances(torch.from_numpy(image), patches, chunk=chunk).numpy(),
                    whole.numpy(), SUM_EPS * ((image ** 2).sum() + 75), chunk)


@pytest.mark.parametrize("patch", [(5, 5), (5, 7)])
def test_class_distances_match_jax(patch):
    """Anchors, patches and rankings on a tiny random set: coordinates and
    anchor rows equal, distances within the float32 tolerance."""
    ds = TinySet()
    ids = tstudy.choose_anchors_and_negatives(ds, ds.train_ndx, 6, patch,
                                              np.random.RandomState(7))
    want_ids = jstudy.choose_anchors_and_negatives(ds, ds.train_ndx, 6, patch,
                                                   np.random.RandomState(7))
    np.testing.assert_array_equal(ids, want_ids)
    anchors, negatives = tstudy.extract_anchor_and_negative_patches(ds, ids, patch)
    j_anchors, j_negatives = jstudy.extract_anchor_and_negative_patches(ds, ids, patch)
    np.testing.assert_array_equal(anchors, j_anchors)
    np.testing.assert_array_equal(negatives, j_negatives)

    got = tstudy.class_distances(ds, ids, anchors, 20, "cpu")
    want = jstudy.class_distances(ds, ids, anchors, 20)
    assert set(got) == set(want)
    tol = max(_sliding_tol(ds.get_image(i) / 255.0, patch) for i in ds.train_ndx)
    for key in want:
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            if key.endswith("coords"):
                np.testing.assert_array_equal(g, w, err_msg=f"{key} {i}")
            else:
                assert g.shape == w.shape
                _dist_close(g, w, tol, (key, i))
    # each anchor's own centre is its nearest same-image intra-class window
    for i, row in enumerate(ids):
        np.testing.assert_array_equal(got["same_image_intra_class_coords"][i][0], row[[0, 2, 3]])


def test_anchor_off_the_boundary_raises():
    ds = TinySet()
    row = tstudy.choose_anchors_and_negatives(ds, ds.train_ndx, 1, (5, 5),
                                              np.random.RandomState(0))[0].copy()
    row[4] = (row[4] + 1) % 4
    with pytest.raises(ValueError, match="class boundary"):
        tstudy.extract_anchor_and_negative_patches(ds, row[None], (5, 5))


def test_boundary_ratios_match_jax():
    """The input-distribution study's statistic against the JAX script's
    arithmetic on the JAX patch_average_distance_map."""
    ds = TinySet(n=6, seed=3)
    picks = tinput.pick_images(ds, 4, 12345)
    np.testing.assert_array_equal(
        picks, np.random.RandomState(12345).choice(ds.train_ndx, size=4, replace=False))
    ratios = tinput.boundary_ratios(ds, picks, 5, "cpu")
    for idx, ratio in zip(picks, ratios):
        img = ds.get_image(int(idx)).astype(np.float64) / 255.0
        y = ds.get_labels(int(idx))
        boundary = jpd.boundary_pixels(y)
        avg_d = np.asarray(jpd.patch_average_distance_map(img, (5, 5)))
        want = avg_d[boundary].mean() / avg_d[(~boundary) & (y != 255)].mean()
        np.testing.assert_allclose(ratio, want, rtol=1e-5)
    _, boundary, avg_d, _ = tinput.image_stats(ds, picks[0], 5, "cpu")
    assert avg_d.shape == boundary.shape and avg_d.dtype == np.float32


def test_colour_variants_match_jax():
    """Jittered variants with JAX's draws injected, against JAX's
    colour_jitter image by image, and the histograms of the figure."""
    ds = TinySet(n=5, seed=2)
    originals = tcolour_study.load_originals(ds, 3, 0)
    picks = np.random.RandomState(0).choice(ds.train_ndx, size=3, replace=False)
    for img, idx in zip(originals, picks):
        full = ds.get_image(int(idx)).astype(np.float32) / 255.0
        np.testing.assert_array_equal(img, full[:(full.shape[0] // 8) * 8,
                                                :(full.shape[1] // 8) * 8])
    cfg = tcolour_study.study_config()
    jcfg = jcolour.ColourJitterConfig(apply_prob=1.0, greyscale_prob=0.2)
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    key = jax.random.PRNGKey(0)
    params, want = [], []
    for img in originals:
        per_image = []
        for _ in range(4):
            key, k = jax.random.split(key)
            per_image.append(jax_colour_params(k, 1, jcfg))
            want.append(np.asarray(jcolour.colour_jitter(jnp.asarray(img[None]), k, jcfg)[0]))
        params.append(tcolour.ColourParams(*[torch.cat([getattr(p, f) for p in per_image])
                                             for f in ("fb", "fc", "fs", "fh", "order",
                                                       "apply", "to_grey")]))
    got = tcolour_study.jittered_variants(originals, 4, cfg, torch.Generator(), params=params)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    hists = tcolour_study.channel_histograms(originals, got)
    for c, name in enumerate("RGB"):
        (oc, oe), (ac, ae) = hists[name]
        want_o = np.histogram(np.concatenate([o.reshape(-1, 3) for o in originals])[:, c],
                              bins=50, density=True)
        np.testing.assert_array_equal(oc, want_o[0])
        np.testing.assert_array_equal(oe, want_o[1])
        assert ac.shape == (50,) and np.isclose((ac * np.diff(ae)).sum(), 1.0)
    drawn = tcolour_study.jittered_variants(originals, 4, cfg, torch.Generator().manual_seed(0))
    assert all(np.isfinite(d).all() and d.min() >= 0 and d.max() <= 1 for d in drawn)


def _fake_results(seed, n):
    rng = np.random.RandomState(seed)

    def lists(empty_some):
        return [None if empty_some and i == 1 else np.sort(rng.rand(rng.randint(3, 15)))
                for i in range(n)]

    return {"same_image_intra_class_dists": lists(True),
            "same_image_inter_class_dists": lists(False),
            "other_image_intra_class_dists": lists(False),
            "other_image_inter_class_dists": lists(False),
            "boundary_dists": rng.rand(n),
            "anchor_negative_img_dir_y_x_cls": rng.randint(0, 9, size=(n, 5))}


def test_plot_statistics_match_jax(tmp_path):
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"res_{i}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(_fake_results(i, 4 + i), f)
    got, want = tplot.load_results(paths), jplot.load_results(paths)
    assert set(got) == set(want)
    for k in ("boundary_dists", "anchor_negative_img_dir_y_x_cls"):
        np.testing.assert_array_equal(got[k], want[k])
    summary = tplot.distance_summary(got, 5)
    res = jplot.load_results(paths)
    for name in ("same_image_intra", "same_image_inter", "other_image_intra",
                 "other_image_inter"):
        want_k = np.array([d[:5].mean() if d is not None and len(d) else np.nan
                           for d in res[f"{name}_class_dists"]])
        np.testing.assert_array_equal(summary[name], want_k)
    assert summary["frac_boundary_farther"] == np.nanmean(
        res["boundary_dists"] > summary["same_image_intra"])
    out = CliRunner().invoke(tplot.main, [str(tmp_path / "res_*.pkl"), str(tmp_path / "f.png"),
                                          "--k_nearest", "5"])
    assert out.exit_code == 0, out.output
    assert f"{summary['frac_boundary_farther']:.3f}" in out.output
    assert os.path.getsize(tmp_path / "f.png") > 0


@pytest.fixture
def data_cfg(tmp_path, monkeypatch):
    """A tiny synthetic VOC tree and CamVid zip named through a temporary
    config (the VOC tree's blocks are apart by a 255 band: it has no class
    boundary, so the patch studies run on CamVid)."""
    from cutmix_seg_tpu_torch.data import settings
    from cutmix_seg_tpu_torch.data.synthetic import write_camvid_zip, write_config, write_voc_tree

    root = write_voc_tree(str(tmp_path / "VOC2012"), 4, 2, size_range=(40, 56), seed=0)
    camvid = write_camvid_zip(str(tmp_path / "camvid.zip"), 3, 1, 1, size=(36, 48), seed=0)
    monkeypatch.setenv("CUTMIX_SEG_CONFIG", write_config(str(tmp_path / "seg.cfg"), root,
                                                         camvid_zip=camvid))
    monkeypatch.setattr(settings, "_config", None)
    return tmp_path


def test_study_clis_on_cpu(data_cfg):
    """The three device scripts end to end on tiny synthetic sets: the
    pickle's keys are the JAX tool's; the figures are written."""
    voc_cfg = data_cfg
    out_pkl = str(voc_cfg / "dists.pkl")
    res = CliRunner().invoke(tstudy.main, [out_pkl, "--dataset", "camvid", "--patch_size", "9",
                                           "--n_patches", "3", "--n_neighbours", "5",
                                           "--device", "cpu"])
    assert res.exit_code == 0, res.output
    with open(out_pkl, "rb") as f:
        got = pickle.load(f)
    assert set(got) == {f"{w}_image_{c}_class_{k}" for w in ("same", "other")
                        for c in ("intra", "inter") for k in ("dists", "coords")} | {
        "anchor_negative_img_dir_y_x_cls", "boundary_dists"}
    assert got["anchor_negative_img_dir_y_x_cls"].shape == (3, 5)
    res = CliRunner().invoke(tinput.main, [str(voc_cfg / "input"), "--dataset", "camvid",
                                           "--n_images", "2", "--patch_size", "5",
                                           "--device", "cpu"])
    assert res.exit_code == 0, res.output
    assert sorted(os.listdir(voc_cfg / "input")) == ["input_dist_00.png", "input_dist_01.png"]
    res = CliRunner().invoke(tcolour_study.main, [str(voc_cfg / "colour"), "--dataset", "pascal",
                                                  "--n_images", "2", "--n_variants", "2",
                                                  "--device", "cpu"])
    assert res.exit_code == 0, res.output
    assert sorted(os.listdir(voc_cfg / "colour")) == ["colour_aug_grid.png",
                                                      "colour_aug_histograms.png"]
