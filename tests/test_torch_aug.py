"""The port's device augmentation (aug/device.py) and colour jitter
(ops/colour.py) against the JAX package on the CPU.

Tolerances: labels are bit-equal (the nearest tap is an integer choice).
Source coordinates agree to a few float32 ulps (the two sides may contract
their multiply-adds into FMAs differently); a bilinear crop moves by that
times the step between neighbouring pixels, up to 255, so crops on the 0-255
scale agree within 2e-3 (8e-6 of the scale) and normalised images within
5e-5. A valid mask moves by the coordinate's own error (coverage changes by 1
per pixel of coordinate): within 1e-5. Colour-jittered images in [0, 1]
agree within 2e-6.

The JAX side's colour-jittered crop is JAX's ``colour_jitter`` run on JAX's
crop, not the output of its fused ``augment_batch``: on the CPU, XLA's fused
program of the warp and the jitter differs from the two functions run one
after the other, by up to 0.48 on one image of four here (its hue op tests
``maxc == r`` on values that fusion recomputes). The port runs the ops one
after the other, so it is held to that.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.aug import device as jdev
from cutmix_seg_tpu.aug.params import GeomConfig, sample_geom_single
from cutmix_seg_tpu.ops import colour as jcolour
from cutmix_seg_tpu_torch.aug import device as tdev
from cutmix_seg_tpu_torch.ops import colour as tcolour

torch.set_num_threads(1)

CANVAS, CROP = (40, 44), (24, 28)
CROP_ATOL, VALID_ATOL, NORM_ATOL, COLOUR_ATOL = 2e-3, 1e-5, 5e-5, 2e-6
MEAN, STD = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])

GEOMS = {
    "crop": GeomConfig(CROP, mode="crop", hflip=True),
    "crop_scale_hung": GeomConfig(CROP, mode="crop_scale_hung", hflip=True),
    "crop_rotate_scale": GeomConfig(CROP, mode="crop_rotate_scale", rot_mag_deg=30.0,
                                    max_scale=1.5, hflip=True, vflip=True, hvflip=True),
}


def host_batch(geom, n, seed, mixed_interp=True):
    """Canvases (images at the origin, zeros beyond), 255-filled label
    canvases, matrices from the JAX package's samplers, true sizes, interp."""
    rng = np.random.RandomState(seed)
    canvas = np.zeros((n, *CANVAS, 3), np.uint8)
    labels = np.full((n, *CANVAS), 255, np.uint8)
    sizes = np.zeros((n, 2), np.int32)
    ms = np.zeros((n, 2, 3), np.float32)
    interp = np.zeros((n,), np.int32)
    for k in range(n):
        h, w = rng.randint(12, CANVAS[0] + 1), rng.randint(12, CANVAS[1] + 1)
        canvas[k, :h, :w] = rng.randint(0, 256, size=(h, w, 3))
        labels[k, :h, :w] = rng.randint(0, 21, size=(h, w))
        sizes[k] = (h, w)
        ms[k], interp[k] = sample_geom_single(geom, (h, w), rng, has_labels=False)
    if mixed_interp:
        interp = (np.arange(n) % 2).astype(np.int32)
    return dict(canvas=canvas, labels=labels, m=ms, sizes=sizes, interp=interp)


def t(x):
    return torch.from_numpy(np.array(x))


def jax_colour_params(key, n, cfg):
    """The draws ``colour_jitter`` makes from ``key``, as the port's
    ColourParams (reproduced with jax.random in the JAX function's order)."""
    keys = jax.random.split(key, 7)

    def factor(k, f):
        return jax.random.uniform(k, (n, 1, 1, 1), minval=max(0.0, 1.0 - f), maxval=1.0 + f)

    fh = jax.random.uniform(keys[3], (n, 1, 1), minval=-cfg.hue, maxval=cfg.hue)
    order = jax.vmap(lambda k: jax.random.permutation(k, 4))(jax.random.split(keys[4], n))
    apply = jax.random.uniform(keys[5], (n, 1, 1, 1)) < cfg.apply_prob
    to_grey = jax.random.uniform(keys[6], (n, 1, 1, 1)) < cfg.greyscale_prob
    flat = lambda a: t(np.asarray(a).reshape(n))  # noqa: E731
    return tcolour.ColourParams(
        fb=flat(factor(keys[0], cfg.brightness)), fc=flat(factor(keys[1], cfg.contrast)),
        fs=flat(factor(keys[2], cfg.saturation)), fh=flat(fh),
        order=t(np.asarray(order)).long(), apply=flat(apply), to_grey=flat(to_grey))


@pytest.mark.parametrize("border", ["constant", "reflect101"])
@pytest.mark.parametrize("mode", ["crop_rotate_scale", "crop_scale_hung"])
def test_gather_warp_matches_jax(mode, border):
    b = host_batch(GEOMS[mode], 6, seed=1)
    jc, jv = jdev.warp_image_canvas(jnp.asarray(b["canvas"]), jnp.asarray(b["m"]),
                                    jnp.asarray(b["sizes"]), jnp.asarray(b["interp"]),
                                    out_hw=CROP, border=border)
    tc, tv = tdev.warp_image_canvas(t(b["canvas"]), t(b["m"]), t(b["sizes"]),
                                    t(b["interp"]), CROP, border)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=CROP_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=VALID_ATOL)
    jl = jdev.warp_labels_canvas(jnp.asarray(b["labels"]), jnp.asarray(b["m"]),
                                 jnp.asarray(b["sizes"]), out_hw=CROP)
    tl = tdev.warp_labels_canvas(t(b["labels"]), t(b["m"]), t(b["sizes"]), CROP)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tl.numpy() == 255).any() and (tl.numpy() < 21).any()


@pytest.mark.parametrize("mode", ["crop", "crop_scale_hung"])
def test_separable_warp_matches_jax(mode):
    geom = GeomConfig(CROP, mode=mode, hflip=True)  # diagonal matrices
    b = host_batch(geom, 6, seed=2, mixed_interp=False)
    jc, jv = jdev.warp_image_canvas_separable(jnp.asarray(b["canvas"]), jnp.asarray(b["m"]),
                                              jnp.asarray(b["sizes"]), out_hw=CROP)
    tc, tv = tdev.warp_image_canvas_separable(t(b["canvas"]), t(b["m"]), t(b["sizes"]), CROP)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=CROP_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=VALID_ATOL)
    jl = jdev.warp_labels_canvas_separable(jnp.asarray(b["labels"]), jnp.asarray(b["m"]),
                                           jnp.asarray(b["sizes"]), out_hw=CROP)
    tl = tdev.warp_labels_canvas_separable(t(b["labels"]), t(b["m"]), t(b["sizes"]), CROP)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    # and the two paths of the port agree with each other on labels
    tg = tdev.warp_labels_canvas(t(b["labels"]), t(b["m"]), t(b["sizes"]), CROP)
    np.testing.assert_array_equal(tl.numpy(), tg.numpy())


def test_round_half_up_bias_decides_half_integer_taps():
    c = torch.tensor([0.5, 1.5, 2.5 - 2 ** -22, 10.5, -0.5], dtype=torch.float32)
    j = jdev._round_half_up(jnp.asarray(c.numpy()), 512)
    np.testing.assert_array_equal(tdev._round_half_up(c, 512).numpy(), np.asarray(j))
    np.testing.assert_array_equal(tdev._round_half_up(c, 512).numpy(), [1, 2, 3, 11, 0])


def test_normalise_matches_jax():
    rng = np.random.RandomState(3)
    img = rng.uniform(0, 255, size=(2, 5, 6, 3)).astype(np.float32)
    valid = rng.uniform(0, 1, size=(2, 5, 6, 1)).astype(np.float32)
    j = jdev.normalise(jnp.asarray(img), jnp.asarray(valid), MEAN, STD)
    np.testing.assert_allclose(tdev.normalise(t(img), t(valid), MEAN, STD).numpy(),
                               np.asarray(j), rtol=0, atol=NORM_ATOL)


@pytest.mark.parametrize("case", ["gather_reflect_colour", "gather_constant_labels",
                                  "separable_colour_labels"])
def test_augment_batch_matches_jax(case):
    mode = "crop_rotate_scale" if case.startswith("gather") else "crop_scale_hung"
    border = "reflect101" if case == "gather_reflect_colour" else "constant"
    separable = case.startswith("separable")
    with_labels = case.endswith("labels")
    geom = GEOMS[mode] if not separable else GeomConfig(CROP, mode=mode, hflip=True)
    b = host_batch(geom, 4, seed=4, mixed_interp=not separable)
    cfg = jcolour.ColourJitterConfig() if "colour" in case else None
    key = jax.random.PRNGKey(7)
    j = jdev.augment_batch(
        jnp.asarray(b["canvas"]), jnp.asarray(b["labels"]), jnp.asarray(b["m"]),
        jnp.asarray(b["sizes"]), jnp.asarray(b["interp"]), MEAN, STD, key,
        out_hw=CROP, with_labels=with_labels, colour_cfg=cfg, border=border,
        separable=separable)
    params = None
    if cfg is not None:
        params = jax_colour_params(key, 4, cfg)
        # JAX's functions one after the other (see the module docstring)
        if separable:
            crop, _ = jdev.warp_image_canvas_separable(
                jnp.asarray(b["canvas"]), jnp.asarray(b["m"]), jnp.asarray(b["sizes"]),
                out_hw=CROP)
        else:
            crop, _ = jdev.warp_image_canvas(
                jnp.asarray(b["canvas"]), jnp.asarray(b["m"]), jnp.asarray(b["sizes"]),
                jnp.asarray(b["interp"]), out_hw=CROP, border=border)
        stu = np.asarray(jcolour.colour_jitter(crop / 255.0, key, cfg))
        alpha = np.asarray(j["mask"]) if border == "constant" else 1.0
        j = dict(j, image_stu=(stu - np.float32(MEAN) * alpha) / np.float32(STD))
    o = tdev.augment_batch(
        t(b["canvas"]), t(b["labels"]), t(b["m"]), t(b["sizes"]), t(b["interp"]),
        MEAN, STD, params, CROP, with_labels, border=border, separable=separable)
    assert sorted(o) == sorted(j)
    for k in ("image", "image_stu"):
        if k in j:
            np.testing.assert_allclose(o[k].numpy(), np.asarray(j[k]), rtol=0, atol=NORM_ATOL)
    np.testing.assert_allclose(o["mask"].numpy(), np.asarray(j["mask"]), rtol=0,
                               atol=VALID_ATOL)
    if with_labels:
        np.testing.assert_array_equal(o["labels"].numpy(), np.asarray(j["labels"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_colour_jitter_matches_jax(seed):
    """Fed the draws JAX's colour_jitter makes from its key, the port's
    apply_colour_jitter gives JAX's output."""
    n = 16
    img = np.random.RandomState(seed).uniform(0, 1, size=(n, 9, 11, 3)).astype(np.float32)
    img[0] = 0.5  # a grey image: zero saturation, hue undefined
    cfg = jcolour.ColourJitterConfig(brightness=0.5, contrast=0.5, saturation=0.5,
                                     hue=0.3, apply_prob=0.8, greyscale_prob=0.3)
    key = jax.random.PRNGKey(seed)
    j = jcolour.colour_jitter(jnp.asarray(img), key, cfg)
    params = jax_colour_params(key, n, cfg)
    assert bool(params.apply.any()) and bool(params.to_grey.any())
    out = tcolour.apply_colour_jitter(t(img), params)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), rtol=0, atol=COLOUR_ATOL)


def test_sample_colour_params_distribution():
    cfg = tcolour.ColourJitterConfig(brightness=0.4, contrast=0.2, saturation=1.5,
                                     hue=0.1, apply_prob=0.8, greyscale_prob=0.2)
    n = 4000
    p = tcolour.sample_colour_params(torch.Generator().manual_seed(0), n, cfg)
    for f, lo, hi in ((p.fb, 0.6, 1.4), (p.fc, 0.8, 1.2), (p.fs, 0.0, 2.5), (p.fh, -0.1, 0.1)):
        assert f.shape == (n,) and f.dtype == torch.float32
        assert float(f.min()) >= lo and float(f.max()) <= hi
        assert float(f.min()) < lo + 0.02 * (hi - lo) and float(f.max()) > hi - 0.02 * (hi - lo)
    assert torch.equal(p.order.sort(dim=1).values, torch.arange(4).expand(n, 4))
    perms = {tuple(r) for r in p.order.tolist()}
    assert len(perms) == 24  # every order of the four ops occurs
    assert abs(p.apply.float().mean().item() - 0.8) < 0.03
    assert abs(p.to_grey.float().mean().item() - 0.2) < 0.03
    # the same generator state gives the same draws
    q = tcolour.sample_colour_params(torch.Generator().manual_seed(0), n, cfg)
    assert torch.equal(p.fb, q.fb) and torch.equal(p.order, q.order)
