"""The port's ``ops/resample.py::grid_sample_affine`` against the JAX
function on the CPU: bilinear and nearest, random affine thetas whose taps
fall outside the image.

The reference is the jitted JAX function, as the aug_mt step runs it. The
port's output grid is bit-equal to its ``linspace``, and the port runs the
JAX function's operations one by one; XLA's fused program still rounds the
source coordinates differently in some pixels (by one ulp of the image's
width, up to 3.8e-6 at 56 px). A bilinear value then moves by that error
times the step between neighbouring pixels, up to 2.1e-5 on these randn
images, so the bilinear comparison allows 4 ulps of the width times the
largest step; nearest taps agree exactly."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.ops.resample import grid_sample_affine as j_grid_sample
from cutmix_seg_tpu_torch.ops.resample import _grid_linspace, grid_sample_affine

torch.set_num_threads(1)


def _coord_tol(img):
    """4 ulps of the largest source coordinate, times the largest step
    between neighbouring pixels of ``img`` (N, H, W, C)."""
    ulp = np.spacing(np.float32(max(img.shape[1:3])))
    step = max(np.abs(np.diff(img, axis=1)).max(), np.abs(np.diff(img, axis=2)).max())
    return float(4 * ulp * step)


def _thetas(rng, n):
    """Rotation by up to 0.5 rad, scale 0.7-1.4, shift up to 0.4 of the
    half-width: a share of every sample's taps lies outside the image."""
    ang = rng.uniform(-0.5, 0.5, n)
    sc = rng.uniform(0.7, 1.4, (n, 2))
    t = rng.uniform(-0.4, 0.4, (n, 2))
    th = np.zeros((n, 2, 3), np.float32)
    th[:, 0, 0], th[:, 0, 1] = sc[:, 0] * np.cos(ang), -sc[:, 0] * np.sin(ang)
    th[:, 1, 0], th[:, 1, 1] = sc[:, 1] * np.sin(ang), sc[:, 1] * np.cos(ang)
    th[:, :, 2] = t
    return th


@pytest.mark.parametrize("n", [1, 2, 33, 64, 250, 321])
def test_grid_is_jitted_jax_linspace(n):
    want = np.asarray(jax.jit(lambda: jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32))())
    np.testing.assert_array_equal(_grid_linspace(n, "cpu").numpy(), want)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("shape, out_hw", [((3, 33, 33, 4), (33, 33)),
                                           ((2, 40, 56, 21), (48, 36))])
def test_grid_sample_affine_matches_jax(mode, shape, out_hw):
    rng = np.random.RandomState(len(mode) + shape[1])
    img = rng.randn(*shape).astype(np.float32)
    theta = _thetas(rng, shape[0])
    want = np.asarray(j_grid_sample(jnp.asarray(img), jnp.asarray(theta), out_hw, mode))
    got = grid_sample_affine(torch.from_numpy(img), torch.from_numpy(theta), out_hw, mode)
    assert got.shape == (shape[0],) + out_hw + (shape[3],) and got.dtype == torch.float32
    # taps outside the image read 0: each case has some
    assert (want == 0).mean() > 0.02
    if mode == "bilinear":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_coord_tol(img))
    else:  # no coordinate of these thetas lies within rounding of a half pixel
        np.testing.assert_array_equal(got.numpy(), want)


def test_nearest_rounds_half_up_at_half_pixels():
    """A shift of half a pixel puts every source coordinate on a
    half-integer: floor(x + 0.5) takes the right-hand tap (torch's
    grid_sample rounds half to even and takes every other one)."""
    w = 9
    img = np.arange(w, dtype=np.float32).reshape(1, 1, w, 1).repeat(3, axis=1)
    theta = np.array([[[1.0, 0.0, 1.0 / (w - 1)], [0.0, 1.0, 0.0]]], np.float32)
    want = np.asarray(j_grid_sample(jnp.asarray(img), jnp.asarray(theta), (3, w), "nearest"))
    got = grid_sample_affine(torch.from_numpy(img), torch.from_numpy(theta), (3, w), "nearest")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0, 0, :, 0].numpy(), [1, 2, 3, 4, 5, 6, 7, 8, 0])


def test_identity_theta_is_the_identity():
    img = np.random.RandomState(0).randn(2, 17, 23, 3).astype(np.float32)
    theta = np.tile(np.eye(2, 3, dtype=np.float32), (2, 1, 1))
    for mode, atol in (("bilinear", _coord_tol(img)), ("nearest", 0.0)):
        got = grid_sample_affine(torch.from_numpy(img), torch.from_numpy(theta), (17, 23), mode)
        np.testing.assert_allclose(got.numpy(), img, rtol=0, atol=atol)


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        grid_sample_affine(torch.zeros(1, 2, 2, 1), torch.zeros(1, 2, 3), (2, 2), "cubic")
