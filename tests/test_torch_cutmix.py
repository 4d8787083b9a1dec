"""The port's CutMix masks and blend against the JAX package on the CPU.

The port's ``cutmix_blend`` on CPU tensors is the plain version of its CUDA
kernel; it is held bit-equal to the JAX Pallas kernel (interpret mode) and to
the JAX ``rasterise_masks`` on the cases of tests/test_pallas_cutmix.py plus
outside-bounds rects with negative coordinates, three fixed-aspect boxes, and
the kernel's edge cases: inputs at a storage offset (not 16-byte aligned),
element counts that end in a partial vector with vectors across sample
boundaries, 21 channels, and a batch of 70,000 images. Masks are 0/1 and the
blend multiplies by exactly 0 or 1, so equality is exact, not a tolerance."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.masks import box_mask as jbox
from cutmix_seg_tpu.ops.pallas_cutmix import cutmix_blend as jax_cutmix_blend
from cutmix_seg_tpu_torch.masks import box_mask as tbox
from cutmix_seg_tpu_torch.ops import cutmix as tcutmix
from cutmix_seg_tpu_torch.ops.cutmix import cutmix_blend

torch.set_num_threads(1)

# (n, h, w, c, box config, rect source, dtype, storage offset of x0 and x1)
CASES = {
    "two_boxes_64": (4, 64, 64, 3, dict(prop_range=(0.25, 0.75), n_boxes=2), "jax", np.float32, 0),
    "two_boxes_64_bf16": (4, 64, 64, 3, dict(prop_range=(0.25, 0.75), n_boxes=2), "jax", "bf16", 0),
    "odd_height_no_invert": (2, 33, 48, 1, dict(prop_range=(0.5, 0.5), invert=False), "jax", np.float32, 0),
    "outside_bounds": (6, 40, 52, 3, dict(prop_range=(0.3, 0.9), n_boxes=2, within_bounds=False), "np", np.float32, 0),
    "three_boxes_fixed_aspect": (3, 48, 40, 3, dict(prop_range=(0.4, 0.8), n_boxes=3, random_aspect_ratio=False), "jax", np.float32, 0),
    "offset_view": (4, 32, 40, 3, dict(prop_range=(0.5, 0.5)), "jax", np.float32, 1),
    # 2907 elements (not a multiple of 4 or 8); H*W*C odd, so vectors cross samples
    "tail_and_straddle": (3, 17, 19, 3, dict(prop_range=(0.5, 0.5)), "jax", np.float32, 0),
    "tail_and_straddle_bf16": (3, 17, 19, 3, dict(prop_range=(0.5, 0.5)), "jax", "bf16", 0),
    "c21_bf16": (2, 41, 41, 21, dict(prop_range=(0.5, 0.5)), "jax", "bf16", 0),
}


def _at_offset(a: np.ndarray, dtype: torch.dtype, offset: int) -> torch.Tensor:
    """`a` as a contiguous tensor starting `offset` elements into its storage."""
    buf = torch.zeros(offset + a.size, dtype=dtype)
    buf[offset:] = torch.from_numpy(a).reshape(-1).to(dtype)
    return buf[offset:].view(a.shape)


def _rects(n, h, w, cfg_kw, source, seed):
    cfg = jbox.BoxMaskConfig(**cfg_kw)
    if source == "jax":
        return np.array(jbox.sample_box_rects(cfg, jax.random.PRNGKey(seed), n, (h, w)))
    return jbox.sample_box_rects_np(cfg, n, (h, w), np.random.RandomState(seed))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cutmix_blend_plain_bit_equal_to_jax(case):
    n, h, w, c, cfg_kw, source, dtype, offset = CASES[case]
    seed = sorted(CASES).index(case)
    rng = np.random.RandomState(seed)
    x0 = rng.randn(n, h, w, c).astype(np.float32)
    x1 = rng.randn(n, h, w, c).astype(np.float32)
    rects = _rects(n, h, w, cfg_kw, source, seed)
    if source == "np":
        assert (rects < 0).any(), "case must exercise negative coordinates"
    invert = cfg_kw.get("invert", True)

    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    j_mix, j_m = jax_cutmix_blend(jnp.asarray(x0, jdt), jnp.asarray(x1, jdt),
                                  jnp.asarray(rects), invert=invert, interpret=True)
    j_m_ras = jbox.rasterise_masks(jnp.asarray(rects), (h, w), invert=invert)

    tx0, tx1 = _at_offset(x0, tdt, offset), _at_offset(x1, tdt, offset)
    assert tx0.storage_offset() == offset and tx0.is_contiguous()
    t_mix, t_m = cutmix_blend(tx0, tx1, torch.from_numpy(rects), invert=invert)
    t_m_ras = tbox.rasterise_masks(torch.from_numpy(rects), (h, w), invert=invert)

    assert t_mix.dtype == tdt and t_m.dtype == tdt and t_m.shape == (n, h, w, 1)
    np.testing.assert_array_equal(t_m_ras.numpy(), np.asarray(j_m_ras))
    np.testing.assert_array_equal(t_m.float().numpy(), np.asarray(j_m, np.float32))
    np.testing.assert_array_equal(t_mix.float().numpy(), np.asarray(j_mix, np.float32))


def test_cutmix_blend_batch_past_grid_y_limit():
    """70,000 images, more than a CUDA grid's 65,535 blocks in y: the wrapper
    takes any batch (its kernel streams the batch flat). Held bit-equal to
    JAX's ``rasterise_masks`` and the jnp blend; interpret-mode Pallas would
    step through a 70,000-cell grid."""
    n, h, w, c = 70000, 2, 3, 1
    rng = np.random.RandomState(11)
    x0 = rng.randn(n, h, w, c).astype(np.float32)
    x1 = rng.randn(n, h, w, c).astype(np.float32)
    rects = jbox.sample_box_rects_np(jbox.BoxMaskConfig((0.5, 0.5)), n, (h, w), rng)
    j_m = jbox.rasterise_masks(jnp.asarray(rects), (h, w), invert=True)
    j_mix = jnp.asarray(x0) * (1.0 - j_m) + jnp.asarray(x1) * j_m

    t_mix, t_m = cutmix_blend(torch.from_numpy(x0), torch.from_numpy(x1),
                              torch.from_numpy(rects))
    assert t_mix.shape == (n, h, w, c) and t_m.shape == (n, h, w, 1)
    assert 0.0 < float(t_m.mean()) < 1.0
    np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))
    np.testing.assert_array_equal(t_mix.numpy(), np.asarray(j_mix))


@pytest.mark.parametrize("cfg_kw", [
    dict(prop_range=(0.5, 0.5)),
    dict(prop_range=(0.25, 0.75), n_boxes=3, random_aspect_ratio=False),
    dict(prop_range=(0.2, 0.6), n_boxes=2, prop_by_area=False),
    dict(prop_range=(0.2, 0.6), prop_by_area=False, random_aspect_ratio=False,
         within_bounds=False),
    dict(prop_range=(0.0, 0.5), n_boxes=2, within_bounds=False),
])
def test_sample_box_rects_np_bit_equal_to_jax(cfg_kw):
    rects_j = jbox.sample_box_rects_np(jbox.BoxMaskConfig(**cfg_kw), 16, (33, 57),
                                       np.random.RandomState(7))
    rects_t = tbox.sample_box_rects_np(tbox.BoxMaskConfig(**cfg_kw), 16, (33, 57),
                                       np.random.RandomState(7))
    assert rects_t.dtype == np.float32
    np.testing.assert_array_equal(rects_t, rects_j)


@pytest.mark.parametrize("cfg_kw, area", [
    # random aspect: each box's h*w == p * (1/n_boxes)
    (dict(prop_range=(0.5, 0.5)), 0.5),
    (dict(prop_range=(0.3, 0.7), n_boxes=2), 0.25),
    # fixed aspect: the aliasing quirk scales each side by 1/n_boxes
    (dict(prop_range=(0.5, 0.5), n_boxes=2, random_aspect_ratio=False), 0.125),
])
def test_torch_sampler_box_size_distribution(cfg_kw, area):
    """The device sampler draws other numbers than JAX's, so it is held to
    the distribution: mean box area (a mean over 20000 boxes; rounding sides
    to whole pixels moves it by well under 0.01) and bounds."""
    h, w, n = 64, 80, 20000
    gen = torch.Generator().manual_seed(0)
    rects = tbox.sample_box_rects(tbox.BoxMaskConfig(**cfg_kw), gen, n, (h, w))
    assert rects.dtype == torch.float32 and rects.shape == (n, cfg_kw.get("n_boxes", 1), 4)
    r = rects.numpy()
    frac = (r[..., 2] - r[..., 0]) * (r[..., 3] - r[..., 1]) / (h * w)
    assert abs(frac.mean() - area) < 0.01, frac.mean()
    assert (r[..., 0] >= 0).all() and (r[..., 2] <= h).all()
    assert (r[..., 1] >= 0).all() and (r[..., 3] <= w).all()
    # JAX's sampler has the same mean
    rj = np.asarray(jbox.sample_box_rects(jbox.BoxMaskConfig(**cfg_kw),
                                          jax.random.PRNGKey(0), n, (h, w)))
    frac_j = (rj[..., 2] - rj[..., 0]) * (rj[..., 3] - rj[..., 1]) / (h * w)
    assert abs(frac.mean() - frac_j.mean()) < 0.01


def test_sample_masks_shape_and_values():
    gen = torch.Generator().manual_seed(3)
    m = tbox.sample_masks(tbox.BoxMaskConfig((0.5, 0.5)), gen, 5, (21, 34))
    assert m.shape == (5, 21, 34, 1) and m.dtype == torch.float32
    assert set(np.unique(m.numpy())) <= {0.0, 1.0}


@pytest.mark.parametrize("bad", ["requires_grad", "dtype", "rects_dtype", "shape",
                                 "no_boxes", "non_contiguous", "too_many_elements"])
def test_cutmix_blend_rejects_unsupported_inputs(bad, monkeypatch):
    x0 = torch.zeros(2, 8, 8, 3)
    x1 = torch.zeros(2, 8, 8, 3)
    rects = torch.zeros(2, 1, 4)
    if bad == "requires_grad":
        x0.requires_grad_(True)
    elif bad == "dtype":
        x0, x1 = x0.double(), x1.double()
    elif bad == "rects_dtype":
        rects = rects.double()
    elif bad == "shape":
        x1 = torch.zeros(2, 8, 9, 3)
    elif bad == "no_boxes":
        rects = torch.zeros(2, 0, 4)
    elif bad == "non_contiguous":
        x0 = torch.zeros(2, 3, 8, 8).permute(0, 2, 3, 1)
    elif bad == "too_many_elements":
        # the kernel indexes in 32 bits; a smaller cap stands in for 2^31 - 1
        monkeypatch.setattr(tcutmix, "_MAX_ELEMS", x0.numel() - 1)
    with pytest.raises((ValueError, TypeError)):
        cutmix_blend(x0, x1, rects)
