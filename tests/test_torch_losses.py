"""The port's losses, confidence gating and masked consistency against the
JAX package at float32: values and input gradients (torch autograd against
jax.grad) within rtol 1e-5. Both sides run the same softmax/log-softmax
formulas; only the order of the class sums differs, which moves float32
results by a few ulps."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.semisup import losses as JL
from cutmix_seg_tpu.semisup import stepcore as JS
from cutmix_seg_tpu_torch.semisup import losses as TL
from cutmix_seg_tpu_torch.semisup import stepcore as TS

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-7


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def test_cross_entropy_ignore_value_and_grad():
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 5, 7, 6) * 3).astype(np.float32)
    labels = rng.randint(0, 6, size=(2, 5, 7)).astype(np.int32)
    labels[rng.rand(2, 5, 7) < 0.3] = 255

    def jf(x):
        return JL.cross_entropy_ignore(x, jnp.asarray(labels), 255)

    j_val, j_grad = jax.value_and_grad(jf)(jnp.asarray(logits))
    x = _t(logits, grad=True)
    val = TL.cross_entropy_ignore(x, torch.from_numpy(labels).long(), 255)
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=RTOL, atol=ATOL)


def test_cross_entropy_all_ignored_is_zero():
    logits = torch.zeros(1, 2, 2, 3, requires_grad=True)
    labels = torch.full((1, 2, 2), 255)
    val = TL.cross_entropy_ignore(logits, labels)
    val.backward()
    assert val.item() == 0.0 and torch.all(logits.grad == 0)


@pytest.mark.parametrize("loss_fn", ["var", "logits_var", "logits_smoothl1", "bce", "kld"])
def test_consistency_loss_value_and_grads(loss_fn):
    rng = np.random.RandomState(1)
    stu = (rng.randn(2, 4, 5, 7) * 2).astype(np.float32)
    tea = (rng.randn(2, 4, 5, 7) * 2).astype(np.float32)
    w = rng.rand(2, 4, 5, 1).astype(np.float32)

    def jf(s, t):
        return (JL.consistency_loss_per_pixel(loss_fn, s, t) * w).sum()

    j_px = np.asarray(JL.consistency_loss_per_pixel(loss_fn, jnp.asarray(stu), jnp.asarray(tea)))
    j_gs, j_gt = jax.grad(jf, argnums=(0, 1))(jnp.asarray(stu), jnp.asarray(tea))

    s, t = _t(stu, True), _t(tea, True)
    px = TL.consistency_loss_per_pixel(loss_fn, s, t)
    assert px.shape == (2, 4, 5, 1) and px.dtype == torch.float32
    (px * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(px.detach().numpy(), j_px, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(j_gs), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_gt), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("loss_fn", ["var", "logits_var", "logits_smoothl1", "bce", "kld"])
def test_consistency_from_prob_targets_value_and_grad(loss_fn):
    """Targets are a blend of two softmaxes (ICT's), with some exact zeros
    so that kld's 1e-20 clamp is reached."""
    rng = np.random.RandomState(4)
    stu = (rng.randn(2, 4, 5, 7) * 2).astype(np.float32)
    tea = (rng.randn(2, 4, 5, 7) * 2).astype(np.float32)
    p0, p1 = (np.asarray(jax.nn.softmax(jnp.asarray(rng.randn(2, 4, 5, 7) * 3), axis=-1))
              for _ in range(2))
    lam = rng.rand(2, 1, 1, 1).astype(np.float32)
    prob = (p0 * (1 - lam) + p1 * lam).astype(np.float32)
    prob[0, 0, 0] = np.eye(7, dtype=np.float32)[2]
    w = rng.rand(2, 4, 5, 1).astype(np.float32)

    def jf(s):
        return (JL.consistency_from_prob_targets(loss_fn, s, jnp.asarray(tea),
                                                 jnp.asarray(prob)) * w).sum()

    j_px = np.asarray(JL.consistency_from_prob_targets(
        loss_fn, jnp.asarray(stu), jnp.asarray(tea), jnp.asarray(prob)))
    j_gs = jax.grad(jf)(jnp.asarray(stu))
    s = _t(stu, True)
    px = TL.consistency_from_prob_targets(loss_fn, s, torch.from_numpy(tea),
                                          torch.from_numpy(prob))
    assert px.shape == (2, 4, 5, 1) and px.dtype == torch.float32
    assert np.isfinite(px.detach().numpy()).all()
    (px * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(px.detach().numpy(), j_px, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(j_gs), rtol=RTOL, atol=ATOL)


def test_consistency_loss_unknown_raises():
    with pytest.raises(ValueError):
        TL.consistency_loss_per_pixel("nope", torch.zeros(1, 1, 1, 2), torch.zeros(1, 1, 1, 2))
    with pytest.raises(ValueError):
        TL.consistency_from_prob_targets("nope", *[torch.zeros(1, 1, 1, 2)] * 3)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_confidence_mask(per_pixel):
    rng = np.random.RandomState(2)
    logits = (rng.randn(3, 4, 5, 6) * 2).astype(np.float32)
    prob = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    j_m, j_rate = JL.confidence_mask(jnp.asarray(prob), 0.5, per_pixel)
    t_m, t_rate = TL.confidence_mask(torch.from_numpy(prob), 0.5, per_pixel)
    assert 0.0 < float(j_rate) < 1.0
    # the 0/1 gate is exact; its mean differs by the order of the sum
    if per_pixel:
        np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))
    else:
        np.testing.assert_allclose(t_m.item(), float(j_m), rtol=RTOL)
    np.testing.assert_allclose(t_rate.item(), float(j_rate), rtol=RTOL)


@pytest.mark.parametrize("R, per_pixel, gated", [(1, False, True), (2, False, True),
                                                 (2, True, True), (2, False, False)])
def test_masked_consistency_value_and_grad(R, per_pixel, gated):
    rng = np.random.RandomState(3)
    per_px = rng.rand(4, 5, 6, 1).astype(np.float32)
    loss_mask = (rng.rand(4, 5, 6, 1) > 0.3).astype(np.float32)
    conf = rng.rand(4, 5, 6, 1).astype(np.float32)
    kw = dict(unsup_batch_ratio=R, conf_per_pixel=per_pixel,
              conf_thresh=0.4 if gated else 0.0)
    jcfg, tcfg = JS.ConsistencyCommon(**kw), TS.ConsistencyCommon(**kw)
    j_conf = JS.confidence_px(jcfg, jnp.asarray(conf))
    t_conf = TS.confidence_px(tcfg, torch.from_numpy(conf))
    assert (j_conf is None) == (t_conf is None) == (not gated)

    def jf(p):
        s, m, r = JS.masked_consistency(jcfg, p, jnp.asarray(loss_mask), j_conf)
        return s, (m, r)

    (j_sum, (j_mean, j_rate)), j_grad = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(per_px))
    p = _t(per_px, True)
    t_sum, t_mean, t_rate = TS.masked_consistency(tcfg, p, torch.from_numpy(loss_mask), t_conf)
    t_sum.backward()
    for a, b in ((t_sum, j_sum), (t_mean, j_mean), (t_rate, j_rate)):
        np.testing.assert_allclose(a.item(), float(b), rtol=RTOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(j_grad), rtol=RTOL, atol=ATOL)


def test_config_fields_match_jax():
    """The common options keep the JAX names and defaults."""
    j = {f.name: f.default for f in dataclasses.fields(JS.ConsistencyCommon)}
    t = {f.name: f.default for f in dataclasses.fields(TS.ConsistencyCommon)}
    assert t == j
