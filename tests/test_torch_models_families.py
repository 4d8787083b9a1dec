"""The port's BatchNorm, Dropout, resizes, initialisers, weight bridge and
its DenseUNet, ResUNet, DeepLab v3/v3+ and PSPNet families (and the
torchvision-style ResNet) against the JAX package on the CPU at float32.

Weights are random numpy values (He-scaled kernels, classifiers scaled to
O(1) logits, random BN statistics) carried across with
``from_jax_variables(..., 'tree')``. In train mode BN uses batch statistics
(``freeze_bn=False``) and dropout takes the same masks on both sides: flax's
``nn.Dropout.__call__`` is patched inside the test to take them, the port's
``Dropout.draw_keep`` to return them.

Tolerances: logits within rtol 1e-4 with an atol of 1e-4 of their largest
magnitude (the same convolutions and BN reductions, summed in another
order); one BN layer's running statistics after a train forward within
1e-6; inside a family they are statistics of activations that already
differ at that level, so each is held like the logits (rtol 1e-4, atol 1e-4
of the tensor's largest magnitude).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch
from flax.linen.module import merge_param
from jax import lax

from cutmix_seg_tpu.models import common as jcommon
from cutmix_seg_tpu.models import deeplab3 as jd3
from cutmix_seg_tpu.models import denseunet as jdu
from cutmix_seg_tpu.models import pspnet as jps
from cutmix_seg_tpu.models import registry as jreg
from cutmix_seg_tpu.models import resnet as jresnet
from cutmix_seg_tpu.models import resunet as jru
from cutmix_seg_tpu.models import torch_import
from cutmix_seg_tpu_torch.models import common as tcommon
from cutmix_seg_tpu_torch.models import deeplab3 as td3
from cutmix_seg_tpu_torch.models import denseunet as tdu
from cutmix_seg_tpu_torch.models import pspnet as tps
from cutmix_seg_tpu_torch.models import registry as treg
from cutmix_seg_tpu_torch.models import resnet as tresnet
from cutmix_seg_tpu_torch.models import resunet as tru
from cutmix_seg_tpu_torch.models import weights

torch.set_num_threads(1)

TINY = (1, 1, 1, 1)


def fill(shapes, seed):
    """Random float32 numpy leaves for a tree of shapes."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            gain = 0.1 if any(c in jax.tree_util.keystr(path)
                              for c in ("classifier", "final_clf")) else 1.0
            val = rng.randn(*s.shape) * gain * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        elif name == "scale":
            val = rng.uniform(0.5, 1.5, s.shape)
        elif name == "bias":
            val = rng.uniform(-0.2, 0.2, s.shape)
        elif name == "mean":
            val = rng.uniform(-0.5, 0.5, s.shape)
        elif name == "var":
            val = rng.uniform(0.5, 2.0, s.shape)
        else:
            raise KeyError(name)
        return val.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_variables(jmod, x, seed, **call_kw):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), **call_kw))
    return fill(shapes, seed)


class MaskBank:
    """Dropout masks by call order: call k of a forward gets the keep mask
    drawn from seed + k, on both sides."""

    def __init__(self, seed=100):
        self.seed, self.k = seed, 0

    def next(self, shape_nhwc, keep_prob):
        mask = np.random.RandomState(self.seed + self.k).rand(*shape_nhwc) < keep_prob
        self.k += 1
        return mask


def patch_dropout(monkeypatch, bank):
    """flax's Dropout and the port's draw take the bank's masks."""

    def flax_call(self, inputs, deterministic=None, rng=None):
        if merge_param("deterministic", self.deterministic, deterministic) or self.rate == 0:
            return inputs
        keep_prob = 1.0 - self.rate
        mask = jnp.asarray(bank.next(inputs.shape, keep_prob))
        return lax.select(mask, inputs / keep_prob, jnp.zeros_like(inputs))

    def port_draw(self, x):
        n, c, h, w = x.shape
        return torch.from_numpy(bank.next((n, h, w, c), 1.0 - self.rate)).permute(0, 3, 1, 2)

    monkeypatch.setattr(fnn.Dropout, "__call__", flax_call)
    monkeypatch.setattr(tcommon.Dropout, "draw_keep", port_draw)


def assert_logits_close(out, ref):
    assert out.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert scale > 0.1  # the comparison means something
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * scale)


def assert_stats_close(port_module, jax_stats):
    want = weights.from_jax_variables({"batch_stats": jax.device_get(jax_stats)}, "tree")
    got = port_module.state_dict()
    assert want and set(want) <= set(got)
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-3)
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=k)
    assert any(not torch.equal(got[k], w) for k, w in want.items())  # they moved


# ---- BatchNorm and Dropout ----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax(dtype):
    """Batch statistics in float32 (fast variance), the output in the
    compute dtype, running statistics 0.9 * r + 0.1 * batch with the BIASED
    variance."""
    rng = np.random.RandomState(0)
    c = 6
    x = (3.0 + rng.randn(4, 5, 7, c) * rng.uniform(0.1, 2.0, c)).astype(np.float32)
    x[..., 2] = 1.5  # a constant channel: variance 0, exactly, on both sides
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.uniform(-0.2, 0.2, c).astype(np.float32)}
    s = {"mean": rng.uniform(-0.5, 0.5, c).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj = jnp.asarray(x, jdt or jnp.float32)
    ref, upd = jcommon.batch_norm(False, "bn", jdt).apply(
        {"params": p, "batch_stats": s}, xj, mutable=["batch_stats"])
    bn = tcommon.BatchNorm2d(c)
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]), "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"])})
    tcommon.set_freeze_bn(bn, False)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = bn(xt).permute(0, 2, 3, 1)
    assert out.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:  # the same float32 value, rounded to bf16 once
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    # the biased variance: torch's unbiased update would be n/(n-1) larger
    xv = np.asarray(xj.astype(jnp.float32), np.float64).reshape(-1, c)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * s["var"] + 0.1 * xv.var(axis=0),
                               rtol=1e-5, atol=1e-6)


def test_batchnorm_clips_a_negative_fast_variance():
    """E[x^2] - E[x]^2 of values near 1000 rounds to -0.0625 in float32 here:
    the batch variance counts as 0, as flax's max(0, .) makes it."""
    x = 1000 + 1e-3 * torch.randn(2, 1, 3, 4, generator=torch.Generator().manual_seed(4))
    m = x.mean(dim=(0, 2, 3))
    assert ((x * x).mean(dim=(0, 2, 3)) - m * m).item() < 0
    bn = tcommon.BatchNorm2d(1)
    tcommon.set_freeze_bn(bn, False)
    with torch.no_grad():
        out = bn(x)
    assert torch.isfinite(out).all()
    assert bn.running_var.item() == np.float32(0.9)


def test_batchnorm_modes():
    """eval and freeze use the running statistics and leave them; ``track``
    off (running_stats_kept) normalises with batch statistics and leaves
    them too."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(3, 4, 5, 6).astype(np.float32))
    bn = tcommon.BatchNorm2d(4)
    with torch.no_grad():
        bn.running_mean.uniform_(-1, 1)
        bn.running_var.uniform_(0.5, 2)
    r0 = {k: v.clone() for k, v in bn.state_dict().items()}
    with torch.no_grad():
        frozen = bn(x)  # train mode, freeze on by default
        with tcommon.eval_mode(bn):
            evaluated = bn(x)
        assert bn.training
        tcommon.set_freeze_bn(bn, False)
        with tcommon.running_stats_kept(bn):
            batch = bn(x)
    assert torch.equal(frozen, evaluated)
    assert all(torch.equal(v, r0[k]) for k, v in bn.state_dict().items())
    assert abs(batch.mean().item()) < 1e-5  # batch statistics
    with torch.no_grad():
        bn(x)
    assert not torch.equal(bn.running_mean, r0["running_mean"])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_flax(rate, monkeypatch):
    bank = MaskBank(7)
    patch_dropout(monkeypatch, bank)
    x = np.random.RandomState(2).randn(2, 5, 6, 3).astype(np.float32)
    ref = np.asarray(fnn.Dropout(rate).apply({}, jnp.asarray(x), deterministic=False))
    bank.k = 0
    drop = tcommon.Dropout(rate)
    out = drop(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out == 0).any() and (out != 0).any()
    with tcommon.eval_mode(drop):
        assert drop(torch.ones(1)).item() == 1.0


def test_dropout_draws_from_its_generator():
    drop = tcommon.Dropout(0.3)
    x = torch.ones(2, 3, 4, 5)
    with pytest.raises(RuntimeError, match="needs a generator"):
        drop(x)
    outs = []
    for _ in range(2):
        tcommon.set_dropout_generator(drop, torch.Generator().manual_seed(3))
        outs.append(drop(x))
    assert torch.equal(outs[0], outs[1])
    kept = (outs[0] != 0).float().mean().item()
    assert 0.5 < kept < 0.9 and torch.allclose(outs[0][outs[0] != 0], torch.tensor(1 / 0.7))


# ---- resizes and pooling ----

@pytest.mark.parametrize("in_hw, out_hw", [((41, 41), (321, 321)), ((2, 2), (41, 41)),
                                           ((7, 9), (3, 4)), ((6, 8), (41, 57)),
                                           ((5, 5), (5, 5))])
def test_resize_half_pixel_matches_jax(in_hw, out_hw):
    """Non-integer factors, both directions, and the edge rows."""
    x = np.random.RandomState(3).randn(2, *in_hw, 4).astype(np.float32)
    ref = np.asarray(jcommon.resize_bilinear_half_pixel(jnp.asarray(x), out_hw))
    out = tcommon.resize_bilinear_half_pixel(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
    out = out.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[:, [0, -1]], ref[:, [0, -1]], rtol=1e-5, atol=1e-5)


def test_upsample_nearest_matches_jax():
    x = np.random.RandomState(4).randn(2, 3, 5, 4).astype(np.float32)
    ref = np.asarray(jcommon.upsample_nearest_2x(jnp.asarray(x)))
    out = tcommon.upsample_nearest_2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("size", [5, 7, 41])
def test_adaptive_pool_bins_match_jax(size):
    x = np.random.RandomState(5).randn(2, size, size + 2, 3).astype(np.float32)
    for bins in (1, 2, 3, 6):
        ref = np.asarray(jps._adaptive_avg_pool(jnp.asarray(x), bins))
        out = torch.nn.functional.adaptive_avg_pool2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), bins).permute(0, 2, 3, 1)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


# ---- initialisers ----

@pytest.mark.parametrize("init, flax_init", [
    ("lecun_normal", fnn.initializers.lecun_normal()),
    ("he_normal", fnn.initializers.he_normal()),
    ("normal", fnn.initializers.normal(stddev=0.01))])
def test_conv_initialiser_matches_flax(init, flax_init):
    """Same distribution: std within 2% over 295k draws, and the truncated
    ones bounded at 2 standard deviations of the underlying normal."""
    conv = tcommon.Conv2d(128, 256, 3, init=init)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    ref = np.asarray(flax_init(jax.random.PRNGKey(0), (3, 3, 128, 256), jnp.float32))
    w = conv.weight.detach().numpy()
    assert abs(w.std() / ref.std() - 1) < 0.02 and abs(w.mean()) < 3e-3 * ref.std() * 10
    if init != "normal":
        bound = 2 * np.sqrt({"lecun_normal": 1.0, "he_normal": 2.0}[init] / (9 * 128)) / 0.8796
        assert np.abs(w).max() <= bound * 1.0001 and np.abs(ref).max() <= bound * 1.0001


INIT_FAMILIES = {  # name: (JAX module, port module, input hw)
    "deeplabv3plus": (lambda: jd3.DeepLabV3Plus(num_classes=5, layers=TINY),
                      lambda: td3.DeepLabV3Plus(5, layers=TINY), (33, 33)),
    "resunet": (lambda: jru.ResUNet(num_classes=5, layers=TINY),
                lambda: tru.ResUNet(5, layers=TINY), (32, 32)),
}


@pytest.mark.parametrize("family", sorted(INIT_FAMILIES))
def test_each_conv_takes_the_jax_initialiser(family):
    """Per kernel, the std of the port's init against flax's init of the
    same module within 20% (the initialisers differ by 1.41x (He against
    LeCun) and 4x or more (N(0, 0.01) against either)); biases 0."""
    jmk, tmk, hw = INIT_FAMILIES[family]
    jv = jax.jit(lambda: jmk().init(jax.random.PRNGKey(0), jnp.zeros((1,) + hw + (3,)),
                                    train=False))()
    module = tmk()
    tcommon.init_weights(module, torch.Generator().manual_seed(0))
    sd = module.state_dict()
    n_checked = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jv["params"]):
        keys = tuple(str(k.key) for k in path)
        got = sd[weights.torch_key(keys, "tree")].numpy()
        if keys[-1] == "bias" and "bn" not in "".join(keys):
            assert not got.any(), keys
        if keys[-1] == "kernel" and leaf.size >= 2048:
            ratio = got.std() / np.asarray(leaf).std()
            assert 0.8 < ratio < 1.25, (keys, ratio)
            n_checked += 1
    assert n_checked >= 10


# ---- the families, eval and train mode ----

# name: (JAX module, port module, input (N, H, W)). Each batch-statistics BN
# sees at least 4 values per channel: over 2, (x - mean) / sqrt(var + eps)
# turns float32 rounding into O(1e-2) differences when the two nearly meet
FAMILIES = {
    "densenet_features": (lambda: jdu.DenseNetFeatures(block_config=(2, 2, 2, 2)),
                          lambda: tdu.DenseNetFeatures(block_config=(2, 2, 2, 2)), (2, 64, 64)),
    "denseunet161": (lambda: jdu.DenseUNet(num_classes=4), lambda: tdu.DenseUNet(4),
                     (2, 64, 64)),
    "resunet": (lambda: jru.ResUNet(num_classes=5, layers=TINY),
                lambda: tru.ResUNet(5, layers=TINY), (2, 64, 64)),
    "deeplabv3": (lambda: jd3.DeepLabV3(num_classes=5, layers=TINY),
                  lambda: td3.DeepLabV3(5, layers=TINY), (2, 33, 33)),
    "deeplabv3plus": (lambda: jd3.DeepLabV3Plus(num_classes=5, layers=TINY),
                      lambda: td3.DeepLabV3Plus(5, layers=TINY), (2, 41, 57)),
    "pspnet": (lambda: jps.PSPNet(num_classes=5, layers=TINY),
               lambda: tps.PSPNet(5, layers=TINY), (4, 50, 50)),
}


def _apply_jax(jmod, variables, x, train, features):
    if features:  # DenseNetFeatures: (x, use_running_average) -> (norm5, taps)
        fn = lambda v, x: jmod.apply(v, x, not train, mutable=["batch_stats"])  # noqa: E731
    else:
        fn = lambda v, x: jmod.apply(v, x, train=train, freeze_bn=False,  # noqa: E731
                                     mutable=["batch_stats"])
    return jax.jit(fn)(variables, jnp.asarray(x))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_matches_jax(family, train, monkeypatch):
    """Logits (the features and every tap for DenseNetFeatures), and in
    train mode the updated running statistics, against the JAX module; the
    eval-mode forward changes no running statistic."""
    jmk, tmk, (n, h, w) = FAMILIES[family]
    jmod, tmod = jmk(), tmk()
    bank = MaskBank()
    patch_dropout(monkeypatch, bank)
    features = family == "densenet_features"
    x = np.random.RandomState(6).uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    call_kw = {"use_running_average": True} if features else {"train": False}
    variables = jax_variables(jmod, x, 8, **call_kw)
    tmod.load_state_dict(weights.from_jax_variables(variables, "tree"), strict=True)
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    ref, upd = _apply_jax(jmod, variables, x, train, features)
    bank.k = 0
    tmod.train(train)
    tcommon.set_freeze_bn(tmod, False)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if features:
            out, taps = tmod(xt.permute(0, 3, 1, 2))
            for name, tap in taps.items():
                assert_logits_close(tap.permute(0, 2, 3, 1).numpy(), np.asarray(ref[1][name]))
            out = out.permute(0, 2, 3, 1)
            ref = ref[0]
        else:
            out = tmod(xt)
    assert bank.k == (1 if train and not features else 0)
    assert_logits_close(out.numpy(), np.asarray(ref))
    if train:
        assert_stats_close(tmod, upd["batch_stats"])
    else:
        assert all(torch.equal(v, before[k]) for k, v in tmod.state_dict().items())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_torchvision_resnet_taps_match_jax(train):
    """style='torchvision' at layers (1, 1, 1, 1), strides (1, 2, 1, 1),
    dilations (1, 1, 2, 4): stride on conv2, the first dilated block at the
    previous dilation, floor-mode pool; every tap, stem_prerelu included."""
    jmod = jresnet.ResNetBackbone(layers=TINY, strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
                                  style="torchvision")
    x = np.random.RandomState(9).uniform(-1, 1, (2, 35, 41, 3)).astype(np.float32)
    variables = jax_variables(jmod, x, 10, use_running_average=True)
    (_, ref), upd = jax.jit(lambda v, x: jmod.apply(v, x, not train, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    tmod = tresnet.ResNetBackbone(TINY, (1, 2, 1, 1), (1, 1, 2, 4), style="torchvision")
    tmod.load_state_dict(weights.from_jax_variables(variables, "tree"), strict=True)
    assert tmod.layer3[0].conv2.dilation == (1, 1) and tmod.layer4[0].conv2.dilation == (2, 2)
    assert tmod.layer2[0].conv2.stride == (2, 2) and tmod.layer2[0].conv1.stride == (1, 1)
    tmod.train(train)
    tcommon.set_freeze_bn(tmod, False)
    with torch.no_grad():
        taps = tmod.taps(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert sorted(taps) == sorted(ref) == ["layer1", "layer2", "layer3", "layer4", "stem",
                                           "stem_prerelu"]
    for name, tap in taps.items():
        assert_logits_close(tap.permute(0, 2, 3, 1).numpy(), np.asarray(ref[name]))
    if train:
        assert_stats_close(tmod, upd["batch_stats"])


# ---- registry, bridge shapes and parameter labels ----

NEW_ARCHS = ("densenet161unet", "densenet161unet_imagenet", "resnet101_deeplabv3_coco",
             "resnet101_deeplabv3_imagenet", "resnet101_deeplabv3plus_imagenet",
             "resnet101_pspnet_imagenet", "resnet101unet_imagenet", "resnet50unet_imagenet")


def test_every_jax_arch_resolves():
    # (other test files register tiny archs of their own in the port)
    assert len(jreg.names()) == 11 and set(jreg.names()) <= set(treg.names())
    for name in jreg.names():
        assert treg.get(name).__name__ == name
    with pytest.raises(KeyError, match="unknown architecture"):
        treg.get("resnet18_fcn")


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_full_width_bridge_and_labels_match_jax(name):
    """Full width, shapes only (eval_shape; a meta-device port module):
    every JAX leaf maps to a port state_dict entry of the transposed shape,
    nothing is left over, and each parameter's label equals JAX's. No BN
    affine is 'frozen' outside DeepLab v2."""
    jmodel = jreg.get(name)(21, pretrained=True) if name != "densenet161unet" \
        else jreg.get(name)(21)
    hw = (64, 64) if jmodel.block_size != (1, 1) else (33, 33)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), input_hw=hw))
    with torch.device("meta"):
        tmodel = treg.get(name)(21, pretrained=True)
    sd = tmodel.module.state_dict()
    mapped = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes[coll]):
            keys = tuple(str(k.key) for k in path)
            shape = leaf.shape
            if keys[-1] == "kernel":
                shape = (shape[3], shape[2], shape[0], shape[1])
            mapped[weights.torch_key(keys, "tree")] = shape
    assert set(mapped) == set(sd)
    for k, shape in mapped.items():
        assert tuple(sd[k].shape) == shape, k
    jlabels = jmodel.param_label(shapes["params"])
    expected = {weights.torch_key(tuple(str(k.key) for k in path), "tree"): lab
                for path, lab in jax.tree_util.tree_leaves_with_path(jlabels)}
    got = tmodel.param_label(tmodel.module)
    assert got == expected
    assert "frozen" not in got.values()
    assert (tmodel.mean is None) == (jmodel.mean is None) and tmodel.block_size == \
        jmodel.block_size


# ---- the weight bridge and the local-file loaders ----

def test_from_jax_variables_round_trips_through_the_jax_importers():
    """ResUNet's backbone and DenseNet's features: JAX variables -> port
    state_dict (strict load) -> the JAX package's own torch importers
    (map_torch_resnet, map_torch_densenet) -> the same JAX leaves."""
    cases = [(jru.ResUNet(num_classes=3, layers=(2, 1, 1, 1)),
              tru.ResUNet(3, layers=(2, 1, 1, 1)), "backbone", torch_import.map_torch_resnet),
             (jdu.DenseNetFeatures(block_config=(2, 1, 2, 1)),
              tdu.DenseNetFeatures(block_config=(2, 1, 2, 1)), None,
              torch_import.map_torch_densenet)]
    for jmod, tmod, root, mapper in cases:
        x = np.zeros((1, 64, 64, 3), np.float32)
        kw = {"train": False} if root else {"use_running_average": True}
        variables = jax_variables(jmod, x, 11, **kw)
        sd = weights.from_jax_variables(variables, "tree")
        tmod.load_state_dict(sd, strict=True)
        if root:
            sd_np = {k[len(root) + 1:]: v.numpy() for k, v in tmod.state_dict().items()
                     if k.startswith(root + ".")}
            want = {"params": variables["params"][root],
                    "batch_stats": variables["batch_stats"][root]}
        else:
            sd_np = {"features." + k: v.numpy() for k, v in tmod.state_dict().items()}
            want = variables
        params_u, stats_u = mapper(sd_np)
        zeros = jax.tree_util.tree_map(np.zeros_like, want)
        back, n, s = torch_import.merge_updates(zeros, params_u, stats_u)
        assert s == 0 and n == len(sd_np)
        flat = dict(jax.tree_util.tree_leaves_with_path(back))
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            np.testing.assert_array_equal(np.asarray(flat[path]), leaf, err_msg=str(path))


def test_load_resnet_backbone_from_a_local_file(tmp_path, monkeypatch):
    """A torchvision ResNet state dict (top-level keys, fc.* and
    num_batches_tracked included) fills ``backbone.*`` by name and shape;
    the decoder is untouched."""
    src = tresnet.ResNetBackbone(TINY, (1, 2, 2, 2), (1, 1, 1, 1), style="torchvision")
    tcommon.init_weights(src, torch.Generator().manual_seed(1))
    sd = dict(src.state_dict())
    sd["fc.weight"] = torch.zeros(10, 2048)
    sd["bn1.num_batches_tracked"] = torch.tensor(5)
    torch.save(sd, tmp_path / "resnet50_imagenet.pth")
    monkeypatch.setenv("CUTMIX_SEG_WEIGHTS", str(tmp_path))
    model = tru.ResUNet(3, layers=TINY)
    dec0 = model.decoder3.conv.weight.detach().clone()
    n, s = weights.load_resnet_backbone(model, "resnet50_imagenet")
    assert (n, s) == (len(src.state_dict()), 0)
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()["backbone." + k], v), k
    assert torch.equal(model.decoder3.conv.weight, dec0)


def test_load_densenet_features_from_a_local_file(tmp_path, monkeypatch):
    src = tdu.DenseUNet(3, block_config=(2, 2, 2, 2))
    tcommon.init_weights(src, torch.Generator().manual_seed(2))
    feats = {k: v for k, v in src.state_dict().items() if k.startswith("features.")}
    torch.save(dict(feats, **{"classifier.weight": torch.zeros(1000, 192)}),
               tmp_path / "densenet161_imagenet.pth")
    monkeypatch.setenv("CUTMIX_SEG_WEIGHTS", str(tmp_path))
    model = tdu.DenseUNet(3, block_config=(2, 2, 2, 2))
    clf0 = model.final_clf.weight.detach().clone()
    n, s = weights.load_densenet_features(model, "densenet161_imagenet")
    assert (n, s) == (len(feats), 0)
    for k, v in feats.items():
        assert torch.equal(model.state_dict()[k], v), k
    assert torch.equal(model.final_clf.weight, clf0)
    with pytest.raises(FileNotFoundError, match="CUTMIX_SEG_WEIGHTS"):
        weights.load_densenet_features(model, "densenet121_imagenet")
