"""The port's DeepLab v2 and its pieces against the JAX package on the CPU.

Forward parity is at float32 with rtol 1e-4 / atol 1e-5: both sides compute
the same convolutions, but their sums run in another order, and frozen BN is
one fused affine here against flax's (x - mean) * g + bias."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.models import common as jcommon
from cutmix_seg_tpu.models import deeplab2 as jdl
from cutmix_seg_tpu.models import torch_import
from cutmix_seg_tpu_torch.models import common as tcommon
from cutmix_seg_tpu_torch.models import deeplab2 as tdl
from cutmix_seg_tpu_torch.models import weights

torch.set_num_threads(1)


def random_variables(module, hw, seed):
    """JAX init variables with He-scaled backbone kernels, a classifier
    scaled to O(1) logits and random frozen-BN statistics, as float32 numpy."""
    rng = np.random.RandomState(seed)
    variables = module.init(jax.random.PRNGKey(seed), jnp.zeros((1,) + hw + (3,)),
                            train=False)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            gain = 0.1 if "classifier" in jax.tree_util.keystr(path) else 1.0
            val = rng.randn(*shape) * gain * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            val = rng.uniform(0.5, 1.5, shape)
        elif name == "bias":
            val = rng.uniform(-0.2, 0.2, shape)
        elif name == "mean":
            val = rng.uniform(-0.5, 0.5, shape)
        elif name == "var":
            val = rng.uniform(0.5, 2.0, shape)
        else:
            raise KeyError(name)
        return val.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(dict(variables)))


def port_module(variables, num_classes, layers, branches=2):
    m = tdl.DeepLab2(num_classes, layers=layers, aspp_branches_used=branches)
    m.load_state_dict(weights.from_jax_variables(variables), strict=True)
    return m


def test_from_jax_variables_round_trip():
    """JAX variables -> port state_dict (strict load) -> the JAX package's own
    torch importer -> the same JAX variables, leaf for leaf."""
    layers = (2, 1, 2, 1)
    jmod = jdl.DeepLab2(num_classes=5, layers=layers)
    variables = random_variables(jmod, (33, 33), 0)
    sd = port_module(variables, 5, layers).state_dict()
    sd_np = {k: v.numpy() for k, v in sd.items()}
    params_u, stats_u = torch_import.map_torch_resnet(sd_np)
    head_u = torch_import.map_hung_deeplab_classifier(sd_np)
    zeros = jax.tree_util.tree_map(np.zeros_like, variables)
    back, n1, s1 = torch_import.merge_updates(
        zeros, {"backbone": params_u}, {"backbone": stats_u})
    back, n2, s2 = torch_import.merge_updates(back, {"classifier": head_u}, {})
    assert s1 == s2 == 0 and n1 + n2 == len(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b) == len(sd)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("hw, branches", [((33, 33), 2), ((41, 57), 2), ((33, 33), 4)])
def test_deeplab2_forward_parity_f32(hw, branches):
    """DeepLab2(layers=(2,1,2,1)): non-first blocks without a projection,
    dilated stages, ceil pool, ASPP sum and the align_corners upsample."""
    layers = (2, 1, 2, 1)
    jmod = jdl.DeepLab2(num_classes=5, layers=layers, aspp_branches_used=branches)
    variables = random_variables(jmod, hw, 1)
    x = np.random.RandomState(2).uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = port_module(variables, 5, layers, branches)(torch.from_numpy(x))
    assert out.shape == ref.shape and out.is_contiguous()
    assert np.abs(ref).max() > 0.5  # O(1) logits: the comparison means something
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hw", [(7, 7), (8, 9), (33, 48), (161, 161)])
def test_max_pool_ceil_matches_jax(hw):
    x = np.random.RandomState(3).randn(2, *hw, 4).astype(np.float32)
    ref = np.asarray(jcommon.max_pool_ceil(jnp.asarray(x), 3, 2, 1))
    out = tcommon.max_pool_ceil(torch.from_numpy(x), 3, 2, 1)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


def test_max_pool_ceil_raises_where_torch_drops_a_window():
    # window 2, stride 2, pad 1 at size 5: the reference's last window lies
    # wholly in the padding, torch's ceil rule drops it
    with pytest.raises(ValueError):
        tcommon.max_pool_ceil(torch.zeros(1, 5, 5, 1), 2, 2, 1)


@pytest.mark.parametrize("in_hw, out_hw", [((5, 5), (33, 33)), ((6, 8), (41, 57)),
                                           ((1, 4), (9, 9))])
def test_upsample_align_corners_matches_jax(in_hw, out_hw):
    x = np.random.RandomState(4).randn(2, *in_hw, 4).astype(np.float32)
    ref = np.asarray(jcommon.upsample_bilinear_align_corners(jnp.asarray(x), out_hw))
    out = tcommon.upsample_bilinear_align_corners(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_bn_matches_jax(dtype):
    """f32 against flax's BatchNorm (use_running_average); bf16 against the
    JAX package's compute-dtype affine, to bf16 rounding (2^-7 relative), and
    the output must stay bf16."""
    rng = np.random.RandomState(5)
    c = 6
    x = rng.randn(2, 5, 7, c).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.uniform(-0.2, 0.2, c)}
    s = {"mean": rng.uniform(-0.5, 0.5, c), "var": rng.uniform(0.5, 2.0, c)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    s = {k: v.astype(np.float32) for k, v in s.items()}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    bn = jcommon.batch_norm(True, "bn", jdt)
    ref = np.asarray(bn.apply({"params": p, "batch_stats": s},
                              jnp.asarray(x, jdt or jnp.float32)), np.float32)
    tbn = tcommon.FrozenBatchNorm2d(c)
    tbn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                         "bias": torch.from_numpy(p["bias"]),
                         "running_mean": torch.from_numpy(s["mean"]),
                         "running_var": torch.from_numpy(s["var"])})
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = tbn(xt).permute(0, 2, 3, 1)
    assert out.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7, atol=2 ** -7)


def _r101_shapes_and_labels():
    jmodel = jdl.resnet101_deeplab_imagenet(21, pretrained=False)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), input_hw=(65, 65)))
    with torch.device("meta"):
        tmodel = tdl.resnet101_deeplab_imagenet(21, pretrained=False)
    return shapes, tmodel


def test_r101_bridge_shapes():
    """Full-width R101: every JAX leaf maps to a port state_dict entry of the
    transposed shape, and nothing is left over (eval_shape: no compile)."""
    shapes, tmodel = _r101_shapes_and_labels()
    sd = tmodel.module.state_dict()
    mapped = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes[coll]):
            keys = tuple(str(k.key) for k in path)
            shape = leaf.shape
            if keys[-1] == "kernel":
                shape = (shape[3], shape[2], shape[0], shape[1])
            mapped[weights.torch_key(keys)] = shape
    assert set(mapped) == set(sd)
    for k, shape in mapped.items():
        assert tuple(sd[k].shape) == shape, k
    assert sum(int(np.prod(s)) for s in mapped.values()) > 42_000_000


def test_param_label_matches_jax():
    shapes, tmodel = _r101_shapes_and_labels()
    jlabels = jdl._param_label(shapes["params"])
    expected = {weights.torch_key(tuple(str(k.key) for k in path)): lab
                for path, lab in jax.tree_util.tree_leaves_with_path(jlabels)}
    assert tmodel.param_label(tmodel.module) == expected
    assert set(expected.values()) == {"new", "pretrained", "frozen"}


def test_pretrained_loader_partial_shape_checked(tmp_path, monkeypatch):
    """A Hung-style checkpoint in $CUTMIX_SEG_WEIGHTS: backbone and head load
    where names and shapes match; fc.*, num_batches_tracked are ignored and a
    head of another class count is skipped."""
    layers = (1, 1, 1, 1)
    src = tdl.DeepLab2(4, layers=layers)
    sd = dict(src.state_dict())
    sd["fc.weight"] = torch.zeros(10, 2048)
    sd["bn1.num_batches_tracked"] = torch.tensor(5)
    torch.save(sd, tmp_path / "resnet101_deeplab_coco.pth")
    monkeypatch.setenv("CUTMIX_SEG_WEIGHTS", str(tmp_path))

    same = tdl.DeepLab2(4, layers=layers)
    n, s = weights.load_resnet_deeplab2(same, "resnet101_deeplab_coco")
    assert (n, s) == (len(src.state_dict()), 0)
    for k, v in src.state_dict().items():
        assert torch.equal(same.state_dict()[k], v), k

    other = tdl.DeepLab2(7, layers=layers)
    n, s = weights.load_resnet_deeplab2(other, "resnet101_deeplab_coco")
    assert s == 8 and n == len(src.state_dict()) - 8  # 4 ASPP weights + biases
