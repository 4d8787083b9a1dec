"""Training-mode BatchNorm (``ops.batchnorm``): the plain version's forward
and hand-written backward against autograd of the module's former
training arithmetic (``_former_bn``: float32 promotion, fast variance,
the float32 affine, the cast, then the ReLU), at float64 and float32, with
and without the ReLU and the running update, on a batch whose fast variance
clamps to 0, with channel counts that are and are not a multiple of 8, in
channels-last and contiguous NCHW memory; the module's dispatch (the
running-average path unchanged, the ReLU of the call sites); the kernels'
tiling and layout decisions; two gloo ranks against the global batch
(``tests/_torch_ranks.py``). On the card (``-m cuda``): the kernels against
the plain version, two runs bit for bit and one launch of each kernel, on
shapes of DenseUNet-161's blocks, every BN input shape of one DenseUNet-161
forward at 10x224^2, and the layouts the vector variant does not take; and
under one and two gloo ranks sharing the card against the kernels over the
whole batch. Imports no JAX."""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from cutmix_seg_tpu_torch.models import common as tcommon
from cutmix_seg_tpu_torch.models.denseunet import DenseUNet
from cutmix_seg_tpu_torch.models.resunet import ResUNet
from cutmix_seg_tpu_torch.ops import batchnorm, build
from tests import _torch_ranks as ranks
from tests._torch_card import (
    BN_CASES,
    BN_EPS,
    BN_MOMENTUM,
    BN_SEED,
    bn_check,
    bn_run,
    densenet_bn_calls,
)

torch.set_num_threads(1)

# tolerances of the hand-written backward against autograd, by dtype: the
# same function, summed in another order
TOL = {torch.float64: dict(rtol=1e-10, atol=1e-12), torch.float32: dict(rtol=2e-5, atol=2e-6)}


def _former_bn(x, weight, bias, running, momentum, eps, mesh, relu):
    """``BatchNorm2d.forward``'s training arithmetic before the kernels, in
    x's dtype where that is float64 (float32 otherwise), for autograd
    (``batch_norm_train``'s arguments; no mesh)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xc = x.to(dt)
    mean = xc.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xc * xc).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    if running is not None:
        with torch.no_grad():
            running[0].copy_(momentum * running[0] + (1.0 - momentum) * mean)
            running[1].copy_(momentum * running[1] + (1.0 - momentum) * var)
    mul = torch.rsqrt(var + eps) * weight
    y = ((xc - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]).to(x.dtype)
    return F.relu(y) if relu else y


def _inputs(n, c, h, w, dtype, layout, seed=0, clamp=None):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c, h, w) * rng.uniform(0.2, 3.0, (1, c, 1, 1)) + rng.uniform(-1, 1,
                                                                                 (1, c, 1, 1))
    if clamp == "negative":  # E[x^2] - E[x]^2 rounds below 0 in float32 (channel 0)
        x[:, 0] = 1000.0 + 1e-3 * rng.randn(n, h, w)
    elif clamp == "constant":  # variance 0 exactly
        x[:, 0] = 1.5
    xt = torch.tensor(x, dtype=dtype)
    if layout == "channels_last":
        xt = xt.contiguous(memory_format=torch.channels_last)
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    vectors = {"weight": torch.tensor(rng.uniform(0.5, 1.5, c), dtype=pdt),
               "bias": torch.tensor(rng.uniform(-0.3, 0.3, c), dtype=pdt),
               "running_mean": torch.tensor(rng.uniform(-0.5, 0.5, c), dtype=pdt),
               "running_var": torch.tensor(rng.uniform(0.5, 2.0, c), dtype=pdt)}
    dy = torch.tensor(rng.randn(n, c, h, w), dtype=dtype)
    return xt, vectors, dy


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("c", [8, 6], ids=["c8", "c6"])
@pytest.mark.parametrize("track", [True, False], ids=["track", "kept"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_version_matches_autograd_of_the_former_arithmetic(dtype, relu, track, c,
                                                                 layout):
    """Forward bit for bit (the same tensor operations), running statistics
    bit for bit, the input, weight and bias gradients to the dtype's
    rounding."""
    x, vectors, dy = _inputs(3, c, 5, 7, dtype, layout, seed=c)
    got = bn_run(batchnorm.batch_norm_train, x, vectors, dy, relu, track)
    want = bn_run(_former_bn, x, vectors, dy, relu, track)
    for name, a, b in zip(("y", "running_mean", "running_var"), got[:1] + got[4:],
                          want[:1] + want[4:]):
        assert torch.equal(a, b), name
    for name, a, b in zip(("x_grad", "weight_grad", "bias_grad"), got[1:4], want[1:4]):
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL[dtype])
    assert got[1].stride() == x.stride()  # the gradient keeps the input's layout
    if not track:
        assert torch.equal(got[4], vectors["running_mean"])


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
@pytest.mark.parametrize("clamp", ["negative", "constant"])
def test_a_clamped_variance_takes_no_variance_gradient(clamp, relu):
    """float32 channel 0 near 1000 (fast variance below 0, clamped) or
    constant (exactly 0): its outputs, its running variance (0.9 of the old)
    and every gradient as autograd gives them through the clamp."""
    x, vectors, dy = _inputs(2, 8, 3, 4, torch.float32, "channels_last", seed=4, clamp=clamp)
    xc = x.float()
    m = xc.mean(dim=(0, 2, 3))
    var_raw = ((xc * xc).mean(dim=(0, 2, 3)) - m * m)[0].item()
    assert var_raw < 0 if clamp == "negative" else var_raw == 0.0
    got = bn_run(batchnorm.batch_norm_train, x, vectors, dy, relu)
    want = bn_run(_former_bn, x, vectors, dy, relu)
    assert torch.equal(got[0], want[0]) and torch.isfinite(got[0]).all()
    assert got[5][0].item() == np.float32(BN_MOMENTUM * np.float32(vectors["running_var"][0]))
    for name, a, b in zip(("x_grad", "weight_grad", "bias_grad"), got[1:4], want[1:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
def test_bf16_input_normalises_in_float32_and_rounds_once(relu):
    """bf16 x: the output the former arithmetic's bits (float32 statistics
    and affine, one rounding); the gradients in bf16 within two of its
    ulps of autograd's, which rounds the cast's gradient separately."""
    x, vectors, dy = _inputs(4, 16, 6, 6, torch.bfloat16, "channels_last", seed=9)
    got = bn_run(batchnorm.batch_norm_train, x, vectors, dy, relu)
    want = bn_run(_former_bn, x, vectors, dy, relu)
    assert got[0].dtype == torch.bfloat16 and torch.equal(got[0], want[0])
    assert got[1].dtype == torch.bfloat16
    scale = want[1].float().abs().max().item()
    np.testing.assert_allclose(got[1].float().numpy(), want[1].float().numpy(),
                               rtol=2 ** -7, atol=2 ** -7 * scale)
    for a, b in zip(got[2:4], want[2:4]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_the_relu_gate_is_the_forward_output():
    """Where the ReLU's output is 0 the gradient is 0, wherever it is > 0
    it passes; with the ReLU off it always passes."""
    x, vectors, dy = _inputs(2, 8, 4, 4, torch.float32, "channels_last", seed=2)
    plain = batchnorm.batch_norm_train
    y, *_ = bn_run(plain, x, vectors, dy, True, False)
    assert (y == 0).any() and (y > 0).any()
    w = torch.zeros_like(dy)
    w[y == 0] = 1.0  # a loss that reads only the zeroed outputs
    _, x_grad, weight_grad, bias_grad, _, _ = bn_run(plain, x, vectors, w, True, False)
    assert x_grad.abs().max().item() == 0.0
    assert weight_grad.abs().max().item() == 0.0 and bias_grad.abs().max().item() == 0.0
    _, _, _, bias_grad, _, _ = bn_run(plain, x, vectors, w, False, False)
    assert bias_grad.abs().min().item() > 0.0


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_the_module_dispatch(mode, relu):
    """``BatchNorm2d(x, relu)``: training mode through the plain version on
    the CPU (no kernel launch); the running-average path (frozen, eval)
    the affine as before, then F.relu."""
    x, vectors, _ = _inputs(2, 8, 3, 5, torch.float32, "channels_last", seed=5)
    bn = tcommon.BatchNorm2d(8)
    bn.load_state_dict({k: vectors[k] for k in ("weight", "bias", "running_mean",
                                                "running_var")})
    bn.train(mode != "eval")
    tcommon.set_freeze_bn(bn, mode != "train")
    launches, plain = sum(build.launch_counts.values()), batchnorm.counters()
    with torch.no_grad():
        got = bn(x, relu=relu)
        running = (vectors["running_mean"].clone(), vectors["running_var"].clone())
        if mode == "train":
            want = _former_bn(x, vectors["weight"], vectors["bias"], running, BN_MOMENTUM,
                              BN_EPS, None, relu)
        else:
            want = bn._affine(x, vectors["running_mean"], vectors["running_var"])
            want = F.relu(want) if relu else want
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, running[0]) and torch.equal(bn.running_var, running[1])
    assert sum(build.launch_counts.values()) == launches
    assert batchnorm.counters() == plain


def test_the_call_sites_fuse_the_relu():
    """DenseUNet asks every BN for the ReLU that followed it; its features
    module still returns norm5 before it; ResNet's third BN, its
    downsample and the stem's pre-ReLU tap take none."""
    seen = {}

    def spy(name):
        def hook(module, args, kwargs):
            seen[name] = kwargs.get("relu", False)
        return hook

    for model, x in ((DenseUNet(2, block_config=(1, 1, 1, 1)), torch.randn(1, 32, 32, 3)),
                     (ResUNet(2, layers=(1, 1, 1, 1)), torch.randn(1, 32, 32, 3))):
        seen.clear()
        for name, m in model.named_modules():
            if isinstance(m, tcommon.BatchNorm2d):
                m.register_forward_pre_hook(spy(name), with_kwargs=True)
        with torch.no_grad():
            model.eval()(x)
        plain = {n for n, relu in seen.items() if not relu}
        n_bn = sum(isinstance(m, tcommon.BatchNorm2d) for m in model.modules())
        assert len(seen) == n_bn
        if isinstance(model, DenseUNet):
            assert plain == set()
            feats, _ = model.features(x.permute(0, 3, 1, 2))
            assert (feats < 0).any()
        else:
            assert plain == {"backbone.bn1", "backbone.layer1.0.bn3",
                             "backbone.layer1.0.downsample.1", "backbone.layer2.0.bn3",
                             "backbone.layer2.0.downsample.1", "backbone.layer3.0.bn3",
                             "backbone.layer3.0.downsample.1", "backbone.layer4.0.bn3",
                             "backbone.layer4.0.downsample.1"}


# DenseUNet-161's BN inputs at 224^2, batch 10: (rows, channels)
DENSENET161_SHAPES = [(125440, 96), (31360, 96), (31360, 192), (31360, 336), (7840, 192),
                      (7840, 720), (1960, 384), (1960, 2064), (1960, 2112), (490, 1056),
                      (490, 2160), (490, 2208), (501760, 64), (1960, 768)]


@pytest.mark.parametrize("vec", [8, 4, 1])
@pytest.mark.parametrize("rows,c", DENSENET161_SHAPES)
def test_tiling_covers_every_row_once_and_fills_the_card(rows, c, vec):
    cv, rt, n_tiles, tile_rows = batchnorm.tiling(rows, c, vec, 132)
    assert 1 <= cv <= 32 and cv * rt <= 256 and cv * rt > 256 - cv
    assert (n_tiles - 1) * tile_rows < rows <= n_tiles * tile_rows
    groups = -(-(-(-c // vec)) // cv)
    assert groups * cv * vec >= c
    blocks = n_tiles * groups
    assert blocks <= 8 * 132 + groups  # about 8 blocks an SM
    # every row lane of a tile has a row, or the grid is as large as asked
    assert tile_rows >= rt or blocks >= 8 * 132


@pytest.mark.parametrize("case,want", [
    ("channels_last_bf16_c16", True), ("channels_last_f32_c4", True),
    ("nchw_bf16_c16", False), ("channels_last_bf16_c12", False),
    ("channels_last_f32_c6", False), ("offset_view", False)])
def test_which_tensors_take_the_vector_variant(case, want):
    dtype = torch.float32 if "f32" in case else torch.bfloat16
    c = int(case.rsplit("_c", 1)[1]) if "_c" in case else 16
    x = torch.zeros(2, c, 3, 3, dtype=dtype)
    if case.startswith("channels_last"):
        x = x.contiguous(memory_format=torch.channels_last)
    if case == "offset_view":
        x = torch.zeros(2 * 16 * 9 + 1, dtype=dtype)[1:].view(2, 3, 3, 16).permute(0, 3, 1, 2)
        assert x.is_contiguous(memory_format=torch.channels_last)
    assert batchnorm.vectorable(x) == want


@pytest.mark.parametrize("bad", ["dtype", "weight", "empty", "dims"])
def test_the_kernel_wrapper_refuses_what_the_kernels_do_not_take(bad):
    x = torch.zeros(2, 8, 3, 3, dtype=torch.float16 if bad == "dtype" else torch.bfloat16)
    weight, bias = torch.ones(8), torch.zeros(8)
    if bad == "weight":
        weight = torch.ones(8, dtype=torch.float64)
    if bad == "empty":
        x = x[:0]
    if bad == "dims":
        x = x[0]
    with pytest.raises((TypeError, ValueError)):
        batchnorm._check(x, weight, bias, None)
    with pytest.raises(ValueError):  # neither the CPU nor a card
        batchnorm.batch_norm_train(x.to("meta"), weight, bias, None, BN_MOMENTUM, BN_EPS)


# ---- two gloo ranks against the global batch ----


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = ranks.run_ranks(tmp_path_factory.mktemp("bn_train"), {"kind": "bn_train"}, 2)
    inp = ranks.bn_train_inputs()
    want = {}
    for relu in (False, True):
        vectors = {k: torch.from_numpy(inp[k].copy()) for k in ("weight", "bias",
                                                               "running_mean", "running_var")}
        res = bn_run(_former_bn, torch.from_numpy(inp["x"]), vectors,
                     torch.from_numpy(inp["w"]), relu)
        want[relu] = dict(zip(("y", "x_grad", "weight_grad", "bias_grad", "running_mean",
                               "running_var"), (t.numpy() for t in res)))
    return out, want


@pytest.mark.parametrize("what", ["y", "x_grad", "weight_grad", "bias_grad", "running_mean",
                                  "running_var"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
def test_two_ranks_match_the_global_batch(two_ranks, relu, what):
    """Each rank's rows of the output and input gradient, the summed
    weight and bias gradients and every rank's running statistics equal
    autograd of the former arithmetic over the global batch (float64)."""
    out, want = two_ranks
    for r, got in enumerate(out):
        w = want[relu][what]
        if what in ("y", "x_grad"):
            w = w[r * 3:(r + 1) * 3]
        np.testing.assert_allclose(got[relu][what], w, rtol=1e-10, atol=1e-12,
                                   err_msg=f"rank {r}")


# ---- on the card ----


CARD_CASES = [(name, relu) for name in sorted(BN_CASES) for relu in (True, False)] + [
    ("densenet161", None)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m cuda on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name,relu", CARD_CASES,
                         ids=[f"{n}-{'relu' if r else 'norelu'}" if r is not None else n
                              for n, r in CARD_CASES])
def test_kernels_match_the_plain_version_on_the_card(card, name, relu, dtype):
    """``_torch_card.bn_check``: two runs of the kernels bit for bit, one
    launch of each kernel, every leaf within ``BN_TOL`` of the plain
    version, on ``BN_CASES`` (seed ``BN_SEED``) and on every BN input shape
    of one DenseUNet-161 forward at 10x224^2 with its call's ReLU (seed =
    the shape's sorted index)."""
    if name == "densenet161":
        shapes = sorted({(shape, r) for _, shape, r, _ in densenet_bn_calls("cuda")})
        for seed, (shape, r) in enumerate(shapes):
            bn_check(shape, "channels_last", r, dtype, seed)
        return
    n, c, h, w, layout = BN_CASES[name]
    bn_check((n, c, h, w), layout, relu, dtype, BN_SEED)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
def test_kernels_under_a_mesh_on_the_card(card, world, tmp_path):
    """``_torch_ranks.bn_card_check``: gloo ranks sharing the card against
    the kernels over the whole batch in this process."""
    ranks.bn_card_check(tmp_path, world)
