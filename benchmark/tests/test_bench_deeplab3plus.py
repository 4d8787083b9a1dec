"""The ``deeplab3plus`` family (``reference/families/deeplab3plus.py``)
against the port (``cutmix_seg_tpu_torch.models``) at one block per stage
and full widths, in float32 with the benchmark's seeded weights: the V1.5
trunk's stage outputs, the whole forward (dropout off, and on with one
generator on both sides), BN under frozen statistics (running buffers
kept, affines trained) in the reference and in the program's step, and the
reference step handing its generator to every forward, under frozen BN
too."""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import models, steps
from benchmark.reference.families import deeplab3plus

CFG = {"family": "deeplab3plus", "layers": [1, 1, 1, 1], "num_classes": 5,
       "aspp_dilations": [12, 24, 36], "aspp_features": 256, "low_level_channels": 48,
       "dropout": 0.5}
INIT = {"classifier_gain": 1.0, "residual_gain": 0.2}
SEED = 2**31 + 5


def _weights():
    leaves = models.leaves_of(CFG)
    W = weights.make(leaves, SEED, INIT, "cpu")
    P = {lf.name: W[lf.name] for lf in leaves if lf.group != "buffer"}
    B = {lf.name: W[lf.name].clone() for lf in leaves if lf.group == "buffer"}
    return W, P, B


def _port():
    from cutmix_seg_tpu_torch.models.deeplab3 import DeepLabV3Plus

    W, P, B = _weights()
    net = DeepLabV3Plus(CFG["num_classes"], layers=tuple(CFG["layers"]))
    net.load_state_dict(W)
    # the layout the train state gives the nets (create_train_state)
    return net.to(memory_format=torch.channels_last), P, B


def _images(n=2, hw=(105, 97)):
    # 105 x 97 gives 14 x 13 maps at output stride 8: every ASPP dilation reaches taps
    return torch.randn(n, *hw, 3, generator=torch.Generator().manual_seed(5))


def test_trunk_follows_the_torchvision_backbone():
    from cutmix_seg_tpu_torch.models.resnet import ResNetBackbone

    W, P, B = _weights()
    port = ResNetBackbone(CFG["layers"], style="torchvision").eval()
    port.load_state_dict({n[len(deeplab3plus.TRUNK):]: t for n, t in W.items()
                          if n.startswith(deeplab3plus.TRUNK)})
    x = _images().permute(0, 3, 1, 2)
    with torch.no_grad():
        want = port.taps(x)
        got = deeplab3plus.trunk(CFG["layers"], P, B, x, models.Mode())
    assert list(got) == [f"layer{i}" for i in range(1, 5)]
    for name, t in got.items():
        torch.testing.assert_close(t, want[name], rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("dropout", [False, True])
def test_forward_follows_the_port(dropout):
    from cutmix_seg_tpu_torch.models import common

    net, P, B = _port()
    mode = models.Mode()
    if dropout:
        # train mode under frozen BN, as the step runs it: masks from one seed
        net.train()
        common.set_freeze_bn(net, True)
        common.set_dropout_generator(net, torch.Generator().manual_seed(9))
        mode = models.Mode(dropout_gen=torch.Generator().manual_seed(9))
    else:
        net.eval()
    x = _images()
    with torch.no_grad():
        want = net(x)
        got = models.forward(CFG, P, B, x, mode)
    assert got.shape == (2, 105, 97, CFG["num_classes"])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    if dropout:
        with torch.no_grad():
            assert not torch.allclose(got, models.forward(CFG, P, B, x, models.Mode()))


def test_reference_frozen_statistics_train_the_affines():
    _, P, B = _weights()
    before = {n: t.clone() for n, t in B.items()}
    for t in P.values():
        t.requires_grad_(True)
    models.forward(CFG, P, B, _images(), models.Mode()).square().mean().backward()
    assert all(torch.equal(B[n], before[n]) for n in B)
    leaves = models.leaves_of(CFG)
    affines = [lf.name for lf in leaves if lf.kind in ("bn_weight", "bn_bias")]
    assert affines and all(P[n].grad.abs().sum() > 0 for n in affines)
    assert {lf.name for lf in leaves if lf.group in steps.GROUP_SCALE} == set(P)


def test_program_step_under_frozen_statistics_trains_the_affines():
    from cutmix_seg_tpu_torch.core import train_state as tts
    from cutmix_seg_tpu_torch.models import common, deeplab3
    from cutmix_seg_tpu_torch.semisup import mask_mt

    model = common.SegModel("tiny", deeplab3.DeepLabV3Plus(4, layers=(1, 1, 1, 1)),
                            np.zeros(3), np.ones(3), (1, 1), deeplab3._label_imagenet)
    state, opt = tts.create_train_state(model, tts.OptimizerConfig(learning_rate=1e-3), 0,
                                        device="cpu", pretrained=False)
    step = mask_mt.make_mask_mt_step(model, opt, mask_mt.MaskConsistencyConfig(conf_thresh=0.3))
    g = torch.Generator().manual_seed(3)
    batch = {k: torch.randn(2, 33, 33, 3, generator=g)
             for k in ("sup_x", "ux0_tea", "ux0_stu", "ux1_tea", "ux1_stu")}
    batch.update(sup_y=torch.randint(0, 4, (2, 33, 33), generator=g),
                 um0=torch.ones(2, 33, 33, 1), um1=torch.ones(2, 33, 33, 1))
    before = {n: t.clone() for n, t in state.student.state_dict().items()}
    state, _ = step(state, batch, 1.0)
    after = state.student.state_dict()
    buffers = [n for n in after if n.endswith(("running_mean", "running_var"))]
    affines = [n for n in after if n.endswith(("bn.weight", "bn.bias"))]
    assert buffers and all(torch.equal(after[n], before[n]) for n in buffers)
    assert affines and all(not torch.equal(after[n], before[n]) for n in affines)


@pytest.mark.parametrize("family,train_bn", [
    ("deeplab3plus", False), ("deeplab3plus", True), ("deeplab2", False), ("denseunet", True)])
def test_the_step_hands_its_generator_to_every_forward(family, train_bn):
    seen = []

    class Nets:
        cfg = {"family": family}

        def fwd(self, teacher, x, train_bn, gen=None, update=True):
            seen.append(gen)
            return torch.zeros(*x.shape[:3], 3)

    n, hw = 2, (8, 8)
    b = {k: torch.zeros(n, *hw, 3) for k in ("ux0_stu", "ux1_stu", "ux0_tea", "ux1_tea",
                                               "sup_x")}
    b.update(um0=torch.ones(n, *hw, 1), um1=torch.ones(n, *hw, 1),
             sup_y=torch.zeros(n, *hw, dtype=torch.long))
    hp = {"mask_prop": 0.5, "conf_thresh": 0.97, "cons_weight": 1.0}
    gen = torch.Generator().manual_seed(1)
    nets = Nets()
    steps.mask_mt_losses(nets, hp, b, gen, train_bn)
    assert seen and all(g is gen for g in seen)
    assert "fwd" not in vars(nets)
