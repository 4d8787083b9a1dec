"""The ``deeplab2`` family's ResNet trunk (``reference/families/deeplab2.py``)
against the port's backbone (``cutmix_seg_tpu_torch.models.resnet``) at one
block per stage, in float32 with BN from running statistics: every stage's
output under the names that a family importing the trunk reads."""

import torch

from benchmark import weights
from benchmark.reference import models
from benchmark.reference.families import deeplab2

LAYERS = (1, 1, 1, 1)


def test_trunk_follows_the_port():
    from cutmix_seg_tpu_torch.models.resnet import ResNetBackbone

    leaves = deeplab2.trunk_leaves(LAYERS, "frozen")
    W = weights.make(leaves, 2**31 + 5, {"classifier_gain": 1.0, "residual_gain": 0.2}, "cpu")
    port = ResNetBackbone(LAYERS).eval()
    port.load_state_dict(W)
    P = {lf.name: W[lf.name] for lf in leaves if lf.group != "buffer"}
    B = {lf.name: W[lf.name] for lf in leaves if lf.group == "buffer"}
    x = torch.randn(2, 3, 36, 41, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = port.taps(x)
        got = deeplab2.trunk(LAYERS, P, B, x, models.Mode())
    assert list(got) == [f"layer{i}" for i in range(1, 5)]
    for name, t in got.items():
        torch.testing.assert_close(t, want[name], rtol=1e-4, atol=1e-4, msg=name)
