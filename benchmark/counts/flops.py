"""The FLOPs of a cell's model passes, counted once on the reference at the
cell's shapes on the meta device (``torch.utils.flop_counter``): every
convolution of the forward, and of the backward what the pass needs (the
weights' gradients, or the input's for VAT's power step). They are the
benchmark's constants of the cell (``workloads/<cell>.json: counts``), the
same whatever implements the step.

    python3 -m benchmark.counts.flops --workload <cell>
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import recipe
from benchmark.reference import models


def pass_flops(model_cfg: dict, n: int, crop, grad: str, train_bn: bool) -> int:
    """FLOPs of one pass over n images of ``crop``; ``grad``: 'none' or
    'params' (the trainable weights' gradients); ``train_bn``: BN from the
    batch (the recipe without ``--freeze_bn``) or from running statistics."""
    leaves = models.leaves_of(model_cfg)
    P = {lf.name: torch.empty(lf.shape, device="meta", requires_grad=grad == "params"
                              and lf.group in ("pretrained", "new"))
         for lf in leaves if lf.group != "buffer"}
    B = {lf.name: torch.empty(lf.shape, device="meta") for lf in leaves if lf.group == "buffer"}
    x = torch.empty((n, *crop, 3), device="meta")
    with FlopCounterMode(display=False) as fc:
        out = models.forward(model_cfg, P, B, x, models.Mode(train_bn=train_bn,
                                                             update_stats=False))
        if grad == "params":
            wrt = [t for t in P.values() if t.requires_grad]
            torch.autograd.grad(out.sum(), wrt, allow_unused=True)
    return int(fc.get_total_flops())


def cell_counts(cell: dict) -> Dict[str, int]:
    """{'model_flops_per_iter', 'conv_flops_per_iter', 'cutmix_bytes'}."""
    hp = recipe.hyperparameters(cell)
    crop = recipe.geometry(hp).crop
    model_cfg = cell["config"]["model"]
    total = sum(pass_flops(model_cfg, p["batches"] * hp["batch_size"], crop, p["grad"],
                           not hp["freeze_bn"])
                for p in cell["traffic"]["model_passes"])
    blend = 0
    if cell["traffic"]["cutmix_blends"]:
        # one blend of the unlabelled batch in float32: both inputs read,
        # the output and the mask written, the boxes read
        n = hp["batch_size"] * hp["unsup_batch_ratio"]
        px = n * crop[0] * crop[1]
        blend = 3 * px * 3 * 4 + px * 4 + n * 4 * 4
    # the models' only counted operations are convolutions
    return {"model_flops_per_iter": total, "conv_flops_per_iter": total, "cutmix_bytes": blend}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    args = ap.parse_args()
    print(json.dumps(cell_counts(recipe.load_cell(args.workload))))


if __name__ == "__main__":
    main()
