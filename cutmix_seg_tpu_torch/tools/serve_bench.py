"""Serving-path benchmark (port of scripts/serve_bench.py): the exported
artifact's inference time per batch size on the card.

Exports the flagship DeepLab v2 R101 (21 classes, bf16, random weights from
``--seed``: no pretrained file is needed) as a serving artifact (uint8 image
-> int32 label map, symbolic batch), loads it back as a serving host would
(``torch.export.load``), and times it at several batch sizes with the input
already on the device: after WARMUP calls, the median of ``--iters`` calls,
each timed with CUDA events. ``--concrete`` also times programs
exported at a fixed batch (no symbolic dimension) at those sizes.

    python -m cutmix_seg_tpu_torch.tools.serve_bench [--hw 321,321]
        [--batches 1,4,8,16] [--out results/serve_bench.json]

Prints one JSON line: ms per call, img/s and ms/img per batch size, the
export's seconds and the artifact's MB, beside the card's name.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

import click
import torch

from cutmix_seg_tpu_torch.serve.export import (
    export_serving_artifact,
    load_serving_artifact,
    make_serving_fn,
)
from cutmix_seg_tpu_torch.tools.export_model import build_net
from cutmix_seg_tpu_torch.utils.device import resolve_device


WARMUP = 3  # calls before timing: cuDNN picks its algorithms on the first


def note(msg):
    print(msg, file=sys.stderr, flush=True)


def time_calls(call, x: torch.Tensor, iters: int) -> list:
    """ms of each of ``iters`` calls of ``call(x)`` after WARMUP calls: CUDA
    events on a CUDA input, the host clock on a CPU one."""
    for _ in range(WARMUP):
        call(x)
    samples = []
    for _ in range(iters):
        if x.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            call(x)
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            call(x)
            samples.append((time.perf_counter() - t0) * 1e3)
    return samples


def batch_record(samples: list, b: int) -> dict:
    ms = statistics.median(samples)
    return {"ms_per_call": ms, "img_per_s": b * 1e3 / ms, "ms_per_img": ms / b,
            "ms_min": min(samples), "ms_max": max(samples)}


def measure(call, batches, hw, num_classes: int, device, iters: int, seed: int = 0) -> dict:
    """Per batch size: the median ms per call, img/s and ms/img of ``call``
    on uint8 images made on the host from ``seed`` and placed on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for b in batches:
        x = torch.randint(0, 256, (b,) + tuple(hw) + (3,), dtype=torch.uint8,
                          generator=gen).to(device)
        labels = call(x)
        if labels.shape != (b,) + tuple(hw) or int(labels.max()) >= num_classes:
            raise RuntimeError(f"batch {b}: labels {tuple(labels.shape)}, max {int(labels.max())}")
        out[str(b)] = batch_record(time_calls(call, x, iters), b)
    return out


def bench(arch: str = "resnet101_deeplab_imagenet", num_classes: int = 21, hw=(321, 321),
          batches=(1, 4, 8, 16), iters: int = 20, concrete=(), artifact: str = None,
          device=None) -> dict:
    dev = resolve_device(device)
    model = build_net(arch, num_classes, None, "bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        path = artifact or os.path.join(tmp, "serve_bench.pt2")
        t0 = time.perf_counter()
        export_serving_artifact(model, hw, path, device=dev, num_classes=num_classes)
        export_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        note(f"serve_bench: exported {arch} at {tuple(hw)} in {export_s:.1f} s ({mb:.1f} MB)")
        call, _ = load_serving_artifact(path)
    results = {"arch": arch, "hw": list(hw), "dtype": "bfloat16", "device": str(dev),
               "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else None,
               "export_s": export_s, "artifact_mb": mb,
               "batches": measure(call, batches, hw, num_classes, dev, iters)}
    if concrete:
        serve = make_serving_fn(model)
        results["concrete_batches"] = {}
        for b in concrete:
            x = torch.zeros((b,) + tuple(hw) + (3,), dtype=torch.uint8, device=dev)
            fixed = torch.export.export(serve, (x,)).module()
            results["concrete_batches"].update(
                measure(fixed, [b], hw, num_classes, dev, iters))
    return results


@click.command()
@click.option("--hw", default="321,321")
@click.option("--batches", default="1,4,8,16")
@click.option("--num_classes", type=int, default=21)
@click.option("--arch", default="resnet101_deeplab_imagenet",
              help="any registry arch name (e.g. densenet161unet_imagenet)")
@click.option("--iters", type=int, default=20)
@click.option("--concrete", default="",
              help="comma list of batch sizes to also time as programs exported at "
                   "that fixed batch")
@click.option("--out", default=None, help="also write the JSON here")
@click.option("--artifact", default=None, help="keep the artifact at this path")
@click.option("--device", default="cuda")
def main(hw, batches, num_classes, arch, iters, concrete, out, artifact, device):
    results = bench(arch, num_classes, tuple(int(v) for v in hw.split(",")),
                    [int(v) for v in batches.split(",")], iters,
                    [int(v) for v in concrete.split(",") if v], artifact, device)
    print(json.dumps(results))
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
