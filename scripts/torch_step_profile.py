"""Where the device time of the port's full-width train step goes.

    python3 scripts/torch_step_profile.py [--algorithm mask_mt] [--steps 5] [--out chiprun_out]
    python3 scripts/torch_step_profile.py --recipe "densenet161unet ISIC"
    python3 scripts/torch_step_profile.py --recipe "deeplabv3plus Pascal" --spans

Builds the full-width step of tests/_torch_card.py for ``--algorithm``
(DeepLab v2 R101, bf16, 321x321; mask_mt: the bench.py recipe at bs
10+10+10; ict, vat_mt, aug_mt: the Pascal recipe's lines) or, with
``--recipe``, one of the recipes' CutMix lines (DenseUNet-161 ISIC with
training BN, DeepLab v3+ Pascal) on one
GPU, runs 3 warm-up steps, then records ``--steps`` steps with
torch.profiler (CPU + CUDA). It prints the card, the window's wall time per
step, the device-busy share (union of kernel intervals over the window),
device time by kernel group and the top kernels, and writes the summary
(``torch_step_profile_<name>.json``) and a Chrome trace
(``torch_step_trace_<name>.json``) to ``--out``, ``<name>`` being the
algorithm or the recipe's name with ``_`` for spaces. Fails if the trace
holds no device time.

With ``--spans`` the step's eager body runs (``GraphedStep.body``: a replay
runs no span), and the summary also splits the device ms by the model's
spans: the kernels launched inside ``model.aspp`` and ``model.decoder``
(forwards), those of the backward nodes of the ops recorded there (matched
by their autograd sequence numbers), and the rest of the step, with cuDNN's
``wgrad_alg0`` kernels in each part.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests._torch_card import RECIPE_STEPS, make_full_step, make_recipe_step  # noqa: E402
from cutmix_seg_tpu_torch.semisup.stepcore import step_scalars  # noqa: E402

SPANS = ("model.aspp", "model.decoder")
WGRAD = "wgrad_alg0"

# kernel-name substring -> group, first match wins
GROUPS = (
    ("cutmix_blend", "cutmix kernel"),
    ("multi_tensor_apply", "optimiser + EMA (foreach)"),
    ("softmax", "softmax / log-softmax"),
    ("upsample", "upsample"),
    ("max_pool", "max pool"),
    ("gather", "gather (aug_mt warps)"),
    ("reduce", "reductions"),
    ("conv", "convolution"), ("xmma", "convolution"), ("cudnn", "convolution"),
    ("gemm", "convolution"), ("cutlass", "convolution"), ("sm90", "convolution"),
    ("nvjet", "convolution"),  # cuBLASLt kernels behind the 1x1 convolutions
    ("wgrad", "convolution"), ("dgrad", "convolution"),  # e.g. wgrad_alg0_engine_NHWC
    ("nchw", "layout transforms"), ("nhwc", "layout transforms"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("unrolled", "elementwise"), ("copy", "elementwise"),
)


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for sub, g in GROUPS if sub in low), "other")


def _walk(e):
    yield e
    for c in e.cpu_children:
        yield from _walk(c)


def span_split(events) -> dict:
    """{part: {'ms', 'wgrad_alg0_ms', 'launches'}} summed over the events,
    each kernel counted once: under a span (forward), under a backward node
    of an op recorded in that span, or in the rest."""
    part_of_seq = {}
    for e in events:
        if e.name in SPANS:
            for d in _walk(e):
                if getattr(d, "sequence_nr", -1) >= 0:
                    part_of_seq[d.sequence_nr] = e.name
    part_of = {}
    for e in events:
        if e.name in SPANS:
            for d in _walk(e):
                part_of[id(d)] = e.name + " (forward)"
        elif "Backward" in e.name and not e.name.startswith("autograd::engine"):
            seq = getattr(e, "sequence_nr", -1)
            if seq in part_of_seq:
                for d in _walk(e):
                    part_of.setdefault(id(d), part_of_seq[seq] + " (backward)")
    out = collections.defaultdict(lambda: {"ms": 0.0, "wgrad_alg0_ms": 0.0, "launches": 0})
    for e in events:
        if e.device_type == DeviceType.CUDA:
            continue
        for k in e.kernels:
            part = part_of.get(id(e), "rest of the step")
            ms = k.duration / 1e3
            out[part]["ms"] += ms
            out[part]["launches"] += 1
            if WGRAD in k.name:
                out[part]["wgrad_alg0_ms"] += ms
    return dict(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algorithm", default="mask_mt",
                    choices=["mask_mt", "ict", "vat_mt", "aug_mt"])
    ap.add_argument("--recipe", choices=sorted(RECIPE_STEPS),
                    help="profile this phase-4c recipe step instead of --algorithm")
    ap.add_argument("--spans", action="store_true",
                    help="run the eager step body and split the device ms by the model's spans")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    if args.recipe:
        state, step, batch = make_recipe_step(args.recipe)[:3]
        name = args.recipe.replace(" ", "_")
    else:
        state, step, batch = make_full_step(args.algorithm)
        name = args.algorithm
    if args.spans:
        def run(state):
            return step.body(state, batch, step_scalars(step.opt, 1.0, "cuda"))
    else:
        def run(state):
            return step(state, batch, 1.0)
    for _ in range(3):
        state, m = run(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = run(state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events")
    by_name = collections.Counter()
    launches = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        launches[e.name] += 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    device_us = sum(by_name.values())
    groups = collections.Counter()
    for kernel, us in by_name.items():
        groups[group_of(kernel)] += us

    per = args.steps
    summary = {
        "device": smi, "step": name, "steps": per,
        "wall_ms_per_step": wall_us / per / 1e3,
        "device_busy_ms_per_step": busy / per / 1e3,
        "device_busy_share": busy / wall_us,
        "kernel_ms_per_step": device_us / per / 1e3,
        "kernel_launches_per_step": len(kernels) / per,
        "groups_ms_per_step": {g: us / per / 1e3 for g, us in groups.most_common()},
        "top_kernels": [{"name": n[:160], "ms_per_step": us / per / 1e3,
                         "launches_per_step": launches[n] / per}
                        for n, us in by_name.most_common(25)],
    }
    if args.spans:
        parts = span_split(events)
        total = sum(p["ms"] for p in parts.values())
        wgrad = sum(p["wgrad_alg0_ms"] for p in parts.values())
        summary["spans"] = {
            "wgrad_alg0_ms_per_step": wgrad / per,
            "wgrad_alg0_share": wgrad / total if total else None,
            "parts": {part: {k: v / per for k, v in p.items()} for part, p in sorted(parts.items())}}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"torch_step_profile_{name}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    prof.export_chrome_trace(os.path.join(args.out, f"torch_step_trace_{name}.json"))

    print(f"{name} window: {summary['wall_ms_per_step']:.2f} ms/step wall, device busy "
          f"{summary['device_busy_ms_per_step']:.2f} ms/step "
          f"({100 * summary['device_busy_share']:.1f}%), "
          f"{summary['kernel_launches_per_step']:.0f} kernels/step")
    for g, ms in summary["groups_ms_per_step"].items():
        print(f"  {g:28s} {ms:8.3f} ms/step")
    for k in summary["top_kernels"]:
        print(f"  {k['ms_per_step']:8.3f} ms  x{k['launches_per_step']:<5.0f} {k['name'][:110]}")
    if args.spans:
        print(json.dumps(summary["spans"], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
