"""Where the device time of the port's full-width train step goes.

    python3 scripts/torch_step_profile.py [--algorithm mask_mt] [--steps 5] [--out chiprun_out]

Builds the full-width configuration of chip_smoke.py for ``--algorithm``
(DeepLab v2 R101, bf16, 321x321; mask_mt: the bench.py recipe at bs
10+10+10; ict, vat_mt, aug_mt: the Pascal recipe's lines, phase 4b) on one
GPU, runs 3 warm-up steps, then records ``--steps`` steps with
torch.profiler (CPU + CUDA). It prints the card, the window's wall time per
step, the device-busy share (union of kernel intervals over the window),
device time by kernel group and the top kernels, and writes the summary
(``torch_step_profile_<algorithm>.json``) and a Chrome trace
(``torch_step_trace_<algorithm>.json``) to ``--out``. Fails if the trace
holds no device time.
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
from chip_smoke import make_full_step  # noqa: E402

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
    ("nchw", "layout transforms"), ("nhwc", "layout transforms"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("unrolled", "elementwise"), ("copy", "elementwise"),
)


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for sub, g in GROUPS if sub in low), "other")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--algorithm", default="mask_mt",
                    choices=["mask_mt", "ict", "vat_mt", "aug_mt"])
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

    state, step, batch = make_full_step(args.algorithm)
    for _ in range(3):
        state, m = step(state, batch, 1.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state, batch, 1.0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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
    for name, us in by_name.items():
        groups[group_of(name)] += us

    per = args.steps
    summary = {
        "device": smi, "algorithm": args.algorithm, "steps": per,
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
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"torch_step_profile_{args.algorithm}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    prof.export_chrome_trace(os.path.join(args.out, f"torch_step_trace_{args.algorithm}.json"))

    print(f"{args.algorithm} window: {summary['wall_ms_per_step']:.2f} ms/step wall, device busy "
          f"{summary['device_busy_ms_per_step']:.2f} ms/step "
          f"({100 * summary['device_busy_share']:.1f}%), "
          f"{summary['kernel_launches_per_step']:.0f} kernels/step")
    for g, ms in summary["groups_ms_per_step"].items():
        print(f"  {g:28s} {ms:8.3f} ms/step")
    for k in summary["top_kernels"]:
        print(f"  {k['ms_per_step']:8.3f} ms  x{k['launches_per_step']:<5.0f} {k['name'][:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
