"""Where the time of the port's trainer iteration goes, on one GPU.

    python3 scripts/torch_trainer_profile.py [--workers 4] [--out results]

Runs the port's mask_mt trainer with the Pascal recipe of chip_smoke.py
(DeepLab v2 R101, bf16, bs 10+10+10, 321x321 crops from 512x512 canvases of
a synthetic VOC tree, random init) for one epoch of 6 iterations with
``--profile_dir``, which traces iterations 2-4 with torch.profiler. From that
trace it prints the card, the window's wall time per iteration, the host
time per iteration in each span of the engine (trainer.fetch: waiting for
the host loader; trainer.copy: pinned copies to the card; trainer.augment;
trainer.step) with the CUDA runtime calls made inside each span (time by
call: launches, copies, synchronisations, pinned allocations), the
device-busy share (union of kernel, copy and memset intervals over the
window) and device time by kernel group, and writes the summary to
``--out``/torch_trainer_profile.json. Fails if the trace holds no device
time.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from chip_smoke import RECIPE_FLAGS, VOC_TRAIN, VOC_VAL, _run_trainer  # noqa: E402
from cutmix_seg_tpu_torch.data.synthetic import write_config, write_voc_tree  # noqa: E402
from torch_step_profile import group_of  # noqa: E402

ITERS, TRACED = 6, 3  # the engine traces iterations 2-4 of the first epoch
SPANS = ("trainer.fetch", "trainer.copy", "trainer.augment", "trainer.step")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union_us(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def summarise(trace: dict) -> dict:
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] in SPANS]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device or not spans:
        raise RuntimeError("the trace holds no device events or no trainer spans")
    t0 = min(e["ts"] for e in spans)
    t1 = max(max(e["ts"] + e["dur"] for e in spans), max(e["ts"] + e["dur"] for e in device))
    wall = t1 - t0
    host = collections.Counter()
    for e in spans:
        host[e["name"]] += e["dur"]
    # CUDA runtime calls on the thread of each span, inside it
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"]
    calls = {k: collections.Counter() for k in SPANS}
    counts = {k: collections.Counter() for k in SPANS}
    for sp in spans:
        for r in runtime:
            if r["tid"] == sp["tid"] and sp["ts"] <= r["ts"] < sp["ts"] + sp["dur"]:
                calls[sp["name"]][r["name"]] += r["dur"]
                counts[sp["name"]][r["name"]] += 1
    groups = collections.Counter()
    for e in device:
        groups[group_of(e["name"]) if e["cat"] == "kernel" else e["cat"]] += e["dur"]
    busy = _union_us((e["ts"], e["ts"] + e["dur"]) for e in device)
    n = TRACED
    return {
        "iterations": n, "wall_ms_per_iter": wall / n / 1e3,
        "host_ms_per_iter": {k: host[k] / n / 1e3 for k in SPANS},
        "runtime_calls_per_iter": {
            k: {name: {"ms": us / n / 1e3, "calls": counts[k][name] / n}
                for name, us in calls[k].most_common(6)} for k in SPANS},
        "device_busy_ms_per_iter": busy / n / 1e3, "device_busy_share": busy / wall,
        "kernels_per_iter": sum(e.get("cat") == "kernel" for e in device) / n,
        "device_ms_per_iter_by_group": {g: us / n / 1e3 for g, us in groups.most_common()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, default=4, help="--num_workers of the trainer")
    ap.add_argument("--out", default="results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_trainer_profile: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    with tempfile.TemporaryDirectory(prefix="trainer_profile_") as tmp:
        voc = write_voc_tree(os.path.join(tmp, "VOC2012"), VOC_TRAIN, VOC_VAL, seed=0)
        os.environ["CUTMIX_SEG_CONFIG"] = write_config(os.path.join(tmp, "seg.cfg"), voc)
        flags = [f for f in RECIPE_FLAGS if not f.startswith("--iters_per_epoch")] + [
            "--num_epochs=1", f"--iters_per_epoch={ITERS}", f"--num_workers={args.workers}",
            f"--profile_dir={os.path.join(tmp, 'trace')}"]
        _run_trainer(os.path.join(tmp, "results"), flags, None)
        with open(os.path.join(tmp, "trace", "trace.json")) as f:
            summary = dict(summarise(json.load(f)), device=smi, num_workers=args.workers)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "torch_trainer_profile.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"window: {summary['wall_ms_per_iter']:.2f} ms/iteration wall, device busy "
          f"{summary['device_busy_ms_per_iter']:.2f} ms/iteration "
          f"({100 * summary['device_busy_share']:.1f}%), "
          f"{summary['kernels_per_iter']:.0f} kernels/iteration, --num_workers {args.workers}")
    for k, ms in summary["host_ms_per_iter"].items():
        rt = ", ".join(f"{name} {v['ms']:.2f} ms x{v['calls']:.0f}"
                       for name, v in summary["runtime_calls_per_iter"][k].items())
        print(f"  host {k:18s} {ms:8.2f} ms/iteration; CUDA runtime: {rt}")
    for g, ms in summary["device_ms_per_iter_by_group"].items():
        print(f"  device {g:26s} {ms:8.3f} ms/iteration")
    return 0


if __name__ == "__main__":
    sys.exit(main())
