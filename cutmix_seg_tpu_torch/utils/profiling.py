"""The trainers' ``--profile_dir`` trace: ``start_profile`` starts a
torch.profiler trace (CPU, and CUDA where the card is used) and
``stop_profile`` waits for the device, stops it and writes it to
``profile_dir/trace.json`` as a Chrome trace."""

from __future__ import annotations

import os

import torch


def start_profile(device: torch.device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_profile(prof: torch.profiler.profile, device: torch.device, profile_dir: str) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # flush device activity into the trace
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
