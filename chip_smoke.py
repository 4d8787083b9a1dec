"""Drive the PyTorch/CUDA port (cutmix_seg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, in order; any failure exits non-zero before the result lines:
  1. build: print the card's name and power limit, compile every kernel under
     cutmix_seg_tpu_torch/csrc/ with nvcc (sm_90a) and time the build;
  2. kernel vs plain: the CutMix kernel against its plain PyTorch version on
     the card, bit-equal masks and blends, f32 and bf16, at the main-path
     shape and the edge cases (unaligned views, ragged ends, 21 channels,
     70,000 images); then timed with CUDA events at the main-path shape (L2
     flushed before each launch): the kernel in f32 and bf16 beside its
     bounds and beside torch.add of the same tensors (a bandwidth
     yardstick), the plain version, the unaligned variant, the timing's
     floor (one pixel), and the same calls after a flush that leaves L2
     clean;
  3. small model, GPU vs CPU: the tiny DeepLab v2 in f32 (TF32 off) for two
     mask_mt steps with injected rects, held against the port's own CPU run;
  4. full width: DeepLab v2 R101, bf16, the bench.py recipe at bs 10+10+10,
     321x321: 3 warm-up and 10 timed steps through create_train_state and
     make_mask_mt_step; losses finite, one kernel launch per step;
  5. the kernel summary line and, last, the device line.

Imports nothing of JAX: it runs where only PyTorch and the CUDA toolkit are.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from cutmix_seg_tpu_torch.core.train_state import OptimizerConfig, create_train_state
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig, sample_box_rects_np
from cutmix_seg_tpu_torch.models.common import SegModel
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label, resnet101_deeplab_imagenet
from cutmix_seg_tpu_torch.ops import build
from cutmix_seg_tpu_torch.ops.cutmix import KERNEL, cutmix_blend, cutmix_blend_plain
from cutmix_seg_tpu_torch.semisup.mask_mt import MaskConsistencyConfig, make_mask_mt_step

# H100 SXM data sheet: HBM rate and the float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

MAIN_SHAPE = (10, 321, 321, 3)  # bench.py: 10 unsupervised images per batch, 321^2
BATCH, CROP, NUM_CLASSES = 10, 321, 21
WARMUP, ITERS = 3, 10


def note(msg: str) -> None:
    print(msg, flush=True)


def phase_build() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    note(smi)
    t0 = time.perf_counter()
    per_source = build.build(build.sources())
    note(f"[build] {sorted(build.sources())} built in {time.perf_counter() - t0:.2f} s "
         f"(per source: { {k: round(v, 2) for k, v in per_source.items()} })")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                note(f"[build] {name}: {line.strip()}")
    return {"nvidia_smi": smi}


def _case_inputs(n, h, w, c, box_kw, dtype, seed, offset=0):
    """x0, x1 (contiguous; at a storage offset of `offset` elements, so not
    16-byte aligned when it is odd) and rects, made on the card from a seed."""
    rects = sample_box_rects_np(BoxMaskConfig(**box_kw), n, (h, w),
                                np.random.RandomState(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def image():
        buf = torch.empty(offset + n * h * w * c, dtype=dtype, device="cuda")
        buf[offset:] = torch.randn(n * h * w * c, generator=gen, device="cuda").to(dtype)
        return buf[offset:].view(n, h, w, c)

    return image(), image(), torch.from_numpy(rects).cuda()


def _time_ms(fn, flush: torch.Tensor, iters: int = 50, clean: bool = False) -> float:
    """Median device time of one call, each launch after an L2 flush: a
    write of `flush` (L2 left full of dirty lines, as in earlier runs), or,
    with `clean`, that write and then a read of it (L2 left full of clean
    lines, so the call pays no write-back of another kernel's data)."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        if clean:
            flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def _bound_ms(x0: torch.Tensor, rects: torch.Tensor):
    """(bound in ms, bytes, what bounds it) of one call: each input read and
    each output written once; box compares and the blend as f32 operations."""
    n, h, w, c = x0.shape
    n_bytes = 3 * x0.numel() * x0.element_size() + rects.numel() * 4 \
        + n * h * w * x0.element_size()
    n_ops = n * h * w * (4 * rects.shape[1] + 3 * c)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), n_bytes, "bytes" if bytes_ms >= ops_ms else "operations"


def phase_kernel_vs_plain() -> dict:
    # name: (n, h, w, c, box config, invert, storage offset of x0 and x1)
    half = dict(prop_range=(0.5, 0.5))
    cases = {
        "main_path": (*MAIN_SHAPE, half, True, 0),
        "two_boxes_64": (4, 64, 64, 3, dict(prop_range=(0.25, 0.75), n_boxes=2), True, 0),
        "odd_height_no_invert": (2, 33, 48, 1, dict(prop_range=(0.5, 0.5), invert=False),
                                 False, 0),
        "outside_bounds": (6, 40, 52, 3, dict(prop_range=(0.3, 0.9), n_boxes=2,
                                              within_bounds=False), True, 0),
        # not 16-byte aligned: the kernel's one-element variant
        "offset_view": (*MAIN_SHAPE, half, True, 1),
        # 2907 elements: a ragged end in f32 and bf16, vectors across samples
        "tail_and_straddle": (3, 17, 19, 3, half, True, 0),
        "c21": (2, 41, 41, 21, half, True, 0),
        # past the 65,535 grid-y limit of the per-sample grid
        "batch_70000": (70000, 2, 3, 1, half, True, 0),
    }
    max_err = 0.0
    for seed, (name, (n, h, w, c, box_kw, invert, offset)) in enumerate(sorted(cases.items())):
        for dtype in (torch.float32, torch.bfloat16):
            x0, x1, rects = _case_inputs(n, h, w, c, box_kw, dtype, seed, offset)
            if name == "outside_bounds" and not bool((rects < 0).any()):
                raise RuntimeError("outside_bounds case has no negative coordinate")
            mix_k, m_k = cutmix_blend(x0, x1, rects, invert)
            mix_p, m_p = cutmix_blend_plain(x0, x1, rects, invert)
            torch.cuda.synchronize()
            err = max((mix_k.float() - mix_p.float()).abs().max().item(),
                      (m_k.float() - m_p.float()).abs().max().item())
            max_err = max(max_err, err)
            equal = torch.equal(mix_k, mix_p) and torch.equal(m_k, m_p)
            note(f"[kernel] {name} {str(dtype)[6:]} {tuple(x0.shape)} B={rects.shape[1]} "
                 f"offset={offset}: bit-equal={equal} max_abs_err={err}")
            if not equal:
                raise RuntimeError(f"cutmix_blend kernel != plain on {name} {dtype}")

    # timing at the main-path shape (one box), L2 flushed before each launch
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    x0, x1, rects = _case_inputs(*MAIN_SHAPE, half, torch.float32, 0)
    b0, b1 = x0.bfloat16(), x1.bfloat16()
    out, out_b = torch.empty_like(x0), torch.empty_like(b0)
    calls = {  # name: (call, bytes it moves)
        "kernel f32": (lambda: cutmix_blend(x0, x1, rects), _bound_ms(x0, rects)[1]),
        "kernel bf16": (lambda: cutmix_blend(b0, b1, rects), _bound_ms(b0, rects)[1]),
        # bandwidth yardstick: one PyTorch call that reads two such tensors
        # and writes one (37.09 MB of the kernel's 41.22 in f32); it computes
        # another function and nothing in the port calls it
        "torch.add f32": (lambda: torch.add(x0, x1, out=out), 3 * x0.numel() * 4),
        "torch.add bf16": (lambda: torch.add(b0, b1, out=out_b), 3 * b0.numel() * 2),
    }
    ms = {name: _time_ms(fn, flush) for name, (fn, _) in calls.items()}
    gbps = {name: nb / ms[name] / 1e6 for name, (_, nb) in calls.items()}
    plain_ms = _time_ms(lambda: cutmix_blend_plain(x0, x1, rects), flush)
    bound_ms, n_bytes, bound_by = _bound_ms(x0, rects)
    bf16_bound_ms, bf16_bytes, _ = _bound_ms(b0, rects)
    for dt, bound, nb in (("f32", bound_ms, n_bytes), ("bf16", bf16_bound_ms, bf16_bytes)):
        k = f"kernel {dt}"
        note(f"[kernel] main path {dt} {MAIN_SHAPE}: kernel {ms[k] * 1e3:.2f} us, bound "
             f"{bound * 1e3:.2f} us ({nb / 1e6:.2f} MB at 3.35 TB/s; {gbps[k]:.1f} GB/s achieved, "
             f"{bound / ms[k]:.1%} of the bound); yardstick torch.add {dt} "
             f"{ms[f'torch.add {dt}'] * 1e3:.2f} us, {gbps[f'torch.add {dt}']:.1f} GB/s: the "
             f"kernel's rate is {gbps[k] / gbps[f'torch.add {dt}']:.1%} of it")
    note(f"[kernel] plain version f32: {plain_ms * 1e3:.2f} us")

    xu0, xu1, _ = _case_inputs(*MAIN_SHAPE, half, torch.float32, 0, offset=1)
    unaligned_ms = _time_ms(lambda: cutmix_blend(xu0, xu1, rects), flush)
    note(f"[kernel] main path f32, x0/x1 at offset 1 (one-element variant): "
         f"{unaligned_ms * 1e3:.2f} us, {n_bytes / unaligned_ms / 1e6:.1f} GB/s")
    # what this timing gives a call that moves almost nothing
    p0, p1, pr = _case_inputs(1, 1, 1, 1, half, torch.float32, 0)
    floor_ms = _time_ms(lambda: cutmix_blend(p0, p1, pr), flush)
    one, one_out = torch.ones(1, device="cuda"), torch.empty(1, device="cuda")
    add1_ms = _time_ms(lambda: torch.add(one, one, out=one_out), flush)
    note(f"[kernel] floor of this timing: the kernel on 1 pixel {floor_ms * 1e3:.2f} us, "
         f"torch.add of 1 element {add1_ms * 1e3:.2f} us")
    clean = {name: _time_ms(fn, flush, clean=True) for name, (fn, _) in calls.items()}
    note("[kernel] with L2 left clean before each launch: " + ", ".join(
        f"{name} {t * 1e3:.2f} us ({calls[name][1] / t / 1e6:.1f} GB/s)"
        for name, t in clean.items()))
    return {"max_abs_err": max_err, "ms": ms["kernel f32"], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ms_bf16": ms["kernel bf16"],
            "bound_ms_bf16": bf16_bound_ms, "yardstick_gbps": gbps["torch.add f32"]}


def _tiny_state(device, sd):
    model = SegModel("tiny", DeepLab2(4, layers=(1, 1, 1, 1)), np.zeros(3), np.ones(3),
                     (1, 1), _param_label)
    state, opt = create_train_state(model, OptimizerConfig(learning_rate=3e-4), 0,
                                    device=device, pretrained=False)
    state.student.load_state_dict(sd)
    state.teacher.load_state_dict(sd)
    return model, state, opt


def _tiny_weights(seed):
    """He-scaled convs (classifier x0.1) and random frozen-BN statistics, so
    the random model has O(1) logits and its confidence gate is exercised."""
    rng = np.random.RandomState(seed)
    sd = DeepLab2(4, layers=(1, 1, 1, 1)).state_dict()
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        if v.dim() == 4:
            gain = 0.1 if k.startswith("layer5") else 1.0
            val = rng.randn(*shape) * gain * math.sqrt(2.0 / np.prod(shape[1:]))
        elif k.endswith("running_var"):
            val = rng.uniform(0.5, 2.0, shape)
        elif k.endswith("running_mean"):
            val = rng.uniform(-0.5, 0.5, shape)
        elif k.endswith("weight"):
            val = rng.uniform(0.5, 1.5, shape)
        else:
            val = rng.uniform(-0.2, 0.2, shape)
        out[k] = torch.from_numpy(val.astype(np.float32))
    return out


def phase_small_step() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, h, w, steps, lr = 2, 33, 33, 2, 3e-4
    rng = np.random.RandomState(0)
    nb = {"sup_x": rng.randn(n, h, w, 3).astype(np.float32),
          "sup_y": rng.randint(0, 4, size=(n, h, w)).astype(np.int64),
          "um0": (rng.rand(n, h, w, 1) > 0.2).astype(np.float32),
          "um1": (rng.rand(n, h, w, 1) > 0.2).astype(np.float32)}
    for k in ("ux0", "ux1"):
        nb[f"{k}_tea"] = nb[f"{k}_stu"] = rng.randn(n, h, w, 3).astype(np.float32)
    rects = [sample_box_rects_np(BoxMaskConfig((0.5, 0.5)), n, (h, w), rng)
             for _ in range(steps)]
    cfg = MaskConsistencyConfig(conf_thresh=0.34)
    sd = _tiny_weights(3)
    runs = {}
    for device in ("cpu", "cuda"):
        model, state, opt = _tiny_state(device, sd)
        step = make_mask_mt_step(model, opt, cfg)
        batch = {k: torch.from_numpy(v).to(device) for k, v in nb.items()}
        metrics = []
        for r in rects:
            state, m = step(state, batch, 1.0, rects=torch.from_numpy(r).to(device))
            metrics.append({k: v.item() for k, v in m.items()})
        runs[device] = (metrics, {k: v.cpu() for k, v in state.student.state_dict().items()})
    one_gate = 1.0 / (n * h * w)
    for i, (mc, mg) in enumerate(zip(runs["cpu"][0], runs["cuda"][0])):
        note(f"[small] step {i}: cpu {mc} cuda {mg}")
        # conv sums run in another order on the card: rtol 1e-4 on the CE;
        # the gate is a mean of 0/1 values, so a pixel whose confidence lies
        # within rounding of the threshold may flip: allow two flips
        ok = (math.isclose(mc["sup_loss"], mg["sup_loss"], rel_tol=1e-4)
              and abs(mc["conf_rate"] - mg["conf_rate"]) <= 2 * one_gate + 1e-7
              and math.isclose(mc["cons_loss"], mg["cons_loss"], rel_tol=1e-4 + 4 * one_gate))
        if not ok:
            raise RuntimeError(f"small-model step {i}: GPU and CPU disagree")
    # Adam moves a noise-level gradient's element by up to 2 lr per step
    worst = max((runs["cpu"][1][k] - runs["cuda"][1][k]).abs().max().item()
                for k in runs["cpu"][1])
    note(f"[small] max |param cpu - cuda| after {steps} steps: {worst:.3g} "
         f"(bound 2*lr*steps = {2 * lr * steps:.3g})")
    if worst > 2 * lr * steps + 1e-6:
        raise RuntimeError("small-model params diverge between GPU and CPU")


def make_full_step():
    """The bench.py recipe on the port: (state, step, batch) on the card."""
    torch.backends.cudnn.benchmark = True
    model = resnet101_deeplab_imagenet(NUM_CLASSES, dtype=torch.bfloat16, pretrained=False)
    state, opt = create_train_state(
        model, OptimizerConfig(opt_type="adam", learning_rate=3e-5), 0, pretrained=False)
    cfg = MaskConsistencyConfig(
        mask_mode="mix", box=BoxMaskConfig((0.5, 0.5)), cons_weight=1.0, conf_thresh=0.97,
        conf_per_pixel=False, freeze_bn=True, mean_teacher=True, teacher_alpha=0.99,
        remat_loss_chain=True, loss_softmax_dtype="bfloat16")
    step = make_mask_mt_step(model, opt, cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (BATCH, CROP, CROP, 3)
    batch = {"sup_x": torch.randn(shape, generator=gen, device="cuda"),
             "sup_y": torch.randint(0, NUM_CLASSES, shape[:3], generator=gen, device="cuda"),
             "um0": torch.ones(shape[:3] + (1,), device="cuda"),
             "um1": torch.ones(shape[:3] + (1,), device="cuda")}
    for k in ("ux0", "ux1"):
        batch[f"{k}_tea"] = batch[f"{k}_stu"] = torch.randn(shape, generator=gen, device="cuda")
    return state, step, batch


def phase_full_step() -> dict:
    state, step, batch = make_full_step()
    n_params = sum(p.numel() for p in state.student.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w0 = state.student.layer5.conv2d_list[0].weight.detach().clone()

    build.launch_counts.clear()
    t0 = time.perf_counter()
    for _ in range(WARMUP):
        state, m = step(state, batch, 1.0)
        if not all(math.isfinite(v.item()) for v in m.values()):
            raise RuntimeError(f"non-finite warm-up metrics {m}")
    warm_s = time.perf_counter() - t0
    timed = []
    t0 = time.perf_counter()
    for _ in range(ITERS):
        state, m = step(state, batch, 1.0)
        timed.append(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(build.launch_counts)

    for m in timed:
        if not all(math.isfinite(v.item()) for v in m.values()):
            raise RuntimeError(f"non-finite metrics {m}")
    if launches.get(KERNEL, 0) != WARMUP + ITERS:
        raise RuntimeError(f"expected one {KERNEL} launch per step, got {launches}")
    if state.step != WARMUP + ITERS or torch.equal(
            w0, state.student.layer5.conv2d_list[0].weight):
        raise RuntimeError("the student did not update")
    with torch.no_grad():
        logits = state.teacher(batch["ux0_tea"][:2])
    if logits.shape != (2, CROP, CROP, NUM_CLASSES) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"teacher logits {tuple(logits.shape)} not finite/expected")
    ms = dt / ITERS * 1e3
    result = {"ms_per_step": ms, "img_per_s": BATCH * ITERS / dt,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "warmup_s": warm_s, "launches": launches, "params": n_params,
              "last": {k: v.item() for k, v in timed[-1].items()}}
    note(f"[full] R101 bf16 bs {BATCH}+{BATCH}+{BATCH} {CROP}^2 ({n_params} params): "
         f"{ms:.2f} ms/step, {result['img_per_s']:.2f} img/s, peak "
         f"{result['peak_mem_gib']:.2f} GiB, warm-up {warm_s:.1f} s, launches {launches}, "
         f"last metrics {result['last']}")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_build()
    k = phase_kernel_vs_plain()
    phase_small_step()
    full = phase_full_step()
    kernels = [{
        "name": KERNEL, "route": "cuda",
        "source": "cutmix_seg_tpu_torch/csrc/cutmix_blend.cu",
        "replaces": "cutmix_seg_tpu/ops/pallas_cutmix.py:46",
        "launches": full["launches"].get(KERNEL, 0), "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "kernel_us": k["ms"] * 1e3, "plain_us": k["plain_ms"] * 1e3,
        "bound_us": k["bound_ms"] * 1e3, "ms_bf16": k["ms_bf16"],
        "bound_ms_bf16": k["bound_ms_bf16"], "yardstick_gbps": k["yardstick_gbps"],
    }]
    note(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
