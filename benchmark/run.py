"""One run of one benchmark cell of the port (``cutmix_seg_tpu_torch``):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic and
workload files are found by the names in BENCHMARK.json. A run writes the
cell's data under $TMPDIR from the seed, builds the trainer engine from
the recipe's flags with weights made from the seed, drives its first three
iterations (read for the check) and its warm-up, then runs trainer
iterations for ``--seconds`` and ends in a synchronise. With ``--trace 1``
the window runs under ``torch.profiler`` (at most the workload's
``trace_seconds``) and the per-layer metrics are reported instead of the
end-to-end ones. Once the window has closed and the program is freed, the
reference (``benchmark/reference``, float32, TF32 off) follows the same
three iterations from the seed, and ``correct`` says whether the program's
readings lie within the cell's limits.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (window iterations), ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks`` (each compared number
beside its limit, also the last lines of standard error). Without a CUDA
device, or with fewer than the cell's chips, or with JAX or the JAX package
loaded, the run exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of the run at a fixed path inside the checkout
CACHE_DIRS = {
    "TRITON_CACHE_DIR": "build/triton",
    "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
    "TORCHINDUCTOR_CACHE_DIR": "build/inductor",
    "CUDA_CACHE_PATH": "build/cuda_cache",
}
FORBIDDEN = ("jax", "jaxlib", "flax", "cutmix_seg_tpu")
GIB = float(1 << 30)


def forbidden_loaded():
    """Top-level names of ``sys.modules`` that the port must not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def per_layer(cell: dict, summary: dict) -> dict:
    """Each per-layer metric of the cell from its reader
    (``benchmark/metrics/<name>.py``); a reader that finds nothing to read
    returns None and the metric is left out."""
    from benchmark import named

    out = {}
    for m in cell["per_layer"]:
        v = named.module_of("benchmark.metrics", m["name"]).read(summary, cell)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str) -> dict:
    import torch

    from benchmark import check, datagen, recipe, weights
    from benchmark import trace as trace_mod
    from benchmark.program import Program
    from benchmark.reference import models, pipeline, steps

    hp = recipe.hyperparameters(cell)
    geom = recipe.geometry(hp)
    model_cfg, init = cell["config"]["model"], cell["config"]["init"]
    leaves = models.leaves_of(model_cfg)
    trainable = [lf.name for lf in leaves if lf.group in steps.GROUP_SCALE]
    on_cuda = device == "cuda"
    tmp = tempfile.mkdtemp(prefix="cutmix_bench_")
    try:
        written = datagen.write(cell["config"]["data"], tmp, seed)
        paths = datagen.write_paths_config(os.path.join(tmp, "paths.cfg"), written)
        prog = Program(cell, seed, paths, os.path.join(tmp, "run"), device)
        expect = cell["workload"]["data_on_device"]
        got = "resident" if prog.resident else "streamed"
        if got != expect:
            raise RuntimeError(f"--data_on_device resolved to {got}, the cell states {expect}")
        prog.load_weights(leaves, init)
        prog.open_streams()
        first = prog.first_steps(trainable, leaves, init)
        for _ in range(cell["workload"]["warmup_iterations"]):
            prog.iterate()
        profiler = None
        length = seconds
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            length = min(seconds, cell["workload"]["trace_seconds"])
        # what the window starts from: weights, teacher, optimiser state, buffers
        state_bytes = torch.cuda.memory_allocated() if on_cuda else 0
        win = prog.window(length, profiler)
        setup_s = win["t0"] - T_START
        peak = torch.cuda.max_memory_allocated() if on_cuda else 0
        loaded = forbidden_loaded()
        finite = prog.losses_finite()
        summary = None
        if trace:
            t = time.perf_counter()
            summary = trace_mod.summarise(profiler.profiler.kineto_results.events(),
                                          win["iterations"], win["seconds"])
            _log(f"trace read in {time.perf_counter() - t:.1f} s; kernels attributed to spans: "
                 f"{summary['kernels_attributed']:.4f}")
            profiler = None
            summary["img_per_s"] = prog.batch_size * win["iterations"] / win["seconds"]
            summary["state_gib"] = state_bytes / GIB if on_cuda else None
            summary["transient_gib"] = (peak - state_bytes) / GIB if on_cuda else None
            if on_cuda and summary["busy_s"] <= 0:
                raise RuntimeError("the profiler recorded no device activity in the window")
        batch_size = prog.batch_size
        prog.close()
        del prog
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        ds = pipeline.Dataset(written["kind"], written["path"], hp["n_sup"], hp["split_path"],
                              hp["split_seed"])
        ref = steps.run(model_cfg, hp, ds, geom, weights.make(leaves, seed, init, device),
                        seed, device)
        _log(f"reference: {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    read = check.readings(first, ref)
    checks = check.verdict(read, cell["workload"]["limits"])
    correct = (all(c["ok"] for c in checks.values()) and finite and not loaded
               and win["iterations"] > 0)
    img_per_s = batch_size * win["iterations"] / win["seconds"]
    _log(f"{'traced ' if trace else ''}window: {win['iterations']} iterations, "
         f"{img_per_s!r} img/s over {win['seconds']!r} s")
    if trace:
        metrics = per_layer(cell, summary)
    else:
        metrics = {"img_per_s": {"value": img_per_s, "unit": "img/s"},
                   "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m["name"]: metrics[m["name"]] for m in cell["end_to_end"]}
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": cell["entry"]["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {"correct": bool(correct), "attempted": win["iterations"],
              "failed": 0 if finite else win["iterations"], "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        result["trace"] = {k: summary[k] for k in (
            "host_ms_per_iter", "device_ms_per_iter_by_group", "device_ms_per_iter_by_span",
            "launches_per_iter_by_span", "kernels_per_iter", "cutmix_launches")}
    result["window"] = {"iterations": win["iterations"], "seconds": win["seconds"],
                        "img_per_s": img_per_s}
    result["readings"] = read
    result["losses"] = {"program": first["losses"], "reference": ref["losses"]}
    result["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    result["loaded_forbidden"] = loaded
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = os.path.join(ROOT, rel)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import recipe

    cell = recipe.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["entry"]["chips"]:
        _log(f"benchmark: the cell needs {cell['entry']['chips']} CUDA device(s); "
             f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.cuda.reset_peak_memory_stats()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = result.pop("loaded_forbidden") or forbidden_loaded()
    if loaded:
        _log(f"benchmark: the run loaded {loaded}; the port must not import them")
        return 4
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
