"""The readings that a cell's limits are set from, on the card at the cell's
own size, in one process, each judged by the harness's own comparison
(``check.verdict``) against the cell's committed limits:

* sound runs of the program on each seed (the lower readings);
* the control, the reference computed through float8 in the program's
  place, on the control seeds (an upper reading);
* the faults a one-chip training cell can have (``benchmark/faults.py``),
  planted in the program, on the control seeds;
* with ``--witness``, the reference in float32 against the reference in
  float64 on the control seeds: what float32's rounding alone moves.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3

Each reading is printed as one JSON line with ``correct`` and every number
beside its limit; the runs' windows are short (``--seconds``), since only
the first three iterations are read.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _line(read: dict, losses: dict, limits: dict, ok: bool = True, **extra) -> dict:
    """``correct`` by ``check.verdict`` (and ``ok``, the rest of a run's
    verdict), each compared number beside its limit, every reading."""
    from benchmark import check

    ver = check.verdict(read, limits)
    out = {k: v["value"] for k, v in read.items()}
    out["worst_leaves"] = {k: read[k]["leaves"] for k in read if "leaves" in read[k]}
    out["losses"] = losses
    return {"correct": ok and all(v["ok"] for v in ver.values()),
            "checks": {k: [v["value"], v["limit"]] for k, v in ver.items()}, **extra, **out}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="all")
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--witness", action="store_true",
                    help="the float32 reference against the float64 one on the control seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--tie-matched-reference", action="store_true")
    ap.add_argument("--compute-dtype", default="",
                    help="run the program in this dtype instead of the configuration's")
    args = ap.parse_args()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import faults, recipe, run

    for key, rel in run.CACHE_DIRS.items():
        os.environ[key] = os.path.join(ROOT, rel)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = recipe.load_cell(args.workload)
    limits = cell["workload"]["limits"]
    if args.compute_dtype:
        # the program in another dtype, TF32 off (the reference's setting)
        cell["config"]["flags"].append(f"--compute_dtype={args.compute_dtype}")
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if args.tie_matched_reference:
        faults.tie_matched_reference(faults.Patch())
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    names = list(faults.FAULTS) if args.faults == "all" else [
        f for f in args.faults.split(",") if f]

    def emit(kind, seed, line):
        print(json.dumps({"cell": args.workload, "kind": kind, "seed": seed, **line}),
              flush=True)

    def program_run(kind, seed):
        res = run.run_cell(cell, seed, args.seconds, False, "cuda")
        emit(kind, seed, _line(res["readings"], res["losses"], limits, ok=res["correct"],
                               img_per_s=res["window"]["img_per_s"]))

    for seed in seeds:
        program_run("sound" if not args.compute_dtype else "program_" + args.compute_dtype,
                    seed)
    for seed in ctl_seeds:
        if args.witness:
            w = faults.control(cell, seed, "cuda", precision="float64", as_reference=True)
            emit("float32_vs_float64", seed, _line(w["readings"], w["losses"], limits))
        if not args.no_control:
            c = faults.control(cell, seed, "cuda")
            emit("control_fp8", seed, _line(c["readings"], c["losses"], limits))
        for name in names:
            p = faults.Patch()
            faults.FAULTS[name](p)
            try:
                program_run(name, seed)
            finally:
                p.restore()
    return 0


if __name__ == "__main__":
    sys.exit(main())
