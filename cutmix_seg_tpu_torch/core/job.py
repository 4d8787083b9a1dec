"""Run-directory management, stdout/stderr tee, duplicate-job skip.

Same operational contract as the reference's job_helper
(reference: job_helper.py:14-146): results/<job_name>/<job_desc>/ holds the
run; stdout+stderr tee into log_<desc>.txt; if that log already exists the
job is considered already-run and is skipped. Adds what the reference lacks
(SURVEY.md §5): structured JSONL metrics next to the log and a checkpoint
directory for resumable runs.

In a run of several processes (torchrun; ``parallel.mesh``) the process
group is joined first; rank 0 decides the run directory's name and whether
the job already ran, every rank follows that decision, and only rank 0
creates the directory and writes the log.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

from cutmix_seg_tpu_torch.parallel import mesh


class Tee:
    def __init__(self, stream, path):
        self.stream = stream
        self.file = open(path, "a")

    def write(self, data):
        self.stream.write(data)
        self.file.write(data)
        self.file.flush()

    def flush(self):
        self.stream.flush()
        self.file.flush()


class RunContext:
    def __init__(self, run_dir: str, desc: str):
        self.run_dir = run_dir
        self.desc = desc
        self.metrics_path = os.path.join(run_dir, f"metrics_{desc}.jsonl")
        self.checkpoint_dir = os.path.join(run_dir, "checkpoints")

    def log_metrics(self, record: dict):
        record = dict(record)
        record.setdefault("time", time.time())
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")


def submit(job_name: str, job_desc: str, fn, params: dict,
           results_root: str = "results",
           skip_if_log_exists: bool = True) -> Optional[object]:
    """Create the run dir, tee logs, dedup-skip, and invoke fn(ctx, **params).

    Mirrors job_helper.job(...).submit(...) (reference: job_helper.py:86-146).
    """
    mesh.maybe_initialize_distributed(params.get("device"))
    lead = mesh.is_lead()
    desc = job_desc if job_desc else time.strftime(
        "%Y%m%d_%H%M%S", time.localtime(mesh.lead_value(time.time())))
    run_dir = os.path.join(results_root, job_name, desc)
    log_path = os.path.join(run_dir, f"log_{desc}.txt")

    # --resume must target the SAME run dir (that is where the checkpoints
    # live), so an explicit resume overrides the already-run dedup; the log
    # tee appends, preserving the earlier epochs' output
    if params.get("resume"):
        skip_if_log_exists = False
    already = skip_if_log_exists and lead and os.path.exists(log_path)
    if mesh.lead_value(float(already)):
        print(f"Job {job_name}/{desc} already run (log exists at {log_path}); skipping.")
        return None

    ctx = RunContext(run_dir, desc)
    if not lead:
        return fn(ctx, **params)
    os.makedirs(run_dir, exist_ok=True)
    os.makedirs(ctx.checkpoint_dir, exist_ok=True)

    old_out, old_err = sys.stdout, sys.stderr
    tee_out = Tee(old_out, log_path)
    sys.stdout = tee_out
    sys.stderr = Tee(old_err, log_path)
    try:
        print(f"Job {job_name}/{desc} starting in {run_dir}")
        return fn(ctx, **params)
    finally:
        sys.stdout = old_out
        sys.stderr = old_err
