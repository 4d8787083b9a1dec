"""The comparison that decides ``correct``: the program's first three
iterations against the reference's, read as the numbers below; a cell
compares those its ``workloads/<cell>.json`` gives a limit (set in PERF.md
from the sound runs', the control's and the faults' readings):

* ``sup_loss_gap``: the largest relative gap of a step's supervised loss;
* ``cons_loss_gap``: the same of the consistency loss;
* ``sup_loss_gap_step1``: the first step's supervised loss alone (the
  weights are still the same on both sides);
* ``cons_ungated_gap``: the consistency loss over the gate's open share
  (the recipe's gate scales the batch's masked mean by that share), so
  the threshold's flips do not enter it;
* ``grad_gap``: the worst leaf's gap between the norms of its first
  gradient as the optimiser took it, over the larger of the reference's
  norm of that leaf and of the median leaf;
* ``change_gap``: the same of each leaf's change over the three steps;
* ``teacher_change_gap``: the same of each leaf's change in the EMA
  teacher (a teacher left unchanged, or moved at another rate, reads
  about 1);
* ``grad_diff_gap``: the worst leaf's norm of the difference between the
  program's first gradient and the reference's, over the same norm as
  ``grad_gap``: first order in rounding, where the norms' gap is second
  order;
* ``grad_median_gap``, ``change_median_gap``, ``teacher_change_median_gap``,
  ``grad_diff_median_gap``:
  the median over the leaves of those gaps, steady from seed to seed where
  single leaves are noisy (the batch-statistics BN weights of DenseUNet).

Leaves whose reference gradient is under a thousandth of the median
leaf's (the unused pyramid branches, which take none) are left out of the
leaf numbers. Every number is read in every run.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

NUMBERS = ("sup_loss_gap", "cons_loss_gap", "sup_loss_gap_step1", "cons_ungated_gap",
           "grad_gap", "change_gap", "teacher_change_gap", "grad_diff_gap",
           "grad_median_gap", "change_median_gap", "teacher_change_median_gap",
           "grad_diff_median_gap")
SMALL_GRAD = 1e-3


def _rel(p: float, r: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(abs(r), 1e-12)


def _ungated(losses: dict) -> float:
    rate = losses.get("conf_rate", 0.0)
    return losses.get("cons_loss", 0.0) / rate if rate > 0 else 0.0


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> Dict[str, float]:
    med = float(np.median([ref[n] for n in keep])) if keep else 0.0
    return {n: (math.inf if not math.isfinite(prog[n])
                else abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)) for n in keep}


def _worst(gaps: Dict[str, float]) -> Dict[str, object]:
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    return {"value": top[0][1] if top else 0.0,
            "leaves": [[n, float(g)] for n, g in top]}


def readings(prog: dict, ref: dict) -> Dict[str, dict]:
    """{number: {'value', ...}} of one run."""
    steps = range(len(ref["losses"]))
    out = {
        "sup_loss_gap": {"value": max(_rel(prog["losses"][k]["sup_loss"],
                                           ref["losses"][k]["sup_loss"]) for k in steps)},
        "cons_loss_gap": {"value": max(_rel(prog["losses"][k].get("cons_loss", 0.0),
                                            ref["losses"][k]["cons_loss"]) for k in steps)},
        "sup_loss_gap_step1": {"value": _rel(prog["losses"][0]["sup_loss"],
                                             ref["losses"][0]["sup_loss"])},
        "cons_ungated_gap": {"value": max(_rel(_ungated(prog["losses"][k]),
                                               _ungated(ref["losses"][k])) for k in steps)},
    }
    med = float(np.median(list(ref["grad"].values())))
    keep = [n for n, g in ref["grad"].items() if g >= SMALL_GRAD * med]
    for key in ("grad", "change", "teacher_change"):
        gaps = _leaf_gaps(prog[key], ref[key], keep)
        out[f"{key}_gap"] = _worst(gaps)
        out[f"{key}_median_gap"] = {"value": float(np.median(list(gaps.values()))),
                                    "of_leaves": len(gaps)}
    med = float(np.median([ref["grad"][n] for n in keep])) if keep else 0.0
    diff = {}
    for n in keep:
        d = float((prog["grad_tensors"][n] - ref["grad_tensors"][n]).norm())
        diff[n] = d / max(ref["grad"][n], med, 1e-30) if math.isfinite(d) else math.inf
    out["grad_diff_gap"] = _worst(diff)
    out["grad_diff_median_gap"] = {"value": float(np.median(list(diff.values()))) if diff else 0.0,
                                   "of_leaves": len(diff)}
    return out


def verdict(read: Dict[str, dict], limits: Dict[str, float]) -> Dict[str, dict]:
    """{number: {'value', 'limit', 'ok'}}: every number the cell compares
    beside its limit."""
    out = {}
    for name in limits:
        v = float(read[name]["value"])
        lim = float(limits[name])
        out[name] = {"value": v, "limit": lim, "ok": bool(math.isfinite(v) and v <= lim)}
    return out
