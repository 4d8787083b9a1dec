"""Multi-seed training: K independent replicas of one experiment in one run
(port of cutmix_seg_tpu.parallel.multi_seed).

The paper's tables average 5 split seeds, which the reference runs as 5
single-GPU jobs. The JAX package maps its step over a leading seed axis:
``jax.vmap`` on one device, or ``shard_map`` with one seed per device. Here
each seed keeps its own ``TrainState`` and its own step (each with its own
step count):

  * on one GPU the seeds run in turn, one step each per iteration (JAX's
    vmap lowered the convolutions to grouped convolutions, which ran at
    0.89x the speed of running the seeds one after the other);
  * over N ranks (``parallel.mesh``), rank r owns the seeds r, r + N, ...,
    as the shard_map branch gives each device its seed. No collective
    touches a step; the per-seed numbers are gathered for the log.

The CutMix kernel launches once per seed per iteration (the JAX trainer
turns its Pallas kernel off under vmap).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from cutmix_seg_tpu_torch.parallel.mesh import Mesh, host_sum


def owned_seeds(n_seeds: int, mesh: Optional[Mesh]) -> List[int]:
    """The seed indices this rank trains: all of them alone, else r::N."""
    if mesh is None:
        return list(range(n_seeds))
    return list(range(mesh.rank, n_seeds, mesh.size))


def step_in_turn(steps: Dict[int, Callable], states: Dict[int, object],
                 batches: Dict[int, dict], ramp: float) -> Dict[int, dict]:
    """One step of every owned seed, in seed order: each seed's state is
    updated in place by its own step; returns each seed's metrics."""
    metrics = {}
    for k in sorted(states):
        states[k], metrics[k] = steps[k](states[k], batches[k], ramp)
    return metrics


def gather_seed_rows(rows: Dict[int, Sequence[float]], n_seeds: int,
                     width: int) -> np.ndarray:
    """(n_seeds, width) host values, each seed's row from its owner, on
    every rank (a zero-padded all-reduce)."""
    out = np.zeros((n_seeds, width))
    for k, row in rows.items():
        out[k] = row
    return host_sum(out)
