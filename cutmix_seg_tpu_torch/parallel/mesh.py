"""Data parallelism over processes, one GPU each (port of
cutmix_seg_tpu.parallel.mesh for one device per process).

The JAX trainer runs one jitted program over the GLOBAL batch, sharded over
a 'data' mesh axis: every loss, gate and batch statistic is a global one and
the state stays replicated. Its multi-host form gives each process its own
host streams and assembles the global batch from the processes' slices in
process order (``shard_batch``). Here rank r of world N (torchrun's RANK,
WORLD_SIZE and LOCAL_RANK; device ``cuda:LOCAL_RANK``) is JAX process r with
one device: its rows are rows [r*B, (r+1)*B) of the global batch, and after
every step its parameters, optimiser state, BN buffers and generator are
bit-identical to every other rank's.

A step, an augmentor or an eval pass is given a ``Mesh`` (the ranks it runs
over) or None (it runs alone: world 1 without a process group, or one seed
of the multi-seed trainer). Under a mesh:

  * per-sample draws (boxes, lambdas, noise, colour parameters) are made for
    the global batch from a generator that is identical on every rank, and
    each rank keeps its rows (``local_rows``);
  * each rank computes its share of the global loss (its numerators over
    the all-reduced denominators) and the gradients are summed over the
    ranks once per step (``all_reduce_grads``);
  * training BN all-reduces its sums through ``all_reduce_sum``, whose
    backward all-reduces the gradient.

With ``n_model`` > 1 ranks to an image (``--spatial_train``;
``parallel.spatial``) the ranks form JAX's 2-D ('data', 'model') mesh,
model minor: the rows of the global batch follow the data index
(``local_rows``), the S ranks of a data index split each image's H axis,
and every sum over pixels stays an all-reduce over the whole world.

Only ``all_reduce`` is used: it is what gloo runs on CUDA tensors too, so
two ranks can share one card over gloo. Per-rank host values are gathered
with an all-reduce of a zero-padded vector.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cutmix_seg_tpu_torch.utils.device import resolve_device


def maybe_initialize_distributed(device=None, backend: Optional[str] = None) -> bool:
    """Join the process group that torchrun's variables describe (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK picks the card): NCCL
    for a CUDA device, gloo for the CPU, or ``backend``. Without those
    variables nothing is initialised. Returns whether a group is up."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return True


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_lead() -> bool:
    """Whether this process writes the run's artifacts (rank 0)."""
    return rank() == 0


class Mesh(NamedTuple):
    """The ranks a step runs over: ``size`` processes of the default group,
    this one ``rank``, laid out as JAX's ('data', 'model') mesh with the
    model axis minor: ``n_model`` ranks split each image's H axis
    (``parallel.spatial``), and rank r has data index r // n_model and model
    index r % n_model. At ``n_model`` 1 the data index is the rank."""

    size: int
    rank: int
    n_model: int = 1

    @property
    def n_data(self) -> int:
        return self.size // self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def data_mesh(n_model: int = 1) -> Optional[Mesh]:
    """The whole process group as a Mesh (``n_model`` ranks to an image);
    None without a group."""
    return Mesh(world(), rank(), n_model) if dist.is_initialized() else None


def global_rows(n_local: int, mesh: Optional[Mesh]) -> int:
    return n_local * (1 if mesh is None else mesh.n_data)


def local_rows(x, mesh: Optional[Mesh]):
    """This rank's rows of a global array (the counterpart of
    ``shard_batch`` over the 'data' axis): rows [d*n, (d+1)*n) with d the
    data index and n = len(x) / n_data."""
    if mesh is None:
        return x
    n, rem = divmod(x.shape[0], mesh.n_data)
    if rem:
        raise ValueError(f"{x.shape[0]} rows do not split over {mesh.n_data} ranks")
    return x[mesh.data_index * n:(mesh.data_index + 1) * n]


def eval_slice(batch: dict, mesh: Optional[Mesh]) -> dict:
    """This rank's slice of an eval batch that every rank holds whole (the
    counterpart of ``shard_global_batch``)."""
    return {k: local_rows(v, mesh) for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradient too, so
    a loss that reads the global sum sends each rank's share of the
    gradient back to every rank's inputs."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return _AllReduceSum.apply(x)


def all_reduce_grads(params: Sequence[torch.Tensor],
                     extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Sum every parameter's ``.grad`` over the ranks in one flat
    all-reduce (a parameter without a gradient counts as zero, as the
    optimiser takes it). ``extra``, a small float32 vector, rides along;
    returns it summed."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    parts = [g.reshape(-1) for g in grads]
    if extra is not None:
        parts.append(extra.reshape(-1))
    flat = torch.cat(parts)
    dist.all_reduce(flat)
    offset = 0
    with torch.no_grad():
        for p, g in zip(params, grads):
            if p.grad is None:
                p.grad = g
            p.grad.copy_(flat[offset:offset + g.numel()].view(g.shape))
            offset += g.numel()
    return None if extra is None else flat[offset:]


def gather_rows(x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every data index's rows of a batch-sharded tensor, in order, on every
    rank (a zero-padded all-reduce; the model index 0 rank of each group
    contributes its rows)."""
    n = x_local.shape[0]
    out = torch.zeros((n * mesh.n_data,) + tuple(x_local.shape[1:]), dtype=x_local.dtype,
                      device=x_local.device)
    if mesh.model_index == 0:
        out[mesh.data_index * n:(mesh.data_index + 1) * n] = x_local
    dist.all_reduce(out)
    return out


def _host_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_sum(values) -> np.ndarray:
    """Host numbers summed over the ranks (float64); as given without a
    group."""
    arr = np.asarray(values, dtype=np.float64)
    if not dist.is_initialized():
        return arr
    t = torch.from_numpy(arr.copy()).to(_host_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def gather_host(value: float) -> List[float]:
    """One host number from every rank, in rank order."""
    vec = np.zeros(world())
    vec[rank()] = value
    return host_sum(vec).tolist()


def lead_value(value: float) -> float:
    """Rank 0's value of a host number, on every rank."""
    return gather_host(value)[0]
