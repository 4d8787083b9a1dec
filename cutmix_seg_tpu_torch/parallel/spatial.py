"""Spatial partitioning: the image H axis split over ranks (port of
cutmix_seg_tpu.parallel.spatial).

JAX shards NHWC activations on H over a mesh axis and GSPMD inserts the
halo exchanges of the convolutions and pools and the collectives of the
resizes. torch has no GSPMD, so here each operation that reads across rows
asks for the rows it needs (``RowWindow``) and computes only the output
rows its rank owns.

Layout (a ``parallel.mesh.Mesh``): ``n_model`` ranks share each image and
rank r holds the rows of model index r % n_model; the batch is split over
the ``n_data`` data indices (r // n_model). Training (``--spatial_train S``)
uses the trainer's mesh (batch over n_data, H over S); ``--eval_spatial``
without it splits H over every rank (JAX's 1-D ``spatial_spec``). A layer
of global height h is split into balanced contiguous row ranges, the first
``h % ways`` one row longer (``split_rows``): DeepLab v2's ceil-mode pool
turns a 256-row crop into 65 and then 33 feature rows, which no even split
covers.

A module set up with ``set_spatial`` takes the local rows of its input and
returns the local rows of its output. The global height of each operation's
input is not in the local tensor, so a ``SpatialRows`` traces the network
once per input size on the meta device (global shapes, no data) and
replays the heights in call order (``begin``, ``next_op``).

``RowWindow`` is the exchange: it gives this rank the global rows [a, b) of
a layer, filled with a constant outside [0, h) (0 for a conv, -inf for the
max pool). It is built from ``all_reduce`` only, over a zero buffer of the
rows that the ranks lack (not the full h), so gloo runs it on CUDA tensors:
each rank writes the rows it owns into the other ranks' segments and the sum
is every segment's values. Its backward sends each window's gradient back to
the rows' owners the same way and sums it there. A window may reach past the
neighbouring rank (ASPP dilation 24 on a 33-row map split 17/16).

Sums over pixels (the CE's valid count, the gate sums, training BN's
statistics, the gradients) stay all-reduces over the whole world: the ranks
hold disjoint pixels, so the world's sum is the global one. The row
exchanges, the eval's gather of predicted rows, the sums of a per-image
reduction (DeepLab v3's image pooling, VAT's per-sample norms) and aug_mt's
gather of the teacher's logits run over the model group (``model_group``).

A step receives its data index's full crops: per-sample draws and
reductions over the whole crop (CutMix's blend, ICT's mix, VAT's noise and
adaptive radius, aug_mt's warp of the valid mask) run on them, and then
``slice_batch_h`` keeps this rank's rows of the image-shaped inputs.
"""

from __future__ import annotations

import functools
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cutmix_seg_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "split_rows",
    "spatial_h_axis_size",
    "spatial_batch_axis_size",
    "eval_mesh",
    "pad_batch_h",
    "local_h_rows",
    "slice_h",
    "slice_batch_h",
    "gather_h",
    "model_group",
    "RowWindow",
    "SpatialRows",
    "rows_for",
    "check_supported",
    "set_spatial",
    "A6C",
]

A6C = "ROADMAP A6c"


def split_rows(h: int, ways: int) -> List[Tuple[int, int]]:
    """Each model index's [lo, hi) rows of a global height h: contiguous and
    balanced, the first ``h % ways`` ranges one row longer."""
    base, extra = divmod(h, ways)
    out, lo = [], 0
    for m in range(ways):
        hi = lo + base + (m < extra)
        out.append((lo, hi))
        lo = hi
    return out


def spatial_h_axis_size(mesh: Mesh) -> int:
    """Number of ways the image H axis is split in spatial mode."""
    return mesh.n_model if mesh.n_model > 1 else mesh.size


def spatial_batch_axis_size(mesh: Mesh) -> int:
    """Number of ways the batch axis is split in spatial mode."""
    return mesh.n_data if mesh.n_model > 1 else 1


def eval_mesh(mesh: Mesh) -> Mesh:
    """The mesh of ``--eval_spatial``: the trainer's 2-D mesh under
    ``--spatial_train``, else H over every rank."""
    return mesh if mesh.n_model > 1 else Mesh(mesh.size, mesh.rank, mesh.size)


def pad_batch_h(batch, multiple: int):
    """Pad a raw eval batch's H axis to a multiple (host-side): canvas rows
    zero, label rows ignore (255), true ``sizes`` unchanged, so padded
    pixels stay out of the confusion matrix and the alpha-trick
    normalisation zeroes them (JAX ``pad_batch_h``)."""
    canvas, labels = np.asarray(batch["canvas"]), np.asarray(batch["labels"])
    h = canvas.shape[1]
    new_h = -(-h // multiple) * multiple
    if new_h == h:
        return batch
    pad = new_h - h
    out = dict(batch)
    out["canvas"] = np.pad(canvas, ((0, 0), (0, pad), (0, 0), (0, 0)))
    out["labels"] = np.pad(labels, ((0, 0), (0, pad), (0, 0)), constant_values=255)
    return out


def local_h_rows(h: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's [lo, hi) rows of a global height h."""
    return split_rows(h, mesh.n_model)[mesh.model_index]


def slice_h(x, mesh: Mesh):
    """This rank's rows of axis 1 (H of an NHWC image, (N, H, W) labels or
    (N, H, W, 1) masks)."""
    lo, hi = local_h_rows(x.shape[1], mesh)
    return x[:, lo:hi]


def slice_batch_h(batch: dict, mesh: Mesh, per_sample=()) -> dict:
    """This rank's rows of every image-shaped leaf of a step's batch; the
    leaves named in ``per_sample`` (mix factors, radii, pair matrices, and
    masks the step still reads whole) are kept as they are."""
    return {k: v if k in per_sample else slice_h(v, mesh) for k, v in batch.items()}


def gather_h(x_local: torch.Tensor, h: int, mesh: Mesh) -> torch.Tensor:
    """The full axis 1 (height h) of a tensor whose rows the model group
    shares, on every rank of the group (a zero-padded all-reduce)."""
    lo, hi = local_h_rows(h, mesh)
    out = x_local.new_zeros((x_local.shape[0], h) + tuple(x_local.shape[2:]))
    out[:, lo:hi] = x_local
    dist.all_reduce(out, group=model_group(mesh))
    return out


_GROUPS: Dict[Tuple[int, int], list] = {}


def model_group(mesh: Mesh):
    """The process group of this rank's model group (None: the default
    group, when one group is the world). The first call creates every
    group, on every rank, in data-index order (``new_group`` is collective)."""
    if mesh.n_data == 1:
        return None
    key = (mesh.size, mesh.n_model)
    if key not in _GROUPS:
        _GROUPS[key] = [dist.new_group(list(range(d * mesh.n_model, (d + 1) * mesh.n_model)))
                        for d in range(mesh.n_data)]
    return _GROUPS[key][mesh.data_index]


# ---- the row exchange ----


@functools.lru_cache(maxsize=None)
def _exchange_plan(h: int, ways: int, windows: Tuple[Tuple[int, int], ...]):
    """(owned rows per model index, foreign segments): each segment is
    (requester, g0, g1, buffer offset), the global rows [g0, g1) that the
    requester's window [a, b) holds inside [0, h) but does not own."""
    owns = split_rows(h, ways)
    segs, off = [], 0
    for j, ((a, b), (o0, o1)) in enumerate(zip(windows, owns)):
        for g0, g1 in ((max(a, 0), min(b, o0)), (max(a, o1), min(b, h))):
            if g1 > g0:
                segs.append((j, g0, g1, off))
                off += g1 - g0
    return owns, tuple(segs), off


class _Exchange:
    """One window request: this rank's window [a, b) of a layer of height h
    over the model group (every rank's windows define the buffer)."""

    def __init__(self, h: int, windows, index: int, fill: float, group):
        self.owns, self.segs, self.n_buf = _exchange_plan(h, len(windows), tuple(windows))
        self.h, self.index, self.fill, self.group = h, index, fill, group
        self.a, self.b = windows[index]
        self.o0, self.o1 = self.owns[index]

    def _mine(self, g0, g1):
        """The rows of [g0, g1) that this rank owns."""
        return max(g0, self.o0), min(g1, self.o1)

    def _pack(self, x: torch.Tensor, requester_is_me: bool) -> torch.Tensor:
        """The buffer with this rank's share written: the rows it owns in
        the other ranks' segments (forward), or its own segments' values
        (backward: x is the window's gradient)."""
        n, c, _, w = x.shape
        buf = x.new_zeros((n, c, self.n_buf, w))
        for j, g0, g1, off in self.segs:
            if requester_is_me:
                if j == self.index:
                    buf[:, :, off:off + g1 - g0] = x[:, :, g0 - self.a:g1 - self.a]
            else:
                r0, r1 = self._mine(g0, g1)
                if r1 > r0:
                    buf[:, :, off + r0 - g0:off + r1 - g0] = x[:, :, r0 - self.o0:r1 - self.o0]
        return buf

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        buf = None
        if self.segs:
            buf = self._pack(x, requester_is_me=False)
            dist.all_reduce(buf, group=self.group)
        mine = {(g0, g1): off for j, g0, g1, off in self.segs if j == self.index}
        n, c, _, w = x.shape
        a, b, h, o0, o1 = self.a, self.b, self.h, self.o0, self.o1
        pieces = []
        if min(b, 0) > a:
            pieces.append(x.new_full((n, c, min(b, 0) - a, w), self.fill))
        for g0, g1 in ((max(a, 0), min(b, o0)), (max(a, o0), min(b, o1)),
                       (max(a, o1), min(b, h))):
            if g1 <= g0:
                continue
            if (g0, g1) in mine:
                off = mine[(g0, g1)]
                pieces.append(buf[:, :, off:off + g1 - g0])
            else:  # this rank's own rows
                pieces.append(x[:, :, g0 - o0:g1 - o0])
        if b > max(a, h):
            pieces.append(x.new_full((n, c, b - max(a, h), w), self.fill))
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)
        if x.is_contiguous(memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    def backward(self, grad: torch.Tensor, x_shape) -> torch.Tensor:
        gx = grad.new_zeros(x_shape)
        r0, r1 = max(self.a, self.o0), min(self.b, self.o1)
        if r1 > r0:
            gx[:, :, r0 - self.o0:r1 - self.o0] += grad[:, :, r0 - self.a:r1 - self.a]
        if self.segs:
            buf = self._pack(grad, requester_is_me=True)
            dist.all_reduce(buf, group=self.group)
            for j, g0, g1, off in self.segs:
                m0, m1 = self._mine(g0, g1)
                if j != self.index and m1 > m0:
                    gx[:, :, m0 - self.o0:m1 - self.o0] += buf[:, :, off + m0 - g0:off + m1 - g0]
        return gx


class RowWindow(torch.autograd.Function):
    """``apply(x, exchange)``: the window of ``exchange`` (an ``_Exchange``)
    from this rank's rows x (N, C, rows, W)."""

    @staticmethod
    def forward(ctx, x, exchange):
        ctx.exchange, ctx.x_shape = exchange, x.shape
        return exchange.forward(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.exchange.backward(grad.contiguous(), ctx.x_shape), None


# ---- the network's heights ----


class SpatialRows:
    """What a module set up with ``set_spatial`` needs: the model group (its
    size ``ways`` and this rank's ``index``), and the global heights of the
    running forward's operations, from a meta-device trace per input size.

    ``begin(net, x)`` at the top of the network's forward (x: this rank's
    NHWC rows); each cross-row operation then calls ``next_op(local_h)`` for
    its (input, output) global heights, or, while ``tracing``, ``record``
    them and computes on the meta tensors it is given."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.ways, self.index = mesh.n_model, mesh.model_index
        self.group = model_group(mesh)
        self.tracing = False
        # per network (weakly held) and input size: the traced heights
        self._plans: "weakref.WeakKeyDictionary[torch.nn.Module, dict]" = \
            weakref.WeakKeyDictionary()
        self._plan: list = []
        self._i = 0

    def __deepcopy__(self, memo):  # shared, as the process group is
        return self

    def begin(self, net: torch.nn.Module, x: torch.Tensor, h: Optional[int] = None) -> None:
        """Start a forward of ``net`` on this rank's rows x (NHWC) of a
        global height h (default: an even split)."""
        if self.tracing:
            return
        h = x.shape[1] * self.ways if h is None else h
        lo, hi = self.own(h)
        if x.shape[1] != hi - lo:
            raise ValueError(f"{x.shape[1]} input rows are not this rank's of {h}")
        plans = self._plans.setdefault(net, {})
        key = (h,) + tuple(x.shape[2:])
        if key not in plans:
            self.tracing, self._plan = True, []
            try:
                with torch.no_grad():
                    net(torch.empty((1,) + key, dtype=x.dtype, device="meta"))
            finally:
                self.tracing = False
            plans[key] = self._plan
        self._plan, self._i = plans[key], 0

    def record(self, h_in: int, h_out: int) -> None:
        if h_out < self.ways:
            raise ValueError(f"spatial op {len(self._plan) + 1} (input of {h_in} rows): "
                             f"a layer of {h_out} rows cannot split {self.ways} ways; "
                             "a taller input gives every layer enough rows")
        self._plan.append((h_in, h_out))

    def next_op(self, local_h: int) -> Tuple[int, int]:
        h_in, h_out = self._plan[self._i]
        self._i += 1
        lo, hi = self.own(h_in)
        if local_h != hi - lo:
            raise RuntimeError(f"spatial op {self._i}: {local_h} rows, expected {hi - lo} "
                               f"of {h_in} (the forward left its traced order)")
        return h_in, h_out

    def own(self, h: int) -> Tuple[int, int]:
        return split_rows(h, self.ways)[self.index]

    def window(self, x: torch.Tensor, h: int, windows, fill: float) -> torch.Tensor:
        """This rank's window of ``windows`` (every model index's [a, b) of
        a layer of global height h) from its rows x (N, C, rows, W)."""
        ex = _Exchange(h, windows, self.index, fill, self.group)
        if not ex.segs and (ex.a, ex.b) == (ex.o0, ex.o1):
            return x
        return RowWindow.apply(x, ex)


_ROWS: Dict[Mesh, SpatialRows] = {}


def rows_for(mesh: Mesh) -> SpatialRows:
    """The SpatialRows of a mesh (one per mesh, so the traces are kept)."""
    if mesh not in _ROWS:
        _ROWS[mesh] = SpatialRows(mesh)
    return _ROWS[mesh]


def check_supported(module: torch.nn.Module) -> None:
    """Raise, naming ROADMAP A6c, for a network without the spatial forms
    of all its cross-row operations (``supports_spatial``: every network
    of the JAX package's architectures has it; one registered outside them
    may not)."""
    if not getattr(module, "supports_spatial", False):
        raise NotImplementedError(
            f"spatial partitioning of {type(module).__name__}: it does not declare "
            f"supports_spatial (the spatial forms of its cross-row operations; {A6C})")


def set_spatial(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Split the H axis of ``module``'s forward over ``mesh``'s model group
    (None, or a mesh of one model rank: the plain forward). Only networks
    whose every cross-row operation has a spatial form take it (every
    architecture of the JAX package); another raises naming ROADMAP A6c."""
    rows = rows_for(mesh) if mesh is not None and mesh.n_model > 1 else None
    if rows is not None:
        check_supported(module)
    for m in module.modules():
        if "spatial" in m.__dict__:
            m.spatial = rows


def interp_matrix_align_corners(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 bilinear weights with align_corners=True (a
    copy of the JAX package's ``_interp_matrix_align_corners``)."""
    if n_out == 1 or n_in == 1:
        m = np.zeros((n_out, n_in), dtype=np.float32)
        m[:, 0] = 1.0
        return m
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    m = np.zeros((n_out, n_in), dtype=np.float32)
    m[np.arange(n_out), lo] += (1.0 - frac).astype(np.float32)
    m[np.arange(n_out), hi] += frac.astype(np.float32)
    return m


def interp_matrix_half_pixel(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 bilinear weights with half-pixel centres and no
    antialiasing: output i reads the two source pixels around
    (i + 0.5) * n_in / n_out - 0.5, clamped into the image (torch's
    align_corners=False; ``jax.image.resize``'s 'linear' renormalises its
    edge taps onto the edge pixel alike)."""
    src = np.maximum((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    m = np.zeros((n_out, n_in), dtype=np.float64)
    np.add.at(m, (np.arange(n_out), lo), 1.0 - frac)
    np.add.at(m, (np.arange(n_out), hi), frac)
    return m.astype(np.float32)
