"""Shared model plumbing (port of cutmix_seg_tpu.models.common): the
segmentation-model descriptor, BatchNorm with flax's two modes, dropout from
an explicit generator, convolutions with the JAX modules' initialisers,
pooling and resizing, the additive-skip U-Net decoder and path-rule
parameter labels.

Models take and return NHWC tensors like the JAX package. Inside, an NHWC
tensor permuted to NCHW is a channels_last view, which cuDNN convolves
without a copy; the NHWC helpers below permute views, not data, and the
modules' own pieces (BN, dropout, resizes, decoder blocks) take NCHW.

A module's train/eval mode picks, as the JAX package's ``train`` flag does,
whether dropout draws masks and whether BN may use batch statistics; a
train-mode BN uses them only once ``set_freeze_bn(module, False)`` has been
called (``use_running_average = (not train) or freeze_bn``, flax's rule).
Dropout in train mode draws from the generator that
``set_dropout_generator`` gave it. The train steps set both on every call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from cutmix_seg_tpu_torch.parallel.mesh import Mesh, all_reduce_sum
from cutmix_seg_tpu_torch.parallel.spatial import (
    SpatialRows,
    interp_matrix_align_corners,
    interp_matrix_half_pixel,
    split_rows,
)

# Standard normalisation statistics.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
IMAGENET_STD = np.array([0.229, 0.224, 0.225])
# Hung et al. Caffe-style stats: BGR ImageNet means flipped to RGB, range 0..255
HUNG_CAFFE_MEAN = np.array([104.00698793, 116.66876762, 122.67891434])[::-1] / 255.0
HUNG_CAFFE_STD = np.array([1.0, 1.0, 1.0]) / 255.0


@dataclasses.dataclass
class SegModel:
    """A segmentation architecture plus its training metadata.

    module:          nn.Module; forward(x NHWC) -> (N, H, W, C) logits
    mean/std:        per-channel input normalisation (None: the dataset's)
    block_size:      (h, w) block multiple required for input padding
    param_label:     module -> {parameter name: 'pretrained'|'new'|'frozen'}
                     (pretrained gets 0.1x LR, frozen gets no updates)
    load_pretrained: optional fn(module) that fills in pretrained weights
    """

    name: str
    module: nn.Module
    mean: Optional[np.ndarray]
    std: Optional[np.ndarray]
    block_size: Tuple[int, int]
    param_label: Callable[[nn.Module], Dict[str, str]]
    load_pretrained: Optional[Callable[[nn.Module], None]] = None


def label_params_by_path(module: nn.Module, rules: Sequence[Tuple[str, str]],
                         default: str = "new") -> Dict[str, str]:
    """Label each parameter by the first (substring, label) rule matching its
    dotted name."""
    labels = {}
    for name, _ in module.named_parameters():
        labels[name] = next((lab for sub, lab in rules if sub in name), default)
    return labels


# kernel initialisers of the JAX modules: name -> flax variance_scaling scale
# (fan_in, truncated normal); 'normal' is the ResNet convs' N(0, 0.01)
_VARIANCE_SCALE = {"lecun_normal": 1.0, "he_normal": 2.0}
# std of a standard normal truncated to [-2, 2] (flax divides by it)
_TRUNC_STD = 0.87962566103423978


class Conv2d(nn.Conv2d):
    """nn.Conv2d that keeps float32 parameters and computes in the input's
    dtype (the JAX package's ``dtype`` convention). ``init`` names the JAX
    module's kernel initialiser: 'lecun_normal' (flax's default),
    'he_normal', or 'normal' (N(0, 0.01), the ResNet convs); biases start
    at 0."""

    def __init__(self, *args, init: str = "lecun_normal", **kwargs):
        if init != "normal" and init not in _VARIANCE_SCALE:
            raise ValueError(f"unknown conv initialiser {init!r}")
        self.init = init  # read by reset_parameters inside nn.Conv2d's init
        super().__init__(*args, **kwargs)
        self.spatial: Optional[SpatialRows] = None  # set_spatial: H split over ranks

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            if self.init == "normal":
                self.weight.normal_(0.0, 0.01, generator=generator)
            else:
                fan_in = self.weight[0].numel()
                std = math.sqrt(_VARIANCE_SCALE[self.init] / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        weight = self.weight.to(x.dtype)
        # a 1x1 conv of stride 1 reads only its own rows (also on the 1-row
        # map of DeepLab v3's image pooling): it convolves them as they are
        row_local = self.kernel_size[0] == 1 and self.stride[0] == 1 and self.padding[0] == 0
        if self.spatial is not None and not row_local:
            return self._forward_rows(x, weight, bias, self.spatial)
        return F.conv2d(x, weight, bias, self.stride,
                        self.padding, self.dilation, self.groups)

    def _forward_rows(self, x, weight, bias, rows: SpatialRows) -> torch.Tensor:
        """This rank's output rows: the input rows they read (output rows x
        stride -/+ the padding and the dilated extent), zero outside the
        image, convolved with no H padding."""
        if rows.tracing:
            y = F.conv2d(x, weight.to("meta"), None if bias is None else bias.to("meta"),
                         self.stride, self.padding, self.dilation, self.groups)
            rows.record(x.shape[2], y.shape[2])
            return y
        h_in, h_out = rows.next_op(x.shape[2])
        s, p, reach = self.stride[0], self.padding[0], self.dilation[0] * (self.kernel_size[0] - 1)
        win = rows.window(x, h_in, [(lo * s - p, (hi - 1) * s - p + reach + 1)
                                    for lo, hi in split_rows(h_out, rows.ways)], 0.0)
        return F.conv2d(win, weight, bias, self.stride, (0, self.padding[1]),
                        self.dilation, self.groups)


class BatchNorm2d(nn.Module):
    """flax's BatchNorm (momentum 0.9, eps 1e-5) over NCHW, with torch's
    BatchNorm2d names (``weight``, ``bias``, ``running_mean``,
    ``running_var``; no ``num_batches_tracked``), so torchvision state dicts
    load as they are.

    Running-average mode (eval, or ``freeze``): at float32 flax's
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``; in a lower compute
    dtype the channel-sized g = weight * rsqrt(var + eps) and
    b = bias - mean * g are computed in float32 and the full-tensor affine
    runs in the activation's dtype, as the JAX package's _FastFrozenBN does.

    Training mode: x promoted to float32, mean E[x], biased variance
    max(E[x^2] - E[x]^2, 0) (flax's fast variance), normalised with eps and
    cast back to x's dtype. Unless ``track`` is off, the running statistics
    become 0.9 * running + 0.1 * batch, the BIASED variance included
    (torch's batch_norm would blend in the unbiased one). Under a mesh
    (``set_bn_mesh``) the expectations are over the global batch, as the
    JAX program over the global batch computes them: the float32 sums of x
    and x^2 and the count are all-reduced through ``mesh.all_reduce_sum``,
    whose backward carries the gradient through the global statistics to
    every rank (``SyncBatchNorm`` would blend the unbiased variance in).
    """

    momentum = 0.9

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.freeze = True  # running averages in train mode too (set_freeze_bn)
        self.track = True   # a batch-statistics forward updates the running ones
        self.mesh: Optional[Mesh] = None  # batch statistics over these ranks
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_meta:  # a spatial trace of the heights (parallel.spatial)
            return x
        if not self.training or self.freeze:
            return self._affine(x, self.running_mean, self.running_var)
        x32 = x.float()
        if self.mesh is None:
            mean = x32.mean(dim=(0, 2, 3))
            var = torch.clamp_min((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        else:
            mean, var = self._global_moments(x32)
        if self.track:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        return self._affine(x32, mean, var).to(x.dtype)

    def _global_moments(self, x32: torch.Tensor):
        c = x32.shape[1]
        count = torch.full((1,), x32.numel() // c, dtype=torch.float32, device=x32.device)
        sums = all_reduce_sum(torch.cat([x32.sum(dim=(0, 2, 3)),
                                         (x32 * x32).sum(dim=(0, 2, 3)), count]))
        mean = sums[:c] / sums[2 * c]
        return mean, torch.clamp_min(sums[c:2 * c] / sums[2 * c] - mean * mean, 0.0)

    def _affine(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(var + self.eps) * self.weight
        if x.dtype == torch.float32:
            return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        b = self.bias - mean * mul
        return torch.addcmul(b.to(x.dtype)[:, None, None], x, mul.to(x.dtype)[:, None, None])


class Dropout(nn.Module):
    """flax's Dropout: in train mode ``where(keep, x / keep_prob, 0)`` in x's
    dtype (keep_prob rounded to that dtype, as JAX's weak typing does), the
    keep mask drawn by ``draw_keep`` with ``bernoulli_`` from the generator
    that ``set_dropout_generator`` gave the module. Under ``set_spatial``
    the mask is the full map's (its global height traced, in either mode),
    of which this rank keeps its rows."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.spatial: Optional[SpatialRows] = None  # set_spatial: this rank's rows of the mask

    def draw_keep(self, x: torch.Tensor) -> torch.Tensor:
        """Boolean keep mask of x's shape (and memory format)."""
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a generator: "
                               "set_dropout_generator(module, generator)")
        return torch.empty_like(x, dtype=torch.bool).bernoulli_(
            1.0 - self.rate, generator=self.generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = None
        if self.spatial is not None:  # x holds this rank's rows (NCHW)
            if self.spatial.tracing:
                self.spatial.record(x.shape[2], x.shape[2])
                return x
            h, _ = self.spatial.next_op(x.shape[2])
            rows = self.spatial.own(h) + (h,)
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = torch.tensor(1.0 - self.rate, dtype=x.dtype).item()
        if rows is None:
            keep = self.draw_keep(x)
        else:
            # the mask of the full map, in x's memory format (the element
            # order of the draw), drawn alike by the model ranks of an image
            # (one generator per data index), cut to this rank's rows
            lo, hi, h = rows
            n, c, _, w = x.shape
            fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
                   else torch.contiguous_format)
            full = torch.empty((n, c, h, w), dtype=x.dtype, device=x.device, memory_format=fmt)
            keep = self.draw_keep(full)[:, :, lo:hi]
        return torch.where(keep, x / keep_prob, 0.0)


def set_freeze_bn(module: nn.Module, freeze: bool) -> None:
    """Running-average BN in train mode too (``freeze``), or batch
    statistics (the JAX package's ``freeze_bn`` argument)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.freeze = freeze


def set_bn_mesh(module: nn.Module, mesh: Optional[Mesh]) -> None:
    """Batch statistics over the global batch of ``mesh``'s ranks (None:
    this process's batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.mesh = mesh


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


@contextlib.contextmanager
def running_stats_kept(module: nn.Module):
    """Batch-statistics forwards inside the block leave the running
    statistics as they were (the JAX pi-model discards the teacher pass's
    updated statistics)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.track = False
    try:
        yield
    finally:
        for m in bns:
            m.track = True


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """``module`` in eval mode (running-average BN, no dropout) inside the
    block, its previous mode restored after."""
    was_training = module.training
    module.eval()
    try:
        yield module
    finally:
        module.train(was_training)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Re-initialise every conv by its own initialiser from ``generator``,
    and every BN to the identity, in module order."""
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.reset_parameters(generator)
        elif isinstance(m, BatchNorm2d):
            m.reset_parameters()


def max_pool_ceil(x: torch.Tensor, window: int, stride: int,
                  padding: int, spatial: Optional[SpatialRows] = None) -> torch.Tensor:
    """Max pool with ceil-mode output size (NHWC in and out).

    The JAX version pads symmetrically, then adds the right/bottom padding
    the ceil size needs; torch's ceil_mode also drops a last window that
    would start inside the right padding. Both agree unless that happens,
    so such a configuration raises instead of silently differing.

    With ``spatial`` (x: this rank's rows), the rows of this rank's output
    windows come through the row exchange, -inf outside the image (JAX's
    padding), and pool with no H padding."""
    n, h, w, c = x.shape
    xc = x.permute(0, 3, 1, 2)
    live = spatial is not None and not spatial.tracing
    h_in, h_out = spatial.next_op(h) if live else (h, None)
    for s in (h_in, w):
        out = -(-(s + 2 * padding - window) // stride) + 1
        if (out - 1) * stride >= s + padding:
            raise ValueError(
                f"max_pool_ceil(window={window}, stride={stride}, "
                f"padding={padding}) at size {s}: torch drops a window the "
                "reference keeps")
    if not live:
        y = F.max_pool2d(xc, window, stride, padding, ceil_mode=True)
        if spatial is not None:
            spatial.record(h, y.shape[2])
        return y.permute(0, 2, 3, 1)
    win = spatial.window(xc, h_in, _pool_windows(h_out, spatial.ways, window, stride, padding),
                         float("-inf"))
    y = F.max_pool2d(win, window, stride, (0, padding), ceil_mode=True)
    return y.permute(0, 2, 3, 1)


def _pool_windows(h_out: int, ways: int, window: int, stride: int, padding: int):
    """Each model index's input rows [a, b) for its output rows of a pool."""
    return [(lo * stride - padding, (hi - 1) * stride - padding + window)
            for lo, hi in split_rows(h_out, ways)]


def max_pool_floor(x: torch.Tensor, window: int, stride: int, padding: int,
                   spatial: Optional[SpatialRows] = None) -> torch.Tensor:
    """Max pool with floor-mode output size, -inf padding (NCHW in and out):
    ``F.max_pool2d(x, window, stride, padding)``, flax's ``nn.max_pool``
    with explicit padding (the torchvision ResNet stem).

    With ``spatial`` (x: this rank's rows), the rows of this rank's output
    windows come through the row exchange, -inf outside the image."""
    if spatial is None or spatial.tracing:
        y = F.max_pool2d(x, window, stride, padding)
        if spatial is not None:
            spatial.record(x.shape[2], y.shape[2])
        return y
    h_in, h_out = spatial.next_op(x.shape[2])
    win = spatial.window(x, h_in, _pool_windows(h_out, spatial.ways, window, stride, padding),
                         float("-inf"))
    return F.max_pool2d(win, window, stride, (0, padding))


def avg_pool_floor(x: torch.Tensor, window: int, stride: int,
                   spatial: Optional[SpatialRows] = None) -> torch.Tensor:
    """Average pool with floor-mode output size and no padding (NCHW):
    ``F.avg_pool2d(x, window, stride)``, flax's ``nn.avg_pool`` (DenseNet's
    transitions).

    With ``spatial`` (x: this rank's rows), the rows of this rank's output
    windows come through the row exchange: a window straddles the split
    where an output range starts on an odd row pair (14 rows split 7/7 give
    7 split 4/3, and output row 3 reads rows 6 and 7)."""
    if spatial is None or spatial.tracing:
        y = F.avg_pool2d(x, window, stride)
        if spatial is not None:
            spatial.record(x.shape[2], y.shape[2])
        return y
    h_in, h_out = spatial.next_op(x.shape[2])
    win = spatial.window(x, h_in, _pool_windows(h_out, spatial.ways, window, stride, 0), 0.0)
    return F.avg_pool2d(win, window, stride)


def _bin_edges(n: int, bins: int):
    """torch's AdaptiveAvgPool2d bins of n: [floor(b n / bins), ceil((b + 1) n / bins))."""
    return [((b * n) // bins, -(-((b + 1) * n) // bins)) for b in range(bins)]


@functools.lru_cache(maxsize=None)
def _bin_matrix(n: int, bins: int, lo: int, hi: int) -> torch.Tensor:
    """(bins, hi - lo) float32: 1 where bin b covers row lo + r."""
    m = torch.zeros((bins, hi - lo), dtype=torch.float32)
    for b, (a, e) in enumerate(_bin_edges(n, bins)):
        if min(e, hi) > max(a, lo):
            m[b, max(a, lo) - lo:min(e, hi) - lo] = 1.0
    return m


class _RowsBinMean(torch.autograd.Function):
    """``apply(x, h, bins, rows, group)``: the adaptive average pool into
    (bins, bins) of an NCHW map of global height h whose rows ``rows`` =
    (lo, hi) this rank holds, from float32 sums of its rows in each bin
    summed over ``group``. The pooled map is the same on every rank of the
    group and feeds only the rank's own rows downstream, so the backward
    sums the pooled gradient over the group before spreading it over this
    rank's pixels of each bin."""

    @staticmethod
    def forward(ctx, x, h, bins, rows, group):
        my = _bin_matrix(h, bins, *rows).to(x.device)
        mx = _bin_matrix(x.shape[3], bins, 0, x.shape[3]).to(x.device)
        # contiguous: gloo summed an einsum's strided output wrongly (S = 3)
        sums = torch.einsum("br,ncrd->ncbd", my,
                            torch.einsum("ncrw,dw->ncrd", x.float(), mx)).contiguous()
        dist.all_reduce(sums, group=group)
        counts = torch.outer(*(torch.tensor([float(e - a) for a, e in _bin_edges(n, bins)],
                                            device=x.device) for n in (h, x.shape[3])))
        ctx.save_for_backward(my, mx, counts)
        ctx.group, ctx.dtype = group, x.dtype
        return (sums / counts).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        my, mx, counts = ctx.saved_tensors
        g = grad.to(torch.float32, copy=True)
        dist.all_reduce(g, group=ctx.group)
        g = torch.einsum("ncbw,br->ncrw", torch.einsum("ncbd,dw->ncbw", g / counts, mx), my)
        return g.to(ctx.dtype), None, None, None, None


def adaptive_avg_pool(x: torch.Tensor, bins: int,
                      spatial: Optional[SpatialRows] = None) -> torch.Tensor:
    """``F.adaptive_avg_pool2d(x, bins)`` (NCHW): bin b covers [floor(b n /
    bins), ceil((b + 1) n / bins)) of a side n, so neighbouring bins may
    overlap, and more bins than rows repeat rows (PSPNet's pyramid); one
    bin is the mean over H and W (DeepLab v3's image pooling).

    With ``spatial`` (x: this rank's rows) the pooled map is whole and the
    same on every rank of the model group (``_RowsBinMean``): it is traced
    as (h, h), not as a layer of ``bins`` rows, which could not split (a
    bin-1 map has one row)."""
    if spatial is None or spatial.tracing:
        if spatial is not None:
            spatial.record(x.shape[2], x.shape[2])
        return F.adaptive_avg_pool2d(x, bins)
    h, _ = spatial.next_op(x.shape[2])
    return _RowsBinMean.apply(x, h, bins, spatial.own(h), spatial.group)


def upsample_bilinear_align_corners(x: torch.Tensor, out_hw: Tuple[int, int],
                                    spatial: Optional[SpatialRows] = None) -> torch.Tensor:
    """Bilinear resize with align_corners=True (NHWC in and out).

    With ``spatial`` (x: this rank's rows; ``out_hw``'s height is replaced
    by the traced global one), this rank's output rows are computed as the
    JAX package computes every row: a product with this rank's rows of the
    global interpolation matrix over H (the source rows through the row
    exchange), then one over W, each in x's dtype (a lower dtype
    accumulates in float32)."""
    if spatial is None or spatial.tracing:
        y = x
        if tuple(x.shape[1:3]) != tuple(out_hw):
            y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                              mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
        if spatial is not None:
            spatial.record(x.shape[1], y.shape[1])
        return y
    h_in, h_out = spatial.next_op(x.shape[1])
    if (h_in, x.shape[2]) == (h_out, out_hw[1]):
        return x
    y = _resize_rows(x.permute(0, 3, 1, 2), h_in, h_out, out_hw[1], spatial,
                     interp_matrix_align_corners)
    return y.permute(0, 2, 3, 1)


def _resize_rows(x: torch.Tensor, h_in: int, h_out: int, w_out: int, spatial: SpatialRows,
                 matrix) -> torch.Tensor:
    """This rank's output rows (NCHW) of a separable resize whose (n_out,
    n_in) weights ``matrix`` gives: a product with this rank's rows of the
    H matrix (the source rows through the row exchange), then one with the
    W matrix, each in x's dtype (a lower dtype accumulates in float32)."""
    windows, wys = _matrix_rows(matrix, h_in, h_out, spatial.ways)
    win = spatial.window(x, h_in, windows, 0.0)
    wy = wys[spatial.index].to(device=x.device, dtype=x.dtype)
    wx = torch.from_numpy(matrix(x.shape[3], w_out)).to(device=x.device, dtype=x.dtype)
    return torch.einsum("pw,ncow->ncop", wx, torch.einsum("oh,nchw->ncow", wy, win))


@functools.lru_cache(maxsize=None)
def _matrix_rows(matrix, h_in: int, h_out: int, ways: int):
    """Each model index's window of source rows [a, b) and its rows of the
    (h_out, h_in) interpolation matrix restricted to them."""
    mat = torch.from_numpy(matrix(h_in, h_out))
    windows, rows = [], []
    for lo, hi in split_rows(h_out, ways):
        used = mat[lo:hi].sum(dim=0).nonzero()[:, 0]
        a, b = int(used[0]), int(used[-1]) + 1
        windows.append((a, b))
        rows.append(mat[lo:hi, a:b])
    return windows, rows


def upsample_nearest_2x(x: torch.Tensor,
                        spatial: Optional[SpatialRows] = None) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling (NCHW).

    With ``spatial`` (x: this rank's rows), output row i reads input row
    i // 2, which the neighbouring rank owns where the split is uneven (3
    rows split 2/1 give 6 split 3/3, and output row 3 reads row 1): this
    rank's input rows come through the row exchange."""
    if spatial is None or spatial.tracing:
        y = F.interpolate(x, scale_factor=2.0, mode="nearest")
        if spatial is not None:
            spatial.record(x.shape[2], y.shape[2])
        return y
    h_in, h_out = spatial.next_op(x.shape[2])
    windows = [(lo // 2, (hi - 1) // 2 + 1) for lo, hi in split_rows(h_out, spatial.ways)]
    win = spatial.window(x, h_in, windows, 0.0)
    lo, hi = spatial.own(h_out)
    a = 2 * windows[spatial.index][0]
    return F.interpolate(win, scale_factor=2.0, mode="nearest")[:, :, lo - a:hi - a]


def resize_bilinear_half_pixel(x: torch.Tensor, out_hw: Tuple[int, int],
                               spatial: Optional[SpatialRows] = None) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False, no
    antialiasing; NCHW): ``jax.image.resize(method='linear',
    antialias=False)``, whose edge samples renormalise onto the edge pixel
    as torch's clamped source index does.

    With ``spatial`` (x: this rank's rows; ``out_hw``'s height is replaced
    by the traced global one), this rank's output rows are the products
    with its rows of ``interp_matrix_half_pixel``: each reads the two
    clamped source rows around (y + 0.5) * h_in / h_out - 0.5."""
    if spatial is None or spatial.tracing:
        y = x
        if tuple(x.shape[2:]) != tuple(out_hw):
            y = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)
        if spatial is not None:
            spatial.record(x.shape[2], y.shape[2])
        return y
    h_in, h_out = spatial.next_op(x.shape[2])
    if (h_in, x.shape[3]) == (h_out, out_hw[1]):
        return x
    return _resize_rows(x, h_in, h_out, out_hw[1], spatial, interp_matrix_half_pixel)


def resize_half_pixel_to_rows(x: torch.Tensor, out_hw: Tuple[int, int],
                              spatial: Optional[SpatialRows] = None) -> torch.Tensor:
    """``resize_bilinear_half_pixel`` of a map that every rank of the model
    group holds whole (PSPNet's pooled bins, ``adaptive_avg_pool``) to an
    output whose rows the ranks split (NCHW).

    With ``spatial``, ``out_hw``'s height is this rank's rows (the global
    height from the trace) and the output is this rank's rows of
    ``interp_matrix_half_pixel`` times the whole source, then the W matrix,
    in x's dtype: no exchange. The source's gradient covers this rank's rows
    only; the pool's backward sums it over the group."""
    if spatial is None or spatial.tracing:
        if spatial is not None:
            spatial.record(out_hw[0], out_hw[0])
        return resize_bilinear_half_pixel(x, out_hw)
    h_out, _ = spatial.next_op(out_hw[0])
    lo, hi = spatial.own(h_out)
    wy = torch.from_numpy(interp_matrix_half_pixel(x.shape[2], h_out)[lo:hi])
    wx = torch.from_numpy(interp_matrix_half_pixel(x.shape[3], out_hw[1]))
    wy, wx = (m.to(device=x.device, dtype=x.dtype) for m in (wy, wx))
    return torch.einsum("pw,ncow->ncop", wx, torch.einsum("oh,nchw->ncow", wy, x))


class AddSkipDecoderBlock(nn.Module):
    """U-Net decoder block shared by ResUNet and DenseUNet: nearest-2x
    upsample, additive skip, 3x3 conv (no bias), BN, ReLU (NCHW)."""

    def __init__(self, chn_in: int, chn_out: int):
        super().__init__()
        self.spatial: Optional[SpatialRows] = None  # set_spatial: the upsample's rows
        self.conv = Conv2d(chn_in, chn_out, 3, padding=1, bias=False)
        self.conv_bn = BatchNorm2d(chn_out)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        # the skip has the upsampled map's height, so the same rows: the
        # sum is row-local
        x = upsample_nearest_2x(x, self.spatial) + skip
        return F.relu(self.conv_bn(self.conv(x)))


class AddSkipUNet(nn.Module):
    """The decoder and head of ResUNet and DenseUNet: four
    AddSkipDecoderBlocks (``decoder3`` .. ``decoder0``), then nearest-2x
    upsample, 3x3 conv to 64 (no bias), Dropout(0.3), BN, ReLU and a 1x1
    classifier. Subclasses build the encoder, call ``begin`` of
    ``self.spatial`` at the top of their forward, and call ``decode``."""

    # every cross-row operation has a spatial form (parallel.spatial)
    supports_spatial = True

    def __init__(self):
        super().__init__()
        self.spatial: Optional[SpatialRows] = None  # set_spatial: H split over ranks

    def _build_decoder(self, chn_in: int, chn_outs: Sequence[int], num_classes: int):
        for name, chn_out in zip(("decoder3", "decoder2", "decoder1", "decoder0"), chn_outs):
            setattr(self, name, AddSkipDecoderBlock(chn_in, chn_out))
            chn_in = chn_out
        self.final_dec_conv = Conv2d(chn_in, 64, 3, padding=1, bias=False)
        self.final_dec_drop = Dropout(0.3)
        self.final_dec_bn = BatchNorm2d(64)
        self.final_clf = Conv2d(64, num_classes, 1)

    def decode(self, y: torch.Tensor, skips: Sequence[torch.Tensor]) -> torch.Tensor:
        """NCHW features at 1/32 and the four skips (1/16 .. 1/2) -> NHWC
        logits at the input size."""
        for name, skip in zip(("decoder3", "decoder2", "decoder1", "decoder0"), skips):
            y = getattr(self, name)(y, skip)
        y = self.final_dec_drop(self.final_dec_conv(upsample_nearest_2x(y, self.spatial)))
        logits = self.final_clf(F.relu(self.final_dec_bn(y)))
        return logits.permute(0, 2, 3, 1)
