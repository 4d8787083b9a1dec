"""Training-mode BatchNorm with batch statistics and an optional ReLU: the
wrapper of the CUDA kernels ``csrc/bn_train.cu`` and their plain PyTorch
version (``models.common.BatchNorm2d`` calls ``batch_norm_train`` in
training mode; the running-average path stays in the module).

Both are ``torch.autograd.Function``s with one arithmetic and one
hand-written backward. Per channel, over the N*H*W values of an NCHW tensor
(promoted to float32, or kept in float64): mean E[x], biased variance
max(E[x^2] - E[x]^2, 0) (flax's fast variance), the normalised
``(x - mean) * (rsqrt(var + eps) * weight) + bias`` cast back to x's dtype,
then ``relu`` where the call site asks for it. With ``running`` (the
module's running mean and variance), both become ``momentum * running +
(1 - momentum) * batch``, the BIASED variance included. Under a mesh the
sums of x and x^2 and the count are summed over every rank before the
statistics are taken, and in the backward so are the sums of g and g * u
(g the incoming gradient through the ReLU, u = x - mean): the input
gradient is the global batch's, the weight and bias gradients this rank's
(the step sums those over the ranks).

``batch_norm_train`` dispatches on x's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernels or raises (float32 and bf16
only); there is no fallback. A channels-last tensor whose channels are a
multiple of 8 (bf16) or 4 (float32), 16-byte aligned, takes the kernels'
vector variant; any other (contiguous NCHW, other channel counts, views)
their one-element variant, through its strides. Only x and a few
per-channel float32 vectors are saved for the backward.

A run shows its path in ``build.launch_counts``, each kernel's launches by
name (``KERNELS``; ``counters()`` sums them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from cutmix_seg_tpu_torch.ops import build

SOURCE = "bn_train"
KERNELS = ("bn_train_stats", "bn_train_finalize", "bn_train_apply",
           "bn_train_grad_stats", "bn_train_grad_finalize", "bn_train_grad_input")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256        # a row-tile block (csrc/bn_train.cu: kThreads)
_MAX_CV = 32          # channel vectors of a block
_BLOCKS_PER_SM = 8    # the grid the wrapper aims at
_STAT_ROWS, _COEF_ROWS = 5, 2

def counters() -> dict:
    """Launches of the BN kernels since the last clear of
    ``build.launch_counts``."""
    return {"bn_launches": sum(build.launch_counts.get(k, 0) for k in KERNELS)}


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running: Optional[Tuple[torch.Tensor, torch.Tensor]], momentum: float,
                     eps: float, mesh=None, relu: bool = False) -> torch.Tensor:
    """Training-mode BatchNorm of NCHW ``x`` (module docstring); the plain
    version for a CPU tensor, the kernels for a CUDA tensor."""
    if x.device.type == "cpu":
        return _Plain.apply(x, weight, bias, running, momentum, eps, mesh, relu)
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_train runs on cpu or cuda, not {x.device}")
    _check(x, weight, bias, running)
    return _Kernels.apply(x, weight, bias, running, momentum, eps, mesh, relu)


def batch_norm_train_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           running: Optional[Tuple[torch.Tensor, torch.Tensor]],
                           momentum: float, eps: float, mesh=None,
                           relu: bool = False) -> torch.Tensor:
    """The plain PyTorch version, on any device."""
    return _Plain.apply(x, weight, bias, running, momentum, eps, mesh, relu)


def _chw(t: torch.Tensor) -> torch.Tensor:
    return t[:, None, None]


class _Plain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, running, momentum, eps, mesh, relu):
        dt = torch.promote_types(x.dtype, torch.float32)
        xc = x.to(dt)
        c = x.shape[1]
        count = None
        if mesh is None:
            mean = xc.mean(dim=(0, 2, 3))
            var_raw = (xc * xc).mean(dim=(0, 2, 3)) - mean * mean
        else:
            sums = torch.cat([xc.sum(dim=(0, 2, 3)), (xc * xc).sum(dim=(0, 2, 3)),
                              torch.full((1,), x.numel() // c, dtype=dt, device=x.device)])
            dist.all_reduce(sums)
            count = sums[2 * c]
            mean = sums[:c] / count
            var_raw = sums[c:2 * c] / count - mean * mean
        var = torch.clamp_min(var_raw, 0.0)
        if running is not None:
            running_mean, running_var = running
            running_mean.copy_(momentum * running_mean + (1.0 - momentum) * mean)
            running_var.copy_(momentum * running_var + (1.0 - momentum) * var)
        rstd = torch.rsqrt(var + eps)
        mul = rstd * weight
        y = ((xc - _chw(mean)) * _chw(mul) + _chw(bias)).to(x.dtype)
        if relu:
            y = torch.relu(y)
        ctx.save_for_backward(x, mean, rstd, mul, bias, var_raw >= 0, count)
        ctx.mesh, ctx.relu, ctx.weight_dtype = mesh, relu, weight.dtype
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, mean, rstd, mul, bias, gate, count = ctx.saved_tensors
        c = x.shape[1]
        u = x.to(mean.dtype) - _chw(mean)
        g = dy.to(mean.dtype)
        if ctx.relu:
            y = (u * _chw(mul) + _chw(bias)).to(x.dtype)
            g = torch.where(y <= 0, 0.0, g)
        a = g.sum(dim=(0, 2, 3))
        b = (g * u).sum(dim=(0, 2, 3))
        dweight, dbias = (b * rstd).to(ctx.weight_dtype), a.to(ctx.weight_dtype)
        if ctx.mesh is not None:
            s = torch.cat([a, b])
            dist.all_reduce(s)
            a, b = s[:c], s[c:]
        else:
            count = x.numel() // c
        mg = a / count
        mgx = torch.where(gate, b * rstd / count, 0.0)
        dx = _chw(mul) * (g - _chw(mg) - (u * _chw(rstd)) * _chw(mgx))
        return dx.to(x.dtype), dweight, dbias, None, None, None, None, None


# ---- the kernels ----


class _Geometry(ctypes.Structure):
    """csrc/bn_train.cu's Geometry."""
    _fields_ = ([(k, ctypes.c_int) for k in ("n", "c", "h", "w", "rows", "vec", "cv", "rt",
                                              "n_tiles", "tile_rows")]
                + [(k, ctypes.c_longlong * 4) for k in ("s0", "s1", "s2")])


class _Finalize(ctypes.Structure):
    """csrc/bn_train.cu's Finalize (pointers as addresses, 0 for null)."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "partials", "sums", "count_ptr", "weight", "bias", "running_mean", "running_var",
        "stats", "dweight", "dbias", "coef")]
                + [("n_tiles", ctypes.c_int), ("c", ctypes.c_int)]
                + [(k, ctypes.c_float) for k in ("count", "eps", "keep", "fresh")])


def vector_width(t: torch.Tensor) -> int:
    """Channels in the kernels' 16-byte vector for t's dtype."""
    return 16 // t.element_size()


def vectorable(t: torch.Tensor) -> bool:
    """Whether t can take the kernels' vector variant: channels-last
    contiguous, 16-byte aligned, channels a multiple of the vector."""
    return (t.is_contiguous(memory_format=torch.channels_last)
            and t.shape[1] % vector_width(t) == 0 and t.data_ptr() % 16 == 0)


def tiling(rows: int, c: int, vec: int, sms: int) -> Tuple[int, int, int, int]:
    """(cv, rt, n_tiles, tile_rows) of the row-tile kernels: a block of cv
    channel vectors x rt row lanes, and the rows cut into n_tiles tiles of
    tile_rows (the last may be shorter), so that the grid holds about
    ``_BLOCKS_PER_SM`` blocks an SM and each row lane at least one row."""
    cvecs = -(-c // vec)
    cv = min(cvecs, _MAX_CV)
    rt = _THREADS // cv
    groups = -(-cvecs // cv)
    n_tiles = max(1, min(-(-rows // rt), -(-_BLOCKS_PER_SM * sms // groups)))
    tile_rows = -(-rows // n_tiles)
    return cv, rt, -(-rows // tile_rows), tile_rows


def _geometry(x: torch.Tensor, vec: int, *others: torch.Tensor) -> _Geometry:
    n, c, h, w = x.shape
    rows = n * h * w
    cv, rt, n_tiles, tile_rows = tiling(rows, c, vec, _sms(x.device.index))
    g = _Geometry(n, c, h, w, rows, vec, cv, rt, n_tiles, tile_rows)
    for name, t in zip(("s0", "s1", "s2"), (x,) + others):
        setattr(g, name, (ctypes.c_longlong * 4)(*t.stride()))
    return g


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """The SM count of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, weight, bias, running) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the BN kernels take float32 or bfloat16, got {x.dtype}")
    c = x.shape[1]
    vectors = (weight, bias) + (tuple(running) if running is not None else ())
    for t in vectors:
        if t.shape != (c,) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError(f"weight, bias and running statistics must be contiguous "
                             f"float32 ({c},) on {x.device}")
    if x.numel() == 0:
        raise ValueError("the batch must hold at least one value per channel")
    if x.numel() // c > 2 ** 31 - 1:
        raise ValueError("the BN kernels index at most 2^31 - 1 rows")


def _launch(name: str, *args) -> None:
    fn = getattr(build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    build.launch_counts[name] += 1


_P, _I, _G, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_Geometry),
                  ctypes.POINTER(_Finalize))
_ARGTYPES = {
    "bn_train_stats": [_I, _G, _P, _P, _P],
    "bn_train_finalize": [_F, _P],
    "bn_train_apply": [_I, _I, _G, _P, _P, _P, _P],
    "bn_train_grad_stats": [_I, _I, _G, _P, _P, _P, _P, _P],
    "bn_train_grad_finalize": [_F, _P],
    "bn_train_grad_input": [_I, _I, _G, _P, _P, _P, _P, _P, _P],
}


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _empty_like(x: torch.Tensor, vec: int) -> torch.Tensor:
    """An output of x's shape and dtype in x's layout, channels-last where
    the vector variant runs."""
    out = torch.empty_like(x)
    if vec > 1 and not vectorable(out):
        out = torch.empty_like(x, memory_format=torch.channels_last)
    return out


class _Kernels(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, running, momentum, eps, mesh, relu):
        c = x.shape[1]
        vec = vector_width(x) if vectorable(x) else 1
        y = _empty_like(x, vec)
        g = _geometry(x, vec, y)
        f32 = dict(dtype=torch.float32, device=x.device)
        partials = torch.empty((2, g.n_tiles, c), **f32)
        stats = torch.empty((_STAT_ROWS, c), **f32)
        dtype, relu_flag = _DTYPE_CODE[x.dtype], int(bool(relu))
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            _launch("bn_train_stats", dtype, ctypes.byref(g), x.data_ptr(),
                    partials.data_ptr(), stream)
            fin = _Finalize(partials=partials.data_ptr(), weight=weight.data_ptr(),
                            bias=bias.data_ptr(), stats=stats.data_ptr(), n_tiles=g.n_tiles,
                            c=c, count=float(g.rows), eps=eps, keep=momentum,
                            fresh=1.0 - momentum)
            if running is not None:
                fin.running_mean, fin.running_var = (t.data_ptr() for t in running)
            count = None
            if mesh is not None:
                sums = torch.empty(2 * c + 1, **f32)
                fin.sums = sums.data_ptr()
                _launch("bn_train_finalize", ctypes.byref(fin), stream)
                dist.all_reduce(sums)
                count = sums[2 * c:]
                fin.sums, fin.partials, fin.n_tiles = None, sums.data_ptr(), 1
                fin.count_ptr = count.data_ptr()
            _launch("bn_train_finalize", ctypes.byref(fin), stream)
            _launch("bn_train_apply", dtype, relu_flag, ctypes.byref(g), x.data_ptr(),
                    y.data_ptr(), stats.data_ptr(), stream)
        ctx.save_for_backward(x, stats, count)
        ctx.vec, ctx.mesh, ctx.relu = vec, mesh, relu_flag
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, stats, count = ctx.saved_tensors
        c = x.shape[1]
        vec = ctx.vec
        if vec > 1 and not vectorable(dy):
            dy = dy.contiguous(memory_format=torch.channels_last)
            vec = vec if vectorable(dy) else 1
        need_dx = ctx.needs_input_grad[0]
        dx = _empty_like(x, vec) if need_dx else None
        g = _geometry(x, vec, dy, dx if need_dx else x)
        f32 = dict(dtype=torch.float32, device=x.device)
        partials = torch.empty((2, g.n_tiles, c), **f32)
        dweight, dbias = torch.empty(c, **f32), torch.empty(c, **f32)
        coef = torch.empty((_COEF_ROWS, c), **f32) if need_dx else None
        dtype = _DTYPE_CODE[x.dtype]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            _launch("bn_train_grad_stats", dtype, ctx.relu, ctypes.byref(g), x.data_ptr(),
                    dy.data_ptr(), stats.data_ptr(), partials.data_ptr(), stream)
            fin = _Finalize(partials=partials.data_ptr(), stats=stats.data_ptr(),
                            dweight=dweight.data_ptr(), dbias=dbias.data_ptr(),
                            coef=_ptr(coef), n_tiles=g.n_tiles, c=c, count=float(g.rows))
            if ctx.mesh is not None and need_dx:
                sums = torch.empty(2 * c, **f32)
                fin.sums = sums.data_ptr()
                _launch("bn_train_grad_finalize", ctypes.byref(fin), stream)
                dist.all_reduce(sums)
                fin = _Finalize(partials=sums.data_ptr(), stats=stats.data_ptr(),
                                coef=coef.data_ptr(), count_ptr=count.data_ptr(),
                                n_tiles=1, c=c)
            _launch("bn_train_grad_finalize", ctypes.byref(fin), stream)
            if need_dx:
                _launch("bn_train_grad_input", dtype, ctx.relu, ctypes.byref(g),
                        x.data_ptr(), dy.data_ptr(), stats.data_ptr(), coef.data_ptr(),
                        dx.data_ptr(), stream)
        return dx, dweight, dbias, None, None, None, None, None
