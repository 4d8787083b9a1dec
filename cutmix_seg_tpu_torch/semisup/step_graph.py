"""A train step replayed as one CUDA graph (``torch.cuda.CUDAGraph``).

An eager training-BN DenseUNet-161 step launches ~27,600 kernels, and the
host spends more time on each launch than the card spends on its kernel. A
graph replay launches all of them at once, so the step runs at the card's
pace. ``GraphedStep`` wraps a step body ``body(state, batch, scalars,
rects) -> (state, metrics)`` whose host scalars arrive on the device in
``scalars`` (``stepcore.step_scalars``: ramp, then the optimiser's), and is
called as the step: ``step(state, batch, ramp, rects=None)``.

Per call:

- eager where a graph cannot stand in for the step (``eager_steps``): a
  state off CUDA, a wrapper built with ``capturable`` False (a step over a
  mesh: its collectives run on gloo or NCCL and its dropout generator is
  derived per step), or a net that already holds gradients (the eager step
  adds to them);
- the first call of a signature runs the body eagerly on the wrapper's
  side stream, as a real step (``eager_steps``): cuDNN's autotune, the
  cuBLAS workspace of that stream and AccumulateGrad are warm before the
  capture, and the capture finds one workspace, not a second;
- the second captures the body on that stream into static inputs and the
  state's own tensors (``captures``), then replays it;
- later calls of the signature copy the batch into the static inputs, fill
  the scalars, replay (``replays``, inside ``record_function("step.replay")``),
  advance ``state.step`` and ``opt.count`` on the host by as much as the
  captured body advanced them, and return clones of the metrics, which the
  next replay would overwrite.

The signature is what can be observed of the call: the batch's keys,
shapes, strides, dtypes and devices (the injected rects' too), each
module's train mode, the generator object, and the storage of every tensor
the graph touches (parameters, buffers, optimiser state). BN's other
settings and the dropout generator are set by the step itself, from its
configuration and the state (``stepcore.prepare_nets``). Any change (a
load into new tensors, a net left in eval mode, a new crop)
drops the graph, and the wrapper warms up and captures again: it never
replays stale addresses. A replay does not run the body's Python, so the
step's phase spans (``step.perturb``, ...) are absent on replays.

On a CUDA state the batch is consumed, as a donated buffer of the JAX step:
the caller's dict is emptied once its tensors are copied, so they are freed
before the step's peak. The state's generator is registered with the graph
(``register_generator_state``): each replay draws the boxes and dropout
masks that the eager step would draw and advances the generator as it
would, so a replayed step is the eager step bit for bit.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from cutmix_seg_tpu_torch.core.train_state import Optimizer, TrainState
from cutmix_seg_tpu_torch.ops import build
from cutmix_seg_tpu_torch.semisup.stepcore import step_scalars


def _graphable(device: torch.device) -> bool:
    return device.type == "cuda"


def _side_stream(device: torch.device):
    return torch.cuda.Stream(device)


def _run_on(stream, fn: Callable):
    """``fn()`` with ``stream`` current, ordered after and before the
    current stream's work."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


def _capture(stream, generator: torch.Generator, fn: Callable):
    """(graph, ``fn()``'s outputs) of ``fn`` captured on ``stream``, the
    draws from ``generator`` replayed from its state at each replay."""
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    # thread_local: another thread's CUDA calls (a loader pinning memory)
    # do not break the capture
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        out = fn()
    return graph, out


def _static_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device=t.device)


def _meta(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype, t.device


def _signature(state: TrainState, opt: Optimizer, batch: dict,
               rects: Optional[torch.Tensor]) -> Tuple[tuple, bool]:
    """(the call's signature, whether a net holds gradients), from one walk
    over the nets' modules (``parameters()`` and ``buffers()`` would take
    several times as long)."""
    parts, params = [], []
    for net in (state.student, state.teacher):
        for m in net.modules() if net is not None else ():
            parts.append(m.training)
            own = [t for t in m._parameters.values() if t is not None]
            params += own
            parts += [t.data_ptr() for t in own]
            parts += [t.data_ptr() for t in m._buffers.values() if t is not None]
    for g in opt.groups:
        parts += [t.data_ptr() for t in g.params]
        parts += [t.data_ptr() for ts in g.state.values() for t in ts]
    key = (tuple((k, _meta(v)) for k, v in sorted(batch.items())),
           None if rects is None else _meta(rects), state.generator, tuple(parts))
    return key, any(p.grad is not None for p in params)


class _Graph:
    """A captured step: its signature, static inputs and outputs, and the
    kernel launches and host counter advances of its capture."""

    def __init__(self, key: tuple, batch: dict, rects: Optional[torch.Tensor],
                 n_scalars: int, device: torch.device):
        self.key = key
        self.batch = {k: _static_like(v) for k, v in batch.items()}
        self.rects = None if rects is None else _static_like(rects)
        self.scalars = torch.empty(n_scalars, dtype=torch.float32, device=device)
        self.graph = None
        self.metrics: Dict[str, torch.Tensor] = {}
        self.launches: collections.Counter = collections.Counter()
        self.advance = (0, 0)  # what the body added to state.step and opt.count

    def load(self, batch: dict, rects: Optional[torch.Tensor]) -> None:
        """Copy the call's inputs into the static ones and empty ``batch``."""
        for k, v in batch.items():
            self.batch[k].copy_(v)
        if rects is not None:
            self.rects.copy_(rects)
        batch.clear()


class GraphedStep:
    """``step(state, batch, ramp, rects=None) -> (state, metrics)``, replayed
    from a CUDA graph where it can be (module docstring); ``capturable``
    False (a step over a mesh) runs every call eagerly, in place and without
    consuming the batch."""

    def __init__(self, body: Callable, opt: Optimizer, capturable: bool = True):
        self.body = body
        self.opt = opt
        self.capturable = capturable
        self.captures = self.replays = self.eager_steps = 0
        self._stream = None  # the side stream of the warm-up and the capture
        self._warm_key: Optional[tuple] = None
        self._graph: Optional[_Graph] = None

    def counters(self) -> Dict[str, int]:
        return {"captures": self.captures, "replays": self.replays,
                "eager_steps": self.eager_steps}

    def __call__(self, state: TrainState, batch: dict, ramp: float,
                 rects: Optional[torch.Tensor] = None):
        device = state.generator.device
        if not (self.capturable and _graphable(device)):
            return self._eager(state, batch, ramp, rects, device)
        key, grads = _signature(state, self.opt, batch, rects)
        if grads:  # the step adds to them; a graph captured without them would not
            return self._eager(state, batch, ramp, rects, device)
        g = self._graph
        if g is None or g.key != key:
            self._graph = g = None  # a stale graph and its memory go
            if self._warm_key != key:
                self._warm_key = key
                return self._warm_up(state, batch, ramp, rects, device)
            g = _Graph(key, batch, rects, 1 + len(self.opt.scalar_values()), device)
            g.load(batch, rects)
            self._capture(g, state)
            self._graph = g
        else:
            g.load(batch, rects)
        return self._replay(g, state, ramp, device)

    def _eager(self, state, batch, ramp, rects, device):
        self.eager_steps += 1
        return self.body(state, batch, step_scalars(self.opt, ramp, device), rects)

    def _warm_up(self, state, batch, ramp, rects, device):
        if self._stream is None:
            self._stream = _side_stream(device)
        state, metrics = _run_on(self._stream,
                                 lambda: self._eager(state, batch, ramp, rects, device))
        batch.clear()
        # in the current stream's memory, as an eager step's would be
        return state, {k: v.clone() for k, v in metrics.items()}

    def _capture(self, g: _Graph, state: TrainState) -> None:
        """Capture the body on the static inputs. Its Python runs once, so
        the launches it counted and the host counters it advanced are
        recorded and put back: each replay, the first one included, applies
        them as the step."""
        self.captures += 1
        counts = state.step, self.opt.count
        launches = collections.Counter(build.launch_counts)
        g.graph, (_, g.metrics) = _capture(
            self._stream, state.generator,
            lambda: self.body(state, g.batch, g.scalars, g.rects))
        g.launches = collections.Counter(build.launch_counts) - launches
        build.launch_counts.subtract(g.launches)
        g.advance = state.step - counts[0], self.opt.count - counts[1]
        state.step, self.opt.count = counts

    def _replay(self, g: _Graph, state: TrainState, ramp: float, device):
        self.replays += 1
        with record_function("step.replay"):
            step_scalars(self.opt, ramp, device, out=g.scalars)
            g.graph.replay()
            build.launch_counts.update(g.launches)
            state.step += g.advance[0]
            self.opt.count += g.advance[1]
            return state, {k: v.clone() for k, v in g.metrics.items()}
