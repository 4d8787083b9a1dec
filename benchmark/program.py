"""The system under test: the port's trainer engine, built from a cell's
recipe flags as ``train_seg_semisup_<algorithm>`` builds it, with the
benchmark's weights, driven through the trainer iteration that
``TrainEngine._run_epochs`` runs:

    state, metrics = engine.step(state, engine.make_batch(engine.make_raw_batch()), ramp)

Set-up builds the engine, opens epoch 0's streams (``_open_epoch_streams``,
a private method: the engine has no public per-iteration entry), drives
the first three iterations (the ones the reference follows, read as they
go), warms up, and hands the same engine to the window. No eval and no
checkpoint run.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import sys
import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

from benchmark import recipe, weights

CHECK_STEPS = 3
ADAM_B1 = 0.9


class Program:
    def __init__(self, cell: dict, seed: int, data_cfg_path: str, run_dir: str, device: str):
        from cutmix_seg_tpu_torch.core import job
        from cutmix_seg_tpu_torch.data import settings
        from cutmix_seg_tpu_torch.train.engine import TrainEngine

        os.environ["CUTMIX_SEG_CONFIG"] = data_cfg_path
        settings._config = None
        self.cell, self.seed = cell, seed
        algo = cell["traffic"]["algorithm"]
        mod = importlib.import_module(f"cutmix_seg_tpu_torch.train.{algo}")
        argv = recipe.flags(cell) + [f"--seed={seed}"]
        params = dict(mod.experiment.make_context("experiment", argv).params)
        del params["job_desc"]
        spec, cfg = mod.build_spec(params)
        self.engine = TrainEngine(job.RunContext(run_dir, "bench"), spec, cfg, params, device=device)
        with contextlib.redirect_stdout(sys.stderr):
            if self.engine.setup() is False:
                raise RuntimeError("the trainer's setup refused the cell's flags")
        self.batch_size = params["batch_size"]
        self.nan_interval = params.get("nan_check_interval", 100)
        self.iteration = 0
        self.msum = None

    @property
    def resident(self) -> bool:
        return self.engine.resident is not None

    def load_weights(self, leaves, init: dict) -> None:
        """The benchmark's weights into the student and the teacher; their
        tensors must be exactly the reference's."""
        e = self.engine
        w = weights.make(leaves, self.seed, init, e.device)
        for net in (e.state.student, e.state.teacher):
            sd = net.state_dict()
            if set(sd) != set(w):
                raise RuntimeError(
                    "the program's tensors differ from the reference's: "
                    f"{sorted(set(sd) ^ set(w))[:8]}")
            with torch.no_grad():
                for n, t in sd.items():
                    if tuple(t.shape) != tuple(w[n].shape):
                        raise RuntimeError(f"{n}: {tuple(t.shape)} vs {tuple(w[n].shape)}")
                    t.copy_(w[n])

    def open_streams(self) -> None:
        from cutmix_seg_tpu_torch.semisup.stepcore import accum_zero_metrics

        self.engine._open_epoch_streams(0)
        self.ramp = 1.0
        self.msum = accum_zero_metrics(self.engine.use_cons, self.engine.device)

    def iterate(self) -> dict:
        """One trainer iteration, as the engine's loop runs it."""
        e = self.engine
        batch = e.make_batch(e.make_raw_batch())
        with record_function("trainer.step"):
            e.state, metrics = e.step(e.state, batch, self.ramp)
        self.msum = {k: self.msum[k] + v for k, v in metrics.items()}
        self.iteration += 1
        if self.iteration % self.nan_interval == 0 and not _finite(float(self.msum["sup_loss"])):
            raise FloatingPointError("the trainer's NaN check found a non-finite loss")
        return metrics

    def first_steps(self, trainable: List[str], leaves, init: dict) -> dict:
        """The iterations the reference follows: each step's losses, the
        first gradient of each trainable leaf as the optimiser took it
        (from its state after step 1, its norm and, on the host, the
        tensor), and each leaf's change after them in the student and in the
        EMA teacher."""
        e = self.engine
        named = dict(e.state.student.named_parameters())
        teacher = dict(e.state.teacher.named_parameters())
        out = {"losses": [], "grad": {}, "change": {}, "teacher_change": {}}
        for k in range(CHECK_STEPS):
            metrics = self.iterate()
            out["losses"].append({n: float(v) for n, v in metrics.items()})
            if k == 0:
                out["grad"], out["grad_tensors"] = self._first_grads(named, trainable)
        w0 = weights.make(leaves, self.seed, init, e.device)
        with torch.no_grad():
            out["change"] = {n: float((named[n] - w0[n]).norm()) for n in trainable}
            out["teacher_change"] = {n: float((teacher[n] - w0[n]).norm()) for n in trainable}
        del w0
        return out

    def _first_grads(self, named,
                     trainable) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
        """({leaf: norm}, {leaf: tensor on the host}) of the first gradient
        as the optimiser took it: Adam's first moment over 1 - beta1, or
        SGD's momentum trace."""
        opt = self.engine.state.optimizer
        name_of = {id(p): n for n, p in named.items()}
        got = {}
        with torch.no_grad():
            for g in opt.groups:
                if "mu" in g.state:
                    for p, mu in zip(g.params, g.state["mu"]):
                        got[name_of[id(p)]] = mu.float() / (1.0 - ADAM_B1)
                else:
                    for p, tr in zip(g.params, g.state["trace"]):
                        got[name_of[id(p)]] = tr.float()
            missing = set(trainable) - set(got)
            if missing:
                raise RuntimeError(f"the optimiser does not train {sorted(missing)[:8]}")
            return ({n: float(t.norm()) for n, t in got.items()},
                    {n: t.to("cpu", copy=True) for n, t in got.items()})

    def window(self, seconds: float, profiler=None) -> dict:
        """Iterations for ``seconds`` of the host's clock, ended by a
        synchronise: {'iterations', 'seconds'}."""
        sync = torch.cuda.synchronize if self.engine.device.type == "cuda" else (lambda: None)
        sync()
        if profiler is not None:
            profiler.start()
        t0 = time.perf_counter()
        n = 0
        while True:
            self.iterate()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        t1 = time.perf_counter()
        if profiler is not None:
            profiler.stop()
        return {"iterations": n, "seconds": t1 - t0, "t0": t0}

    def losses_finite(self) -> bool:
        return all(_finite(float(v)) for v in self.msum.values())

    def close(self) -> None:
        self.engine.close_streams()
        self.engine = None


def _finite(x: float) -> bool:
    return x == x and abs(x) != float("inf")
