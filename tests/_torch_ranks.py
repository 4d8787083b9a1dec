"""Rank processes for the port's data-parallel and spatial tests.

``run_ranks(tmp_path, task)`` starts ``world`` processes of
``python -m tests._torch_ranks <dir> <rank> <world>``, joined into one gloo
group through a ``file://`` store under ``tmp_path``; each runs the task's
kind (``TASKS``) with its ``parallel.mesh.Mesh`` (``task['n_model']`` ranks
to an image, default 1) and saves its result. The
spawn has a deadline: a rank that fails, or one that outlives it (a stalled
collective), fails the call and every rank is killed, so the test fails
instead of hanging the suite. The ranks import the port only (no JAX), so
they start in a few seconds; the parent holds their results against the
JAX package.

The step cases (``run_steps``) are also run in the parent with no mesh on
the global batch: the port at world 1.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import hashlib
import os
import shutil
import subprocess
import sys
import time
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.nn import functional as F

from cutmix_seg_tpu_torch.core import train_state as tts
from cutmix_seg_tpu_torch.models import common as tcommon
from cutmix_seg_tpu_torch.models import deeplab3, denseunet, pspnet, resunet
from cutmix_seg_tpu_torch.models.deeplab2 import DeepLab2, _param_label
from cutmix_seg_tpu_torch.ops import batchnorm, build
from cutmix_seg_tpu_torch.parallel.mesh import Mesh, all_reduce_grads, local_rows
from cutmix_seg_tpu_torch.semisup import aug_cons, ict, mask_mt, vat
from tests import _torch_card as card

ROOT = Path(__file__).resolve().parents[1]
LR = 3e-4
C = 4

# ---- the parent's side ----


def run_ranks(tmp_path, task: dict, world: int = 2, timeout: float = 240.0) -> list:
    """Run ``task`` in ``world`` rank processes; each rank's result, in rank
    order."""
    return RankProcesses(tmp_path, task, world, timeout).wait()


class RankProcesses:
    """Start ``task`` in ``world`` rank processes; ``wait()`` returns each
    rank's result, in rank order (the parent can work meanwhile)."""

    def __init__(self, tmp_path, task: dict, world: int = 2, timeout: float = 240.0):
        self.d = Path(tmp_path) / f"ranks_{uuid.uuid4().hex[:8]}"
        self.d.mkdir(parents=True)
        self.world, self.timeout = world, timeout
        torch.save(task, self.d / "task.pt")
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(ROOT)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
        self.deadline = time.monotonic() + timeout
        self.procs = []
        for r in range(world):
            with open(self.d / f"log_{r}.txt", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tests._torch_ranks", str(self.d), str(r),
                     str(world)], cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))

    def wait(self) -> list:
        try:
            for p in self.procs:
                try:
                    p.wait(timeout=max(self.deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"rank processes outlived {self.timeout} s:\n"
                                         f"{_logs(self.d, self.world)}") from None
        finally:
            self.kill()
        for r, p in enumerate(self.procs):
            if p.returncode != 0:
                raise AssertionError(
                    f"rank {r} exited with {p.returncode}:\n{_logs(self.d, self.world)}")
        outs = [torch.load(self.d / f"out_{r}.pt", weights_only=False)
                for r in range(self.world)]
        # the task and the outputs take hundreds of MB for the big models:
        # a passing spawn leaves nothing on disk (a failing one keeps its logs)
        shutil.rmtree(self.d, ignore_errors=True)
        return outs

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _logs(d: Path, world: int) -> str:
    return "\n".join(f"--- rank {r}\n" + (d / f"log_{r}.txt").read_text()[-4000:]
                     for r in range(world))


# ---- the models and step cases ----


class TinyBN(torch.nn.Module):
    """conv-BN-ReLU, conv-dropout-BN-ReLU, 1x1 classifier: the torch twin of
    test_torch_trainbn.py's JTiny (the same parameter names)."""

    def __init__(self):
        super().__init__()
        self.conv0 = tcommon.Conv2d(3, 8, 3, padding=1, bias=False)
        self.bn0 = tcommon.BatchNorm2d(8)
        self.conv1 = tcommon.Conv2d(8, 8, 3, padding=1, bias=False)
        self.drop = tcommon.Dropout(0.3)
        self.bn1 = tcommon.BatchNorm2d(8)
        self.classifier = tcommon.Conv2d(8, C, 1)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x.permute(0, 3, 1, 2))))
        y = F.relu(self.bn1(self.drop(self.conv1(y))))
        return self.classifier(y).permute(0, 2, 3, 1)


MODELS = {
    "deeplab2": lambda: tcommon.SegModel("tiny", DeepLab2(C, layers=(1, 1, 1, 1)), np.zeros(3),
                                         np.ones(3), (1, 1), _param_label),
    "deeplabv3": lambda: tcommon.SegModel("tiny", deeplab3.DeepLabV3(C, layers=(1, 1, 1, 1)),
                                          np.zeros(3), np.ones(3), (1, 1),
                                          deeplab3._label_imagenet),
    "deeplabv3plus": lambda: tcommon.SegModel(
        "tiny", deeplab3.DeepLabV3Plus(C, layers=(1, 1, 1, 1)), np.zeros(3), np.ones(3), (1, 1),
        deeplab3._label_imagenet),
    "tinybn": lambda: tcommon.SegModel(
        "tiny", TinyBN(), np.zeros(3), np.ones(3), (1, 1),
        lambda m: tcommon.label_params_by_path(m, [("conv0", "pretrained")])),
    # the other families at tiny depth (tests/test_torch_spatial_families.py)
    "pspnet": lambda: tcommon.SegModel("tiny", pspnet.PSPNet(C, layers=(1, 1, 1, 1)),
                                       np.zeros(3), np.ones(3), (1, 1), pspnet._param_label),
    "resunet": lambda: tcommon.SegModel("tiny", resunet.ResUNet(C, layers=(1, 1, 1, 1)),
                                        np.zeros(3), np.ones(3), (32, 32),
                                        resunet._param_label_pretrained),
    "denseunet": lambda: tiny_denseunet(C),
}
STEPS = {  # algorithm: (config class, step factory)
    "mask_mt": (mask_mt.MaskConsistencyConfig, mask_mt.make_mask_mt_step),
    "ict": (ict.ICTConfig, ict.make_ict_step),
    "vat": (vat.VATConfig, vat.make_vat_step),
    "aug": (aug_cons.AugConsConfig, aug_cons.make_aug_cons_step),
}
SUP_KEYS = ("sup_x", "sup_y")


class GlobalMasks:
    """Dropout keep masks by call order for the GLOBAL batch, mask k from
    seed 300 + k (test_torch_trainbn.StepMasks), k wrapping at ``per``;
    a rank takes its data index's rows (of the global chunk, at grad_accum
    K). Under spatial partitioning the port draws the full map's mask (x
    has the full height) and keeps its rows itself."""

    def __init__(self, per: int, mesh):
        self.k, self.per, self.mesh = 0, per, mesh

    def draw(self, drop, x):
        n, c, h, w = x.shape
        rows = n * (1 if self.mesh is None else self.mesh.n_data)
        keep = np.random.RandomState(300 + self.k % self.per).rand(rows, h, w, c) \
            < 1.0 - drop.rate
        self.k += 1
        return torch.from_numpy(local_rows(keep, self.mesh)).permute(0, 3, 1, 2)


def digest(tree) -> str:
    """A hash of every tensor and number of a (nested) state, in key order:
    equal digests are bit-equal states (the tests ship digests, not the
    tens of MB of a state, between processes)."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif torch.is_tensor(x):
            h.update(str((x.dtype, tuple(x.shape))).encode())
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
        else:
            h.update(repr(x).encode())

    walk(tree)
    return h.hexdigest()


def run_steps(case: dict, mesh) -> dict:
    """One case's steps: the port's state from ``case['state_dict']``, its
    rows of the global batch and the global draws of each step. Returns the
    metrics and a digest of the state after each step, the generator's
    state, and (alone or on rank 0) the state dicts after the last step."""
    model = MODELS[case["model"]]()
    cfg_cls, make = STEPS[case["algo"]]
    cfg = cfg_cls(**case["cfg"])
    state, opt = tts.create_train_state(
        model, tts.OptimizerConfig(opt_type="adam", learning_rate=LR), 0, device="cpu",
        mean_teacher=cfg.mean_teacher, pretrained=False)
    for net in (state.student, state.teacher):
        if net is not None:
            net.load_state_dict(case["state_dict"])
    step = make(model, opt, cfg, mesh)
    batch = {k: torch.from_numpy(local_rows(v, mesh)) for k, v in case["batch"].items()}
    batch["sup_y"] = batch["sup_y"].long()
    masks = GlobalMasks(case.get("masks_per_chunk", 1), mesh)
    patched = (_patched_draw(masks) if case.get("masks_per_chunk")
               else contextlib.nullcontext())
    out = {"metrics": [], "digests": []}
    with patched:
        for draws in case["draws"]:
            masks.k = 0
            state, m = step(state, batch, 1.0,
                            **{k: torch.from_numpy(v) for k, v in draws.items()})
            out["metrics"].append({k: v.item() for k, v in m.items()})
            final = {part: net.state_dict()
                     for part, net in (("student", state.student), ("teacher", state.teacher))
                     if net is not None}
            out["digests"].append(digest(final))
    out["generator"] = state.generator.get_state()
    out["final"] = final if mesh is None or mesh.rank == 0 else None
    return out


@contextlib.contextmanager
def _patched_draw(masks: GlobalMasks):
    draw = tcommon.Dropout.draw_keep
    tcommon.Dropout.draw_keep = lambda self, x: masks.draw(self, x)
    try:
        yield
    finally:
        tcommon.Dropout.draw_keep = draw


# ---- BatchNorm's gradient through the global statistics ----


def _bn_inputs():
    rng = np.random.RandomState(7)
    x = (rng.randn(6, 5, 4, 4) * 2.0 + 1.0).astype(np.float32)  # NCHW, 3 + 3 rows
    w = rng.randn(6, 5, 4, 4).astype(np.float32)  # the loss is sum(w * bn(x))
    return x, w


def _bn_run(x, w, mesh):
    bn = tcommon.BatchNorm2d(5)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, 5))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, 5))
    bn.train()
    bn.freeze, bn.mesh = False, mesh
    xt = torch.from_numpy(x).requires_grad_(True)
    (bn(xt) * torch.from_numpy(w)).sum().backward()
    return xt.grad, bn


def bn_grad_reference() -> dict:
    """One process over the global batch; ``x_grad_const_stats``: the input
    gradient were the statistics constants."""
    x, w = _bn_inputs()
    x_grad, bn = _bn_run(x, w, None)
    var = torch.from_numpy(x).var(dim=(0, 2, 3), unbiased=False)
    const = torch.from_numpy(w) * (bn.weight.detach() * torch.rsqrt(var + bn.eps))[:, None, None]
    return {"x_grad": x_grad.numpy(), "x_grad_const_stats": const.numpy(),
            "weight_grad": bn.weight.grad.numpy(), "bias_grad": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy()}


def task_bn_grad(task, mesh):
    x, w = _bn_inputs()
    x_grad, bn = _bn_run(local_rows(x, mesh), local_rows(w, mesh), mesh)
    all_reduce_grads(list(bn.parameters()))
    return {"x_grad": x_grad.numpy(), "weight_grad": bn.weight.grad.numpy(),
            "bias_grad": bn.bias.grad.numpy(), "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


def bn_train_inputs() -> dict:
    """A float64 NCHW batch of 6 (3 rows a rank at world 2), 10 channels
    (not a multiple of 8), the loss weights and the module's vectors."""
    rng = np.random.RandomState(11)
    return {"x": rng.randn(6, 10, 3, 5) * rng.uniform(0.5, 2.0, (1, 10, 1, 1)) + 0.5,
            "w": rng.randn(6, 10, 3, 5), "weight": np.linspace(0.5, 1.5, 10),
            "bias": np.linspace(-0.3, 0.3, 10), "running_mean": np.linspace(-1.0, 1.0, 10),
            "running_var": np.linspace(0.5, 2.0, 10)}


def bn_train_run(inp: dict, mesh, relu: bool) -> dict:
    """``ops.batchnorm.batch_norm_train`` forward and backward of the loss
    sum(w * y) on this rank's rows; the weight and bias gradients summed
    over the ranks, as the step sums them."""
    x = torch.from_numpy(local_rows(inp["x"], mesh)).requires_grad_(True)
    weight = torch.from_numpy(inp["weight"]).requires_grad_(True)
    bias = torch.from_numpy(inp["bias"]).requires_grad_(True)
    running = (torch.from_numpy(inp["running_mean"].copy()),
               torch.from_numpy(inp["running_var"].copy()))
    y = batchnorm.batch_norm_train(x, weight, bias, running, 0.9, 1e-5, mesh, relu)
    (y * torch.from_numpy(local_rows(inp["w"], mesh))).sum().backward()
    if mesh is not None:
        all_reduce_grads([weight, bias])
    return {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "weight_grad": weight.grad.numpy(), "bias_grad": bias.grad.numpy(),
            "running_mean": running[0].numpy(), "running_var": running[1].numpy()}


def task_bn_train(task, mesh):
    inp = bn_train_inputs()
    return {relu: bn_train_run(inp, mesh, relu) for relu in (False, True)}


# ---- the training-BN kernels on the card under a mesh ----

BN_CARD_SHAPE = (4, 96, 28, 28)
BN_CARD_CASES = [(dtype, relu) for dtype in (torch.bfloat16, torch.float32)
                 for relu in (True, False)]


def bn_card_run(mesh, dtype, relu) -> dict:
    """The kernels on this rank's rows of the global batch (made on the
    host from a seed): outputs, input gradient, the weight and bias
    gradients summed over the ranks, running statistics, launches."""
    gen = torch.Generator().manual_seed(23)
    x = (torch.randn(BN_CARD_SHAPE, generator=gen) * 1.5 + 0.3).to(dtype)
    dy = torch.randn(BN_CARD_SHAPE, generator=gen).to(dtype)
    vectors = {"weight": torch.rand(BN_CARD_SHAPE[1], generator=gen) + 0.5,
               "bias": torch.rand(BN_CARD_SHAPE[1], generator=gen) - 0.5}
    if relu:
        dy = card.off_the_kink(x, dy, vectors)
    weight = vectors["weight"].cuda().requires_grad_(True)
    bias = vectors["bias"].cuda().requires_grad_(True)
    x, dy = (local_rows(t, mesh).cuda().contiguous(memory_format=torch.channels_last)
             for t in (x, dy))
    x.requires_grad_(True)
    running = (torch.zeros(BN_CARD_SHAPE[1], device="cuda"),
               torch.ones(BN_CARD_SHAPE[1], device="cuda"))
    before = collections.Counter(build.launch_counts)
    y = batchnorm.batch_norm_train(x, weight, bias, running, card.BN_MOMENTUM, card.BN_EPS,
                                   mesh, relu)
    fwd = collections.Counter(build.launch_counts) - before
    y.backward(dy)
    if mesh is not None:
        all_reduce_grads([weight, bias])
    torch.cuda.synchronize()
    return {"y": y.detach().cpu(), "x_grad": x.grad.cpu(), "weight_grad": weight.grad.cpu(),
            "bias_grad": bias.grad.cpu(), "running_mean": running[0].cpu(),
            "running_var": running[1].cpu(), "fwd_launches": sum(fwd.values()),
            "launches": sum((collections.Counter(build.launch_counts) - before).values())}


def task_bn_card(task, mesh):
    return {"world": mesh.size, "runs": {case: bn_card_run(mesh, *case)
                                         for case in BN_CARD_CASES}}


def bn_card_check(tmp_path, world: int) -> float:
    """``world`` gloo ranks sharing the card, each on its rows of
    BN_CARD_SHAPE, bf16 and float32, ReLU on and off, against the kernels
    over the whole batch in this process: one rank bit for bit, two within
    float32 summation order (weight and bias gradients summed over the
    ranks); 4 launches a forward and 4 a backward on every rank. The worst
    gap (``_torch_card.bn_gap``, 1 = at the tolerance); raises
    AssertionError."""
    one = {case: bn_card_run(None, *case) for case in BN_CARD_CASES}
    out = run_ranks(tmp_path, {"kind": "bn_card"}, world, timeout=300)
    rows, worst = BN_CARD_SHAPE[0] // world, 0.0
    for r, rank in enumerate(out):
        assert rank["world"] == world
        for case, want in one.items():
            got = rank["runs"][case]
            assert (got["fwd_launches"], got["launches"]) == (4, 8), (case, r)
            for what in card.BN_LEAVES:
                w = want[what][r * rows:(r + 1) * rows] if what in ("y", "x_grad") \
                    else want[what]
                if world == 1:
                    assert torch.equal(got[what], w), (case, what)
                    continue
                bf16 = case[0] == torch.bfloat16 and what in ("y", "x_grad")
                gap = card.bn_gap(got[what], w, 2 ** -6 if bf16 else 1e-4, 1e-3)
                assert gap <= 1.0, (case, r, what, gap)
                worst = max(worst, gap)
    return worst


# ---- the trainers ----


def tiny_deeplab(num_classes, dtype=None, pretrained=True):
    return tcommon.SegModel("tiny", DeepLab2(num_classes, layers=(1, 1, 1, 1), dtype=dtype),
                            np.zeros(3), np.ones(3), (1, 1), _param_label)


def tiny_denseunet(num_classes, dtype=None, pretrained=True):
    """DenseUNet with DenseNet block config (2, 2, 2, 2): taps of 96, 192,
    192 and 192 channels, a decoder of 192, 192, 96 and 96."""
    return tcommon.SegModel("tiny", denseunet.DenseUNet(num_classes, block_config=(2, 2, 2, 2),
                                                        dtype=dtype),
                            None, None, (32, 32), denseunet._param_label_pretrained)


def tiny_v3plus(num_classes, dtype=None, pretrained=True):
    return tcommon.SegModel("tiny", deeplab3.DeepLabV3Plus(num_classes, layers=(1, 1, 1, 1),
                                                          dtype=dtype),
                            np.zeros(3), np.ones(3), (1, 1), deeplab3._label_imagenet)


def trainer_env(task) -> None:
    """What test_torch_trainer's ``voc`` fixture and tiny arch set up, in a
    rank process (the config's path comes in the environment); a tiny
    DeepLab v3+ under ``task['arch_v3plus']``."""
    from cutmix_seg_tpu_torch.data import sources
    from cutmix_seg_tpu_torch.models import registry

    sources.PascalVOCDataSource.canvas_hw = (48, 48)
    sources.CityscapesDataSource.canvas_hw = task.get("city_canvas", (32, 64))
    sources.ISIC2017DataSource.canvas_hw = task.get("isic_canvas", (48, 48))
    registry.register(task["arch"])(tiny_deeplab)
    if "arch_v3plus" in task:
        registry.register(task["arch_v3plus"])(tiny_v3plus)
    if "arch_denseunet" in task:
        registry.register(task["arch_denseunet"])(tiny_denseunet)


class WriteCounter:
    """Counts this process's calls of the functions that write a run's
    artifacts."""

    def __init__(self):
        from cutmix_seg_tpu_torch.core import checkpoint, job
        from cutmix_seg_tpu_torch.data import sources

        self.counts = {}
        for owner, name in ((checkpoint, "save_checkpoint_async"), (checkpoint, "save_checkpoint"),
                            (checkpoint, "export_params"), (job.RunContext, "log_metrics"),
                            (sources.PascalVOCDataSource, "save_prediction_by_index")):
            self._wrap(owner, name)

    def _wrap(self, owner, name):
        fn = getattr(owner, name)
        self.counts[name] = 0

        def counted(*a, **k):
            self.counts[name] += 1
            return fn(*a, **k)

        setattr(owner, name, counted)


def eval_world(net, ds, mesh, num_classes, fill_holes, spatial=False, n=11):
    """The eval pass over n images in batches of 5 (6 at world 2: rank 1
    takes the padded end of the last batch; with ``spatial`` each rank
    takes its rows of all 5)."""
    from cutmix_seg_tpu_torch.train import common

    return common.evaluate(net, ds, np.arange(n), 5, num_classes, np.zeros(3), np.ones(3),
                           (1, 1), torch.device("cpu"), fill_holes, mesh, spatial)


def holes_net():
    """A 2-class tiny DeepLab v2 from a seed, for the fill-holes eval."""
    torch.manual_seed(5)
    return DeepLab2(2, layers=(1, 1, 1, 1)).eval()


def trainer_fn(trainer: str):
    """The port's ``train.<trainer>.train_seg_semisup_<trainer>``."""
    import importlib

    return getattr(importlib.import_module(f"cutmix_seg_tpu_torch.train.{trainer}"),
                   f"train_seg_semisup_{trainer}")


def task_trainer(task, mesh):
    """A trainer through job.submit for each of ``task['runs']`` (desc,
    param overrides) in turn (the mask_mt trainer on ``task['params']``,
    or the overrides' ``trainer`` on ``task['params_of'][trainer]``): each
    run's final state and this rank's writes; then, unless ``task['eval']``
    is False, the eval pass of the last run's teacher (and of a 2-class net
    with hole filling) over this rank's slices."""
    from cutmix_seg_tpu_torch.core import checkpoint, job

    trainer_env(task)
    writes = WriteCounter()
    out = {"runs": {}}
    for desc, overrides in task["runs"]:
        overrides = dict(overrides)
        trainer = overrides.pop("trainer", "mask_mt")
        params = task["params"] if trainer == "mask_mt" else task["params_of"][trainer]
        eng = job.submit("test_torch_ddp", desc, trainer_fn(trainer),
                         dict(params, **overrides), results_root=task["root"])
        out["runs"][desc] = {"digest": digest(checkpoint.state_to_host(eng.state)),
                             "step": eng.state.step, "start_epoch": eng.start_epoch}
        if desc in task.get("keep_student", ()) and mesh.rank == 0:
            out["runs"][desc]["student"] = eng.state.student.state_dict()
    out["writes"] = dict(writes.counts)
    if not task.get("eval", True):
        return out
    if mesh.rank == 0:  # the last run's eval net, for the parent's world-1 eval
        out["teacher"] = eng.eval_net().state_dict()
    for sp in ((False, True) if task.get("eval_spatial") else (False,)):
        tag = "_spatial" if sp else ""
        n = task.get("eval_n", 11)
        out["iou" + tag] = eval_world(eng.eval_net(), eng.ds, mesh, eng.n_classes, False, sp, n)
        out["iou_holes" + tag] = eval_world(holes_net(), eng.ds, mesh, 2, True, sp, n)
    return out


def task_streams(task, mesh):
    """This rank's first host batches of epoch 0 from the engine's streams."""
    from cutmix_seg_tpu_torch.core import job
    from cutmix_seg_tpu_torch.train import engine, mask_mt as tmask_mt

    trainer_env(task)
    spec, cfg = tmask_mt.build_spec(task["params"])
    eng = engine.TrainEngine(job.RunContext(task["root"], "streams"), spec, cfg,
                             task["params"], "cpu")
    assert eng.setup()
    eng._open_epoch_streams(0)
    try:
        return {"sup": next(eng.sup_stream), **spec.fetch(eng, eng.streams)}
    finally:
        eng.close_streams()


def task_multiseed(task, mesh):
    """The multi-seed trainer through job.submit: this rank's seeds' final
    states."""
    from cutmix_seg_tpu_torch.core import checkpoint, job
    from cutmix_seg_tpu_torch.train import multi_seed_mask_mt as tms

    trainer_env(task)
    writes = WriteCounter()
    states = job.submit("test_torch_mseed", task["desc"], tms.train_seg_semisup_mask_mt_multiseed,
                        task["params"], results_root=task["root"])
    return {"digests": {k: digest(checkpoint.state_to_host(st)) for k, st in states.items()},
            "writes": dict(writes.counts)}


# ---- spatial partitioning (parallel.spatial) ----


class OpNet(torch.nn.Module):
    """One cross-row operation as a network (NHWC in and out) of a given
    global input height, so ``set_spatial`` and its trace apply to it."""

    supports_spatial = True

    def __init__(self, op, h, **kw):
        super().__init__()
        self.spatial, self.op, self.h, self.kw = None, op, h, kw
        if op in ("conv", "pool_bn", "ppm_bn"):
            gen = torch.Generator().manual_seed(0)
            self.conv = tcommon.Conv2d(kw["cin"], kw["cout"], kw["k"], stride=kw["s"],
                                       padding=kw["p"], dilation=kw["d"], bias=op == "conv")
            with torch.no_grad():
                self.conv.weight.normal_(generator=gen)
                if op == "conv":
                    self.conv.bias.normal_(generator=gen)
        if op in ("pool_bn", "ppm_bn"):  # a pooled map: 1x1 conv (no bias), training BN
            self.bn = tcommon.BatchNorm2d(kw["cout"])
            self.bn.freeze = False
            with torch.no_grad():
                self.bn.weight.copy_(torch.linspace(0.5, 1.5, kw["cout"]))
                self.bn.bias.copy_(torch.linspace(-0.2, 0.2, kw["cout"]))

    def forward(self, x):
        if self.spatial is not None:
            self.spatial.begin(self, x, self.h)
        if self.op == "conv":
            return self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.op == "pool":
            return tcommon.max_pool_ceil(x, 3, 2, 1, spatial=self.spatial)
        xc = x.permute(0, 3, 1, 2)
        if self.op == "pool_floor":
            return tcommon.max_pool_floor(xc, 3, 2, 1, spatial=self.spatial).permute(0, 2, 3, 1)
        if self.op == "mean":  # the image pooling, spread back over the rows
            y = tcommon.adaptive_avg_pool(xc, 1, self.spatial)
            return y.expand(xc.shape).permute(0, 2, 3, 1)
        if self.op == "pool_bn":
            y = F.relu(self.bn(self.conv(tcommon.adaptive_avg_pool(xc, 1, self.spatial))))
            return y.expand(-1, -1, *xc.shape[2:]).permute(0, 2, 3, 1)
        if self.op == "nearest":
            return tcommon.upsample_nearest_2x(xc, self.spatial).permute(0, 2, 3, 1)
        if self.op == "avg":
            return tcommon.avg_pool_floor(xc, 2, 2, self.spatial).permute(0, 2, 3, 1)
        if self.op == "bins":  # the pooled map, whole on every rank
            return tcommon.adaptive_avg_pool(xc, self.kw["bins"], self.spatial).permute(0, 2, 3, 1)
        if self.op in ("ppm", "ppm_bn"):  # PSPNet's pyramid level, back to the rows
            y = tcommon.adaptive_avg_pool(xc, self.kw["bins"], self.spatial)
            if self.op == "ppm_bn":
                y = F.relu(self.bn(self.conv(y)))
            y = tcommon.resize_half_pixel_to_rows(y, tuple(xc.shape[2:]), self.spatial)
            return y.permute(0, 2, 3, 1)
        if self.op == "half":  # (split: the output height comes from the trace)
            y = tcommon.resize_bilinear_half_pixel(xc, self.kw["out"], self.spatial)
            return y.permute(0, 2, 3, 1)
        return tcommon.upsample_bilinear_align_corners(x, self.kw["out"], spatial=self.spatial)


def _conv(cin, cout, k, s, p, d):
    return dict(cin=cin, cout=cout, k=k, s=s, p=p, d=d)


SPATIAL_OPS = {  # name: (op, global input height, options); inputs (2, h, 11, C)
    "stem_7x7_s2": ("conv", 36, _conv(3, 4, 7, 2, 3, 1)),
    "stem_7x7_s2_256": ("conv", 256, _conv(3, 2, 7, 2, 3, 1)),
    "proj_1x1_s2_65": ("conv", 65, _conv(3, 4, 1, 2, 0, 1)),
    "proj_1x1_s2_10": ("conv", 10, _conv(3, 4, 1, 2, 0, 1)),
    "conv_1x1": ("conv", 33, _conv(3, 4, 1, 1, 0, 1)),
    "conv_3x3_d1": ("conv", 33, _conv(3, 4, 3, 1, 1, 1)),
    "conv_3x3_d2": ("conv", 33, _conv(3, 4, 3, 1, 2, 2)),
    "conv_3x3_d4": ("conv", 17, _conv(3, 4, 3, 1, 4, 4)),
    "aspp_d6_halo_gt_shard": ("conv", 5, _conv(3, 4, 3, 1, 6, 6)),
    "aspp_d12": ("conv", 33, _conv(3, 4, 3, 1, 12, 12)),
    "aspp_d18": ("conv", 33, _conv(3, 4, 3, 1, 18, 18)),
    "aspp_d24_33": ("conv", 33, _conv(3, 4, 3, 1, 24, 24)),
    "pool_ceil_18": ("pool", 18, {}),
    "pool_ceil_129": ("pool", 129, {}),
    "up_5_to_36": ("up", 5, dict(out=(36, 11))),
    "up_33_to_256": ("up", 33, dict(out=(256, 7))),
    "up_9_to_9": ("up", 9, dict(out=(9, 14))),
    # DeepLab v3/v3+: the torchvision stem's floor-mode pool, the image
    # pooling's mean and the half-pixel resizes (ASPP output to layer1's
    # size, logits to the input's; up and down)
    "pool_floor_18": ("pool_floor", 18, {}),
    "pool_floor_65": ("pool_floor", 65, {}),
    "pool_floor_129": ("pool_floor", 129, {}),
    "mean_5": ("mean", 5, {}),
    "mean_33": ("mean", 33, {}),
    "half_5_to_9": ("half", 5, dict(out=(9, 14))),
    "half_9_to_36": ("half", 9, dict(out=(36, 11))),
    "half_33_to_65": ("half", 33, dict(out=(65, 7))),
    "half_65_to_257": ("half", 65, dict(out=(257, 11))),
    "half_36_to_17": ("half", 36, dict(out=(17, 8))),
    "half_7_to_7": ("half", 7, dict(out=(7, 5))),
    # the pooled value feeds a training BN on every model rank of an image:
    # its world-wide sums count it S times, its gradient must not
    "pool_bn_33": ("pool_bn", 33, dict(_conv(3, 4, 1, 1, 0, 1), n=4)),
}


# the cross-row operations of PSPNet, ResUNet and DenseUNet
# (tests/test_torch_spatial_families.py): the nearest upsample where an
# output range starts on an odd row (3 -> 6, 7 -> 14 at S = 2), the 2x2
# average pool where a window straddles the split (6 -> 3, 14 -> 7), the
# adaptive pool into PSPNet's bins (overlapping, and 6 bins on 5 rows),
# alone and resized back to the rows from the whole pooled map (2 -> 5,
# 6 -> 5), and into a training BN
FAMILY_OPS = {
    "nearest_3_to_6": ("nearest", 3, {}),
    "nearest_7_to_14": ("nearest", 7, {}),
    "nearest_9_to_18": ("nearest", 9, {}),
    "avg_6_to_3": ("avg", 6, {}),
    "avg_14_to_7": ("avg", 14, {}),
    "avg_15_to_7": ("avg", 15, {}),
    "bins1_5": ("bins", 5, dict(bins=1)),
    "bins2_5": ("bins", 5, dict(bins=2)),
    "bins3_5": ("bins", 5, dict(bins=3)),
    "bins6_5": ("bins", 5, dict(bins=6)),
    "bins6_32": ("bins", 32, dict(bins=6)),
    "ppm1_5": ("ppm", 5, dict(bins=1)),
    "ppm2_5": ("ppm", 5, dict(bins=2)),
    "ppm3_9": ("ppm", 9, dict(bins=3)),
    "ppm6_5": ("ppm", 5, dict(bins=6)),
    "ppm_bn2_5": ("ppm_bn", 5, dict(_conv(3, 4, 1, 1, 0, 1), bins=2, n=4)),
    "ppm_bn6_5": ("ppm_bn", 5, dict(_conv(3, 4, 1, 1, 0, 1), bins=6, n=4)),
}


def spatial_op_run(name: str, mesh) -> dict:
    """One op of SPATIAL_OPS or FAMILY_OPS on its seeded global input:
    alone (mesh None) on the whole input, else on this rank's rows of it.
    Returns the output rows, the input gradient of sum(out * g) (g seeded,
    of the output's shape; a pooled map's output is whole on every rank,
    which then takes 1 / S of g) and the conv's weight and bias gradients."""
    ops = SPATIAL_OPS if name in SPATIAL_OPS else FAMILY_OPS
    op, h, kw = ops[name]
    rng = np.random.RandomState(sorted(ops).index(name))
    x = torch.from_numpy(rng.randn(kw.get("n", 2), h, 11, kw.get("cin", 3)).astype(np.float32))
    net = OpNet(op, h, **kw)
    tcommon.set_bn_mesh(net, mesh)
    with torch.no_grad():
        h_out = net(x).shape[1]
    g = torch.from_numpy(rng.randn(x.shape[0], h_out, *net(x).shape[2:]).astype(np.float32))
    if mesh is not None:
        from cutmix_seg_tpu_torch.parallel import spatial

        spatial.set_spatial(net, mesh)
        x = spatial.slice_h(x, mesh)
        g = g / mesh.n_model if op == "bins" else spatial.slice_h(g, mesh)
    x = x.clone().requires_grad_(True)
    out = net(x)
    (out * g).sum().backward()
    res = {"out": out.detach(), "x_grad": x.grad}
    if op == "conv":
        res.update(w_grad=net.conv.weight.grad, b_grad=net.conv.bias.grad)
    if op in ("pool_bn", "ppm_bn"):
        res.update(w_grad=net.conv.weight.grad, bn_w_grad=net.bn.weight.grad,
                   bn_b_grad=net.bn.bias.grad, running_var=net.bn.running_var.clone())
    return res


class ArraySource:
    """An eval source held in memory: ``n`` images of varying sizes up to
    ``canvas_hw``, labels with 255 borders (test_torch_eval.MemorySource)."""

    def __init__(self, n, seed, canvas_hw, num_classes):
        rng = np.random.RandomState(seed)
        self.canvas_hw, self.num_classes = canvas_hw, num_classes
        self.images, self.labels = [], []
        for _ in range(n):
            h = rng.randint(canvas_hw[0] // 2, canvas_hw[0] + 1)
            w = rng.randint(canvas_hw[1] // 2, canvas_hw[1] + 1)
            self.images.append(rng.randint(0, 256, size=(h, w, 3)).astype(np.uint8))
            lab = rng.randint(0, num_classes, size=(h, w)).astype(np.int32)
            lab[0] = 255
            self.labels.append(lab)

    def get_image(self, i):
        return self.images[i]

    def get_labels(self, i):
        return self.labels[i]


def spatial_model_run(task, mesh) -> dict:
    """The tiny DeepLab v2 of ``task['state_dict']`` in eval mode: the
    logits of ``task['x']``, each raw batch's confusion matrix (H padded to
    the split) and the eval passes over ``task['source']`` (plain and with
    hole filling on a 2-class net), and the logits and matrices of the tiny
    v3 / v3+ of ``task['families']``, alone (mesh None) or split over
    ``mesh``'s ranks (``--eval_spatial``)."""
    from cutmix_seg_tpu_torch.ops.iou import confusion_matrix
    from cutmix_seg_tpu_torch.parallel import spatial
    from cutmix_seg_tpu_torch.train import common

    net = DeepLab2(C, layers=(1, 1, 1, 1))
    net.load_state_dict(task["state_dict"])
    net.eval()
    mean, std = task["mean"], task["std"]
    dev = torch.device("cpu")
    sp_mesh, split = common.eval_layout(mesh, True)
    out = {"cms": []}
    x = torch.from_numpy(task["x"])
    with torch.no_grad():
        if split:
            spatial.set_spatial(net, sp_mesh)
            x = spatial.slice_h(x, sp_mesh)
        out["logits"] = net(x)
    for batch in task["batches"]:
        if split:
            batch = spatial.pad_batch_h(batch, spatial.spatial_h_axis_size(sp_mesh))
        pred, y = common.predict_rows(net, batch, mean, std, dev, sp_mesh, split)
        cm = confusion_matrix(pred, y, C)
        if mesh is not None:
            dist.all_reduce(cm)
        out["cms"].append(cm)
    src = task["source"]
    idx = np.arange(len(src.images))
    out["iou"] = common.evaluate(net, src, idx, 3, C, mean, std, (1, 1), dev, False, mesh, True)
    out["iou_holes"] = common.evaluate(holes_net(), src, idx, 3, 2, mean, std, (1, 1), dev,
                                       True, mesh, True)
    # DeepLab v3 / v3+ (task['families']: name -> state_dict): the logits
    # of task['x'] and each raw batch's confusion matrix, the batch padded
    # to task['pad_h'] rows alone too (the image pooling's mean reads the
    # padded rows)
    for name, sd in task.get("families", {}).items():
        fam = MODELS[name]().module
        fam.load_state_dict(sd)
        fam.eval()
        x = torch.from_numpy(task["x"])
        with torch.no_grad():
            if split:
                spatial.set_spatial(fam, sp_mesh)
                x = spatial.slice_h(x, sp_mesh)
            got = {"logits": fam(x), "cms": []}
        for batch in task["batches"]:
            batch = spatial.pad_batch_h(batch, task["pad_h"])
            pred, y = common.predict_rows(fam, batch, mean, std, dev, sp_mesh, split)
            cm = confusion_matrix(pred, y, C)
            if mesh is not None:
                dist.all_reduce(cm)
            got["cms"].append(cm)
        out[name] = got
    return out


def families_model_run(models: dict, mesh) -> dict:
    """Per tiny family of ``models`` (name -> {"state_dict", "x",
    "batches", "pad_h"}) in eval mode, alone (mesh None) or split over
    ``mesh``'s ranks (``--eval_spatial``): the logits of x and each raw
    batch's confusion matrix, the batch's H padded to ``pad_h`` rows."""
    from cutmix_seg_tpu_torch.ops.iou import confusion_matrix
    from cutmix_seg_tpu_torch.parallel import spatial
    from cutmix_seg_tpu_torch.train import common

    sp_mesh, split = common.eval_layout(mesh, True)
    dev = torch.device("cpu")
    out = {}
    for name, m in models.items():
        net = MODELS[name]().module
        net.load_state_dict(m["state_dict"])
        net.eval()
        x = torch.from_numpy(m["x"])
        with torch.no_grad():
            if split:
                spatial.set_spatial(net, sp_mesh)
                x = spatial.slice_h(x, sp_mesh)
            got = {"logits": net(x), "cms": []}
        for batch in m["batches"]:
            batch = spatial.pad_batch_h(batch, m["pad_h"])
            pred, y = common.predict_rows(net, batch, m["mean"], m["std"], dev, sp_mesh, split)
            cm = confusion_matrix(pred, y, C)
            if mesh is not None:
                dist.all_reduce(cm)
            got["cms"].append(cm)
        out[name] = got
    return out


def task_spatial_ops(task, mesh):
    return {name: spatial_op_run(name, mesh) for name in SPATIAL_OPS}


def task_families(task, mesh):
    """tests/test_torch_spatial_families.py's work at one world size, in
    one spawn: ``task['ops']`` of FAMILY_OPS, and where given the tiny
    families' forwards and evals (``task['models']``), step cases
    (``task['cases']``) and trainer runs (``task['trainer']``, a
    ``task_trainer`` task); with ``task['alone']`` (one rank) the ops,
    forwards and steps without a mesh: the port alone."""
    if task.get("alone"):
        mesh = None
    out = {"ops": {name: spatial_op_run(name, mesh) for name in task["ops"]}}
    if "models" in task:
        out["models"] = families_model_run(task["models"], mesh)
    if "cases" in task:
        out["steps"] = {name: run_steps(case, mesh) for name, case in task["cases"].items()}
    if "trainer" in task:
        out["trainer"] = task_trainer(task["trainer"], mesh)
    return out


def task_spatial_model(task, mesh):
    return spatial_model_run(task, mesh)


# ---- the rank processes' tasks ----


def task_steps(task, mesh):
    return {name: run_steps(case, mesh) for name, case in task["cases"].items()}


def task_collectives(task, mesh):
    """Each of parallel.mesh's collectives on rank-dependent values."""
    from cutmix_seg_tpu_torch.parallel import mesh as mesh_mod

    r = mesh.rank
    lin = torch.nn.Linear(2, 1)
    with torch.no_grad():
        lin.weight.fill_(1.0)
        lin.bias.fill_(0.0)
    lin.weight.grad = torch.full((1, 2), float(r + 1))  # the bias has no gradient
    extra = mesh_mod.all_reduce_grads(list(lin.parameters()), torch.tensor([r + 1.0]))
    return {"weight_grad": lin.weight.grad.numpy(), "bias_grad": lin.bias.grad.numpy(),
            "extra": extra.numpy(),
            "rows": mesh_mod.gather_rows(torch.full((2, 3), float(r)), mesh).numpy(),
            "gather_host": mesh_mod.gather_host(10.0 + r), "lead_value": mesh_mod.lead_value(7.0 + r),
            "world": mesh_mod.world(), "rank": mesh_mod.rank(), "is_lead": mesh_mod.is_lead(),
            "data_mesh": mesh_mod.data_mesh()}


def task_stall(task, mesh):
    """Rank 1 never joins the collective."""
    if mesh.rank == 1:
        time.sleep(3600)
    t = torch.ones(1)
    dist.all_reduce(t)
    return float(t)


TASKS = {"steps": task_steps, "stall": task_stall, "collectives": task_collectives, "bn_grad": task_bn_grad,
         "bn_train": task_bn_train, "bn_card": task_bn_card,
         "trainer": task_trainer, "streams": task_streams, "multiseed": task_multiseed,
         "spatial_ops": task_spatial_ops, "spatial_model": task_spatial_model,
         "families": task_families}


def main(argv) -> None:
    d, rank, world = Path(argv[0]), int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    task = torch.load(d / "task.pt", weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=task.get("timeout", 120)))
    try:
        out = TASKS[task["kind"]](task, Mesh(world, rank, task.get("n_model", 1)))
    finally:
        dist.destroy_process_group()
    torch.save(out, d / f"out_{rank}.pt")


if __name__ == "__main__":
    main(sys.argv[1:])
