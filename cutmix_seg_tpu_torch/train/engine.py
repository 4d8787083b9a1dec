"""Training engine (port of cutmix_seg_tpu.train.engine), on one GPU or
data-parallel over several, one process each: dataset splits,
model/optimiser/state construction, host loaders, device augmentation, the
algorithm step, per-epoch evaluation of the EMA teacher with the
reference's exact log line, JSONL metrics, checkpoints and resume, NaN
bail-out, SIGTERM stop, and the final save-model / save-preds / test-eval
stage (reference: train_seg_semisup_mask_mt.py:64-577). Each trainer
supplies an ``AlgorithmSpec``: its step factory and how its unsupervised
batch is made from the host streams.

Several GPUs (``torchrun --nproc_per_node=N``; ``parallel.mesh``): rank r is
JAX process r with one device. With ``--spatial_train S`` (``parallel.spatial``;
every step, on every architecture) the N ranks are JAX's 2-D mesh of N / S data
indices by S model ranks, model minor: rank r's data index is r // S, and the
S ranks of a data index split each image's rows (S = 1: every rank is a data
index). The global batch is ``batch_size`` times the data indices; data
index d draws its host streams from ``seed + d * 7919`` with ``batch_size``
images, its model ranks augment the same full crops and the step cuts their
rows, and the step, the augmentation's colour draws and the eval are global
(``parallel.mesh``). ``--eval_spatial`` over several ranks splits the eval
images' rows too: over the S model ranks, or over every rank without
``--spatial_train``. Only rank 0 writes the log, the metrics JSONL,
checkpoints, model.pt and predictions; every rank restores from the shared
run directory. The step's metrics are already global (summed over the ranks
with the gradients), so every rank fetches the same sums and bails out on a
NaN together. A SIGTERM stops every rank at the next epoch boundary (the
flags are summed over the ranks once per epoch).

Each iteration runs, in order: the copy of the uint8 canvases and matrices
to the device (with the device-resident store, ``--data_on_device``, only
row indices, sizes and matrices, and the canvases are gathered from the
store on the device), the device augmentation (``augmentor.sup`` and the
algorithm's ``compose``), and the step. The JAX package traces the three into
one program; here they are eager calls on the device's stream. Metric sums
stay on the device and are fetched once per epoch (and every
``nan_check_interval`` iterations for the NaN check). The mask_mt step is
replayed from a CUDA graph from its second iteration on
(``semisup.step_graph``); its counters go into each epoch's JSONL line,
beside the training-BN kernels' launches (``ops.batchnorm.counters``). Each
part of an iteration is a ``record_function`` span (trainer.fetch, trainer.copy,
trainer.augment, trainer.step), and inside trainer.step the step marks its
phases (step.perturb, step.teacher, step.student, step.backward,
step.update; ``semisup.stepcore``), so a ``--profile_dir`` trace
(``utils.profiling``, iterations 2-4 of the first epoch) attributes the
host's time and every kernel to a phase.

The JAX trainer's own refusals (a crop height that S does not divide, a
mismatched ``--n_devices``, a world that S does not divide) raise at setup,
before any data loads (``check_ported``). A network registered outside the
JAX package's names without the spatial forms of its operations raises,
naming ROADMAP A6c, when a step or eval first splits it
(``parallel.spatial.set_spatial``).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from cutmix_seg_tpu_torch.aug import affine as host_affine
from cutmix_seg_tpu_torch.core import checkpoint as ckpt
from cutmix_seg_tpu_torch.core import job
from cutmix_seg_tpu_torch.core.train_state import create_train_state
from cutmix_seg_tpu_torch.data import datasets
from cutmix_seg_tpu_torch.data import resident as res_mod
from cutmix_seg_tpu_torch.data.loader import HostBatchBuilder, train_stream
from cutmix_seg_tpu_torch.models import registry
from cutmix_seg_tpu_torch.ops import batchnorm
from cutmix_seg_tpu_torch.ops.iou import EvaluatorIoU
from cutmix_seg_tpu_torch.parallel import mesh as mesh_mod
from cutmix_seg_tpu_torch.semisup.stepcore import ConsistencyCommon, accum_zero_metrics
from cutmix_seg_tpu_torch.train import common
from cutmix_seg_tpu_torch.utils import profiling
from cutmix_seg_tpu_torch.utils.device import resolve_device
from cutmix_seg_tpu_torch.utils.rampup import sigmoid_rampup


@dataclasses.dataclass
class AlgorithmSpec:
    """What differs between trainers.

    make_step(model, opt, mesh) -> step(state, batch, ramp) -> (state, metrics).
    unsup_streams: number of independent unsupervised streams (mask_mt mix:
        2; others: 1). ICT draws twice from its single stream.
    pair_geom: sample two correlated geometric transforms per image (aug_mt).
    fetch: fn(engine, streams) -> the host-side raw unsup batch (dicts of
        numpy arrays straight off the loaders).
    compose: fn(augmentor, raw, generator) -> the unsup part of the step's
        batch, from the raw batch on the device.
    """

    make_step: Callable
    unsup_streams: int
    pair_geom: bool
    fetch: Callable
    compose: Callable


def check_ported(p: dict) -> int:
    """Refuse, before any data loads, what the JAX trainer refuses at this
    process group's world size; returns the H-split ways S of
    --spatial_train. Every ``--arch`` of the JAX package runs with
    ``--spatial_train S`` and with ``--eval_spatial`` over several ranks."""
    registry.get(p["arch"])  # an unknown name raises KeyError
    world = mesh_mod.world()
    S = int(p.get("spatial_train", 1) or 1)
    crop_hw = common.parse_crop_size(p["crop_size"])
    if S > 1 and crop_hw is not None and crop_hw[0] % S != 0:
        raise ValueError(
            f"--spatial_train {S} requires the crop height ({crop_hw[0]}) to divide "
            "exactly by the H-shard ways; pick a crop height that is a multiple "
            "(sharded dims must divide the mesh axis)")
    check_n_devices(p, world)
    if world % S != 0:
        raise ValueError(
            f"n_model={S} does not divide the device count ({world}); pass n_data "
            "explicitly to use a subset")
    return S


def check_n_devices(p: dict, world: int) -> None:
    """--n_devices -1 means every rank (one GPU per process); any other
    value must be the world size."""
    n_dev = p.get("n_devices", -1)
    if n_dev not in (-1, world):
        raise ValueError(
            f"--n_devices {n_dev} does not match the {world} process(es) of this "
            "run (one GPU per process: torchrun --nproc_per_node=N)")


class TrainEngine:
    def __init__(self, ctx: job.RunContext, spec: AlgorithmSpec,
                 algo_cfg: ConsistencyCommon, p: dict, device=None):
        self.ctx = ctx
        self.spec = spec
        self.algo_cfg = algo_cfg
        self.p = dict(p)
        self.device = device

    # ---- construction ----
    def setup(self):
        p = self.p
        self.device = resolve_device(self.device)
        # before anything touches the data: the refusals depend on the world
        mesh_mod.maybe_initialize_distributed(self.device)
        self.spatial_n = check_ported(p)
        self.mesh = mesh_mod.data_mesh(self.spatial_n)
        self.is_lead = mesh_mod.is_lead()
        if self.device.type == "cuda":
            # the crop and eval shapes are fixed: cuDNN picks its algorithms
            # once per shape
            torch.backends.cudnn.benchmark = True
        self.crop_hw = common.parse_crop_size(p["crop_size"])
        if self.crop_hw is None:
            raise ValueError("the pipeline requires a crop_size (static shapes)")

        ds_dict = datasets.load_dataset(
            p["dataset"], p["n_val"], p["val_seed"], p["n_sup"], p["n_unsup"],
            p["split_seed"], p["split_path"])
        self.ds = ds_dict["ds_src"]
        self.sup_ndx = ds_dict["sup_ndx"]
        self.unsup_ndx = ds_dict["unsup_ndx"]
        self.val_ndx = ds_dict["val_ndx_tgt"]
        self.test_ndx = ds_dict["test_ndx_tgt"]
        self.n_classes = self.ds.num_classes
        if p["bin_fill_holes"] and self.n_classes != 2:
            print("Binary hole filling can only be used with binary (2-class) "
                  "segmentation datasets")
            return False
        print("Loaded data")

        self.model = common.build_model(p["arch"], self.n_classes,
                                        p.get("compute_dtype", "bfloat16"))
        mean, std = common.resolve_mean_std(self.model, self.ds)
        self.mean = torch.as_tensor(mean, dtype=torch.float32, device=self.device)
        self.std = torch.as_tensor(std, dtype=torch.float32, device=self.device)

        if p["iters_per_epoch"] == -1:
            p["iters_per_epoch"] = len(self.unsup_ndx) // p["batch_size"]
        total_iters = p["iters_per_epoch"] * p["num_epochs"]
        opt_cfg = common.build_optimizer_config(
            p["opt_type"], p["learning_rate"], p["lr_sched"],
            p["lr_step_epochs"], p["lr_step_gamma"], p["lr_poly_power"],
            total_iters, p["iters_per_epoch"], p["sgd_momentum"],
            p["sgd_nesterov"], p["sgd_weight_decay"])

        self.mean_teacher = p["model"] == "mean_teacher"
        if p["model"] not in ("mean_teacher", "pi"):
            print(f"Unknown model type {p['model']}")
            return False
        self.state, self.opt = create_train_state(
            self.model, opt_cfg, p.get("seed", 0), device=self.device,
            mean_teacher=self.mean_teacher,
            pretrained=not p.get("no_pretrained", False))
        print("Built network")

        self.start_epoch = 0
        if p.get("resume"):
            latest = ckpt.latest_checkpoint(self.ctx.checkpoint_dir)
            if latest is not None:
                ckpt.restore_checkpoint(latest, self.state)
                self.start_epoch = self.state.step // max(p["iters_per_epoch"], 1)
                print(f"Resumed from {latest} at epoch {self.start_epoch}")
            steps = mesh_mod.gather_host(self.state.step)
            if len(set(steps)) != 1:
                # only rank 0 saves: a rank without the shared run
                # directory would restart fresh and hang the collectives
                raise RuntimeError(
                    "--resume requires every process to restore the same "
                    f"checkpoint step; got {[int(s) for s in steps]} — use a "
                    "shared results directory across hosts")

        self.geom = common.build_geom(p, self.crop_hw, pair="aug_offset_range" in p)
        self.augmentor = common.DeviceAugmentor(
            self.mean, self.std, self.crop_hw, self.geom.mode, common.build_colour(p),
            separable=common.separable_for_geom(self.geom), mesh=self.mesh)
        self.step = self.spec.make_step(self.model, self.opt, self.mesh)

        self.use_cons = self.algo_cfg.cons_weight > 0.0
        self._setup_resident(p)
        self._sup_builder = HostBatchBuilder(
            self.ds, self.geom, with_labels=True, n_threads=p["num_workers"],
            resident=self.resident)
        self._unsup_builder = (HostBatchBuilder(
            self.ds, self.geom, with_labels=False, pair_geom=self.spec.pair_geom,
            n_threads=p["num_workers"], resident=self.resident)
            if self.use_cons else None)
        self._seed = p.get("seed", 0)
        # each data index its own host streams (the model ranks of an image
        # load the same samples); the colour draws, made for the global
        # batch, from the base seed on every rank
        data_index = 0 if self.mesh is None else self.mesh.data_index
        self._stream_seed = self._seed + data_index * 7919
        self.global_batch = mesh_mod.global_rows(p["batch_size"], self.mesh)
        # streams are (re)opened per epoch with epoch-folded seeds
        self.sup_stream = None
        self.streams = []

        print("Settings:")
        print(", ".join(f"{k}={self.p[k]}" for k in sorted(self.p)))
        print("Dataset:")
        print(f"len(sup_ndx)={len(self.sup_ndx)}")
        print(f"len(unsup_ndx)={len(self.unsup_ndx)}")
        print(f"len(val_ndx)={len(self.val_ndx)}")
        if self.test_ndx is not None:
            print(f"len(test_ndx)={len(self.test_ndx)}")
        if p["n_sup"] != -1:
            print(f"sup_ndx={self.sup_ndx.tolist()}")
        return True

    def _setup_resident(self, p):
        """Stage the training canvases in device memory (data/resident.py):
        'off' streams them from the host, 'on' stages them, 'auto' stages
        them when they fit in ``resident.DEFAULT_MAX_BYTES``, as the JAX
        trainer decides."""
        self.resident = None
        mode = p.get("data_on_device", "auto")
        if mode not in ("auto", "on", "off"):
            raise ValueError(f"--data_on_device must be auto/on/off, got {mode}")
        if mode == "off":
            return
        if mesh_mod.world() > 1:
            if mode == "on":
                raise ValueError(
                    "--data_on_device on is single-process only (replicating "
                    "the store across DCN hosts is not supported); use auto/off")
            return
        need = (np.unique(np.concatenate([self.sup_ndx, self.unsup_ndx]))
                if self.use_cons else np.unique(self.sup_ndx))
        nbytes = res_mod.resident_nbytes(self.ds, len(need), True)
        if mode == "auto" and nbytes > res_mod.DEFAULT_MAX_BYTES:
            return
        self.resident = res_mod.ResidentDataset(self.ds, need, self.device, with_labels=True)
        print(f"Data on device: {len(need)} canvases "
              f"({nbytes / 1e6:.0f} MB) staged in HBM")

    def _open_epoch_streams(self, epoch_i: int):
        """(Re)open the host input streams and the colour generator with
        epoch-folded seeds: host randomness and colour draws are a pure
        function of (seed, rank, epoch), and the box generator is part of
        the checkpointed state, so a --resume from an epoch-boundary
        checkpoint continues the run exactly (bit for bit on the CPU)."""
        self.close_streams()
        ep = common.epoch_stream_seed(self._stream_seed, epoch_i)
        bs = self.p["batch_size"]
        self.sup_stream = train_stream(self._sup_builder, self.sup_ndx, bs, seed=ep + 10)
        if self.use_cons:
            ub = bs * self.p["unsup_batch_ratio"]
            for si in range(self.spec.unsup_streams):
                self.streams.append(train_stream(
                    self._unsup_builder, self.unsup_ndx, ub, seed=ep + 20 + si * 10))
        self.colour_gen = torch.Generator(device=self.device).manual_seed(
            common.epoch_colour_seed(self._seed, epoch_i))

    def close_streams(self):
        if getattr(self, "sup_stream", None) is not None:
            self.sup_stream.close()
        for s in getattr(self, "streams", ()):
            s.close()
        self.sup_stream = None
        self.streams = []

    # ---- batches ----
    def make_raw_batch(self):
        """Host work, then the copy: pull decoded canvases and matrices (or,
        from the resident store, row indices and matrices) off the streams
        and place them on the device."""
        with record_function("trainer.fetch"):
            raw = {"sup": next(self.sup_stream)}
            if self.use_cons:
                raw.update(self.spec.fetch(self, self.streams))
        with record_function("trainer.copy"):
            return {k: common.to_device(v, self.device) for k, v in raw.items()}

    def make_batch(self, raw):
        """The step's batch from a raw batch on the device."""
        with record_function("trainer.augment"):
            if self.resident is not None:
                raw = {k: res_mod.gather_part(self.resident.data, v, with_labels=(k == "sup"))
                       for k, v in raw.items()}
            sup = self.augmentor.sup(raw["sup"])
            batch = {"sup_x": sup["image"], "sup_y": sup["labels"]}
            if self.use_cons:
                batch.update(self.spec.compose(self.augmentor, raw, self.colour_gen))
            return batch

    def step_counters(self) -> dict:
        """The step's CUDA-graph counters (captures, replays, eager_steps;
        ``semisup.step_graph``) where it keeps them, else {}."""
        counters = getattr(self.step, "counters", None)
        return counters() if counters is not None else {}

    def eval_net(self):
        return self.state.teacher if self.mean_teacher else self.state.student

    # ---- the loop ----
    def run(self):
        if not self.setup():
            return
        # SIGTERM (preemptible machines): the handler only sets a flag. One
        # process stops before the next iteration; several finish the epoch
        # and stop together at its boundary (a lone stop would leave the
        # others waiting in a collective). The last epoch-boundary
        # checkpoint resumes the run exactly.
        self._preempted = False
        self._solo = mesh_mod.world() == 1

        def _on_term(signum, frame):
            self._preempted = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not the main thread: no preemption handling
            prev_handler = None
        try:
            self._run_epochs()
        except BaseException:
            self.close_streams()
            # join the writer, but never let a checkpoint error mask the
            # training failure
            try:
                ckpt.wait_pending_saves(self.ctx.checkpoint_dir)
            except Exception as e:
                print(f"WARNING: async checkpoint write also failed: {e}")
            raise
        else:
            self.close_streams()
            ckpt.wait_pending_saves(self.ctx.checkpoint_dir)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _run_epochs(self):
        p = self.p
        print("Training...")
        for epoch_i in range(self.start_epoch, p["num_epochs"]):
            t1 = time.time()
            self._open_epoch_streams(epoch_i)
            ramp = sigmoid_rampup(epoch_i, p["rampup"]) if p["rampup"] > 0 else 1.0

            msum = accum_zero_metrics(self.use_cons, self.device)
            n_steps = 0
            profile_dir = p.get("profile_dir") if epoch_i == self.start_epoch else None
            prof = None
            for it in range(p["iters_per_epoch"]):
                # checked before the iteration: a signal during an epoch's
                # last step lets it finish (eval + checkpoint)
                if self._solo and self._preempted:
                    if prof is not None:
                        profiling.stop_profile(prof, self.device, profile_dir)
                    print("PREEMPTED: stopped at epoch {} before iter {}; "
                          "the latest epoch-boundary checkpoint resumes "
                          "this run exactly (--resume)".format(epoch_i + 1, it + 1),
                          flush=True)
                    return
                if profile_dir and it == 2:
                    # iterations 2-4: steady state, and regular steps (the
                    # step count per epoch must stay as it is for resume)
                    prof = profiling.start_profile(self.device)
                batch = self.make_batch(self.make_raw_batch())
                with record_function("trainer.step"):
                    self.state, metrics = self.step(self.state, batch, ramp)
                msum = {k: msum[k] + v for k, v in metrics.items()}
                n_steps += 1
                if prof is not None and (it >= 4 or it == p["iters_per_epoch"] - 1):
                    profiling.stop_profile(prof, self.device, profile_dir)
                    prof, profile_dir = None, None
                if (it + 1) % p.get("nan_check_interval", 100) == 0:
                    # a NaN in any step poisons the running sum
                    if common.check_nan(float(msum["sup_loss"])):
                        return

            # one fetch of the metric sums per epoch
            m = {k: float(v) / max(n_steps, 1) for k, v in msum.items()}
            t_train = time.time() - t1
            sup_loss_acc = m.get("sup_loss", 0.0)
            cons_loss_acc = m.get("cons_loss", 0.0)
            conf_rate_acc = m.get("conf_rate", ramp if p["rampup"] > 0 else 0.0)
            if common.check_nan(sup_loss_acc) or common.check_nan(cons_loss_acc):
                return

            iou = common.evaluate(
                self.eval_net(), self.ds, self.val_ndx, p["batch_size"],
                self.n_classes, self.mean, self.std, self.model.block_size,
                self.device, p["bin_fill_holes"], self.mesh,
                spatial=p.get("eval_spatial", False))
            miou = iou.mean()
            t2 = time.time()
            print(
                "Epoch {}: took {:.3f}s, TRAIN clf loss={:.6f}, consistency "
                "loss={:.6f}, conf rate={:.3%}, VAL mIoU={:.3%}".format(
                    epoch_i + 1, t2 - t1, sup_loss_acc, cons_loss_acc,
                    conf_rate_acc, miou))
            print("-- {}".format(", ".join(f"{x:.3%}" for x in iou)))

            if self.is_lead:
                self.ctx.log_metrics({
                    "epoch": epoch_i + 1, "sup_loss": sup_loss_acc,
                    "cons_loss": cons_loss_acc, "conf_rate": conf_rate_acc,
                    "val_miou": float(miou), "epoch_time": t2 - t1,
                    "images_per_sec": p["iters_per_epoch"] * self.global_batch
                    / max(t2 - t1, 1e-9),
                    "train_time": t_train, "eval_time": t2 - t1 - t_train,
                    **self.step_counters(), **batchnorm.counters(),
                })
            stop = self._preempted
            if not self._solo:  # any rank's signal stops every rank here
                stop = bool(mesh_mod.host_sum([float(stop)])[0] > 0)
            ci = max(1, int(p.get("checkpoint_interval", 1)))
            last = epoch_i + 1 == p["num_epochs"]
            if self.is_lead and ((epoch_i + 1) % ci == 0 or last or stop):
                # host copy now; serialise + write overlap the next epoch.
                # A stop makes this epoch the resume point, so it saves
                # even where the interval would skip it.
                ckpt.save_checkpoint_async(
                    self.ctx.checkpoint_dir, self.state, self.state.step)
            if stop and not last:
                print("PREEMPTED: stopping after epoch "
                      f"{epoch_i + 1}; rerun with --resume", flush=True)
                return

        self.finalise()

    # ---- final artifacts ----
    def finalise(self):
        p = self.p
        if p["save_model"] and self.is_lead:
            ckpt.export_params(os.path.join(self.ctx.run_dir, "model.pt"), self.eval_net())

        if p["save_preds"] or self.test_ndx is not None:
            out_dir = (os.path.join(self.ctx.run_dir, "preds")
                       if p["save_preds"] and self.is_lead else None)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)

            # --eval_spatial holds for the test eval and the predictions too
            mesh, split_h = common.eval_layout(self.mesh, p.get("eval_spatial", False))

            def predict_over(indices, evaluator=None):
                # every rank predicts its part of each batch (its data
                # index's images, under --eval_spatial its rows of them);
                # the parts are gathered, so every rank scores the whole
                # batch and rank 0 writes the predictions of a one-process run
                for batch in common.eval_batches_over(self.ds, indices, p["batch_size"],
                                                      self.model.block_size, mesh, split_h):
                    pred = common.predict_batch(self.eval_net(), batch, self.mean, self.std,
                                                self.device, mesh, split_h)
                    pred, y = pred.cpu().numpy(), batch["labels"].astype(np.int64)
                    for k in range(batch["count"]):
                        i = int(batch["indices"][k])
                        h, w = batch["sizes"][k]
                        if out_dir:
                            self.ds.save_prediction_by_index(out_dir, pred[k, :h, :w], i)
                        if evaluator is not None:
                            evaluator.update_batch(pred[k: k + 1, :h, :w],
                                                   y[k: k + 1, :h, :w])

            if p["save_preds"]:
                predict_over(self.val_ndx)
            if self.test_ndx is not None:
                test_ev = EvaluatorIoU(self.n_classes, p["bin_fill_holes"])
                predict_over(self.test_ndx, test_ev)
                test_iou = test_ev.score()
                print("FINAL TEST: mIoU={:.3%}".format(test_iou.mean()))
                print("-- TEST {}".format(", ".join(f"{x:.3%}" for x in test_iou)))

        self.close_streams()


# ---- unsupervised batch composers ----
#
# Each algorithm is a (fetch, compose) pair: ``fetch`` runs on the host each
# iteration and returns raw loader batches (each a dict of numpy arrays, as
# ``make_raw_batch`` copies them); ``compose`` augments them on the device.

def fetch_two_streams(engine: TrainEngine, streams):
    """mask_mt mix: one batch from each of the two unsup streams."""
    return {"u0": next(streams[0]), "u1": next(streams[1])}


def fetch_one_stream(engine: TrainEngine, streams):
    """mask_mt zero and VAT: a single unsup batch."""
    return {"u": next(streams[0])}


def fetch_ict(engine: TrainEngine, streams):
    """ICT: two draws from ONE stream (reference: train_seg_semisup_ict.py:272-273)."""
    return {"u0": next(streams[0]), "u1": next(streams[0])}


def fetch_aug_pair(engine: TrainEngine, streams):
    """aug_mt: one pair-geometry batch. The relative transform xf0->1 =
    grid(m1 . inv(m0)) is composed on the host in float64 (reference:
    datapipe/seg_data.py:219-232) and rides in the pair's dict as
    ``xf_grid``."""
    host = next(streams[0])
    xf_cv = host_affine.compose(
        host["m1"].astype(np.float64),
        host_affine.invert(host["m0"].astype(np.float64)))
    xf_grid = host_affine.cv_to_grid(xf_cv, engine.crop_hw).astype(np.float32)
    return {"pair": dict(host, xf_grid=xf_grid)}


def compose_mask_pair(augmentor, raw, generator):
    """mask_mt mix and ICT: augment two unsup batches (colour pair each)."""
    u0 = augmentor.unsup(raw["u0"], generator)
    u1 = augmentor.unsup(raw["u1"], generator)
    return dict(ux0_tea=u0["image"], ux0_stu=u0["image_stu"], um0=u0["mask"],
                ux1_tea=u1["image"], ux1_stu=u1["image_stu"], um1=u1["mask"])


def compose_mask_single(augmentor, raw, generator):
    """mask_mt zero (Cutout) and VAT: one augmented unsup batch."""
    u = augmentor.unsup(raw["u"], generator)
    return dict(ux_tea=u["image"], ux_stu=u["image_stu"], um=u["mask"])


def compose_aug_pair(augmentor, raw, generator):
    """aug_mt: the two crops of each image. Element 0 (the teacher's) has no
    colour jitter; element 1 (the student's) takes the jittered copy when
    colour jitter is on (reference: train_seg_semisup_aug_mt.py:150-158)."""
    host = raw["pair"]
    b0 = dict(host, m=host["m0"], interp=host["interp0"])
    b1 = dict(host, m=host["m1"], interp=host["interp1"])
    u0 = dataclasses.replace(augmentor, colour=None).unsup(b0, None)
    u1 = augmentor.unsup(b1, generator)
    return dict(ux0=u0["image"], ux1=u1["image_stu"], um0=u0["mask"],
                um1=u1["mask"], xf0_to_1=host["xf_grid"])
