"""The multi-seed trainer (train/multi_seed_mask_mt.py, parallel/multi_seed.py)
on the CPU: its click command against the JAX command; K seeds in turn
against each seed stepped alone (bit for bit) and against JAX's
``make_multi_seed_step`` on a 2-device mesh (within JAX's own 7e-4 on the
parameters: the vmap/shard_map reorders the convolutions' sums); the
trainer end to end for every --algorithm on test_torch_trainer's tiny VOC
tree, seed 0 bit-equal to the single-seed trainer, an exact --resume, the
JAX trainer's refusals, and world 2 (two gloo ranks) splitting the seeds
with the states of the world-1 run.
"""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cutmix_seg_tpu.core import job as jjob
from cutmix_seg_tpu.core import train_state as jts
from cutmix_seg_tpu.masks.box_mask import BoxMaskConfig as JBoxMaskConfig
from cutmix_seg_tpu.masks.box_mask import sample_box_rects as jax_sample_box_rects
from cutmix_seg_tpu.parallel.mesh import make_mesh
from cutmix_seg_tpu.parallel.multi_seed import make_multi_seed_step, stack_pytrees, unstack_state
from cutmix_seg_tpu.semisup import mask_mt as jmm
from cutmix_seg_tpu.train import multi_seed_mask_mt as jms
from cutmix_seg_tpu_torch.core import checkpoint, job
from cutmix_seg_tpu_torch.core import train_state as tts
from cutmix_seg_tpu_torch.masks.box_mask import BoxMaskConfig
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.parallel.multi_seed import owned_seeds, step_in_turn
from cutmix_seg_tpu_torch.parallel.mesh import Mesh
from cutmix_seg_tpu_torch.semisup import mask_mt as tmm
from cutmix_seg_tpu_torch.train import multi_seed_mask_mt as tms
from tests import _torch_ranks as ranks
from tests import test_torch_trainer as ttr
from tests.test_torch_ddp_trainer import state_equal as states_equal
from tests.test_torch_ddp_trainer import voc_tree  # noqa: F401
from tests.test_train_step import make_batch, tiny_model

torch.set_num_threads(1)

K = 2
SEEDS = "12345,23456"
LR = 3e-4


def test_cli_has_the_jax_options_and_defaults():
    assert ttr._options(tms.experiment) == ttr._options(jms.experiment)


def test_owned_seeds():
    assert owned_seeds(5, None) == [0, 1, 2, 3, 4]
    assert owned_seeds(5, Mesh(2, 0)) == [0, 2, 4] and owned_seeds(5, Mesh(2, 1)) == [1, 3]
    assert owned_seeds(1, Mesh(2, 1)) == []


# ---- the seeds' steps ----

def _jax_states():
    model = tiny_model()
    opt_cfg = jts.OptimizerConfig(opt_type="adam", learning_rate=LR)
    states, tx = [], None
    for k in range(K):
        s, tx = jts.create_train_state(model, opt_cfg, jax.random.PRNGKey(100 + k),
                                       input_hw=(33, 33), mean_teacher=True, pretrained=False)
        states.append(s)
    return model, states, tx


CFG = dict(mask_mode="mix", cons_weight=1.0, conf_thresh=0.0, freeze_bn=True,
           mean_teacher=True, teacher_alpha=0.9)


def _port_seed(jstate):
    model = ranks.MODELS["deeplab2"]()
    state, opt = tts.create_train_state(model, tts.OptimizerConfig(learning_rate=LR), 0,
                                        device="cpu", pretrained=False)
    sd = from_jax_variables({"params": jax.device_get(jstate.student.params),
                             "batch_stats": jax.device_get(jstate.student.batch_stats)})
    state.student.load_state_dict(sd)
    state.teacher.load_state_dict(sd)
    cfg = tmm.MaskConsistencyConfig(box=BoxMaskConfig((0.5, 0.5)), **CFG)
    return state, tmm.make_mask_mt_step(model, opt, cfg)


def _port_batch(jbatch):
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    tb["sup_y"] = tb["sup_y"].long()
    return tb


def test_in_turn_matches_jax_multi_seed_step():
    """One step of K = 2 seeds: the port's seeds in turn against JAX's
    multi-seed step over a 2-device mesh (one seed per device)."""
    model, jstates, tx = _jax_states()
    jcfg = jmm.MaskConsistencyConfig(box=JBoxMaskConfig((0.5, 0.5)), **CFG)
    batches = [make_batch(np.random.RandomState(10 + k), b=4) for k in range(K)]
    rects = [np.array(jax_sample_box_rects(jcfg.box, jax.random.split(s.rng, 5)[1], 4,
                                           (33, 33))) for s in jstates]
    seeds = {k: _port_seed(s) for k, s in enumerate(jstates)}
    mstep = make_multi_seed_step(jmm.make_mask_mt_step(model, tx, jcfg), make_mesh(K))
    mstate, jm = mstep(stack_pytrees(jstates), stack_pytrees(batches), jnp.float32(1.0))
    states = {k: s for k, (s, _) in seeds.items()}
    steps = {k: functools.partial(step, rects=torch.from_numpy(rects[k]))
             for k, (_, step) in seeds.items()}
    metrics = step_in_turn(steps, states, {k: _port_batch(b) for k, b in enumerate(batches)},
                           1.0)
    for k in range(K):
        assert abs(metrics[k]["sup_loss"].item() - float(jm["sup_loss"][k])) < 1e-4
        js = unstack_state(mstate, k).student
        want = from_jax_variables({"params": jax.device_get(js.params),
                                   "batch_stats": jax.device_get(js.batch_stats)})
        got = states[k].student.state_dict()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=7e-4, err_msg=name)
        assert states[k].step == 1
    w = [states[k].student.state_dict() for k in range(K)]
    assert not all(torch.allclose(w[0][n], w[1][n]) for n in w[0])  # the seeds differ


def test_seeds_in_turn_equal_each_seed_alone():
    """Two steps of two seeds in turn change no bit against each seed's
    steps run alone."""
    _, jstates, _ = _jax_states()
    batches = {k: _port_batch(make_batch(np.random.RandomState(20 + k), b=4))
               for k in range(K)}
    together = {k: _port_seed(s) for k, s in enumerate(jstates)}
    states = {k: s for k, (s, _) in together.items()}
    for _ in range(2):
        step_in_turn({k: st for k, (_, st) in together.items()}, states, batches, 1.0)
    for k, js in enumerate(jstates):
        state, step = _port_seed(js)
        for _ in range(2):
            state, _ = step(state, batches[k], 1.0)
        assert states_equal(checkpoint.state_to_host(state),
                           checkpoint.state_to_host(states[k]))


# ---- the trainer ----

def _params(**overrides):
    """test_torch_trainer's tiny Pascal recipe through the multi-seed
    command, two seeds."""
    p = dict(tms.experiment.make_context("experiment", []).params)
    del p["job_desc"]
    base = ttr._params()
    p.update({k: base[k] for k in base if k in p})
    # checkpoints at the end only: a tiny DeepLab v2's state is 146 MB
    p.update(parallel_split_seeds=SEEDS, num_epochs=2, iters_per_epoch=2, device="cpu",
             checkpoint_interval=2)
    p.update(overrides)
    return p


def _submit(root, desc, **overrides):
    return job.submit("test_torch_mseed", desc, tms.train_seg_semisup_mask_mt_multiseed,
                      _params(**overrides), results_root=str(root))


def _ckpt(root, desc, k, step):
    return torch.load(os.path.join(root, "test_torch_mseed", desc, "checkpoints", f"seed_{k}",
                                   f"ckpt_{step:09d}.pt"), weights_only=True)


@pytest.fixture(scope="module")
def straight(voc_tree):  # noqa: F811
    """Two seeds, two epochs at world 1: (results root, states)."""
    root = voc_tree / "mseed_results"
    yield root, _submit(root, "straight")
    shutil.rmtree(root)


@pytest.mark.parametrize("algorithm", ["aug_mt", "ict", "mask_mt", "vat_mt"])
def test_trainer_end_to_end(voc_tree, tmp_path, algorithm):  # noqa: F811
    kw = dict(num_epochs=1, algorithm=algorithm)
    if algorithm == "vat_mt":
        kw.update(adaptive_vat_radius=True, vat_radius=1.0, cons_weight=0.1)
    states = _submit(tmp_path, "run", **kw)
    run_dir = tmp_path / "test_torch_mseed" / "run"
    log = (run_dir / "log_run.txt").read_text()
    for s in SEEDS.split(","):
        line = next(ln for ln in log.splitlines() if ln.startswith(f"Epoch 1 [seed {s}]:"))
        assert "VAL mIoU=" in line and "nan" not in line.lower()
    assert f"SEEDS AGGREGATE ({SEEDS}): VAL mIoU mean=" in log and "n=2" in log
    recs = [json.loads(ln) for ln in (run_dir / "metrics_run.jsonl").read_text().splitlines()]
    assert [(r["epoch"], r["seed"]) for r in recs[:2]] == [(1, 12345), (1, 23456)]
    final = recs[2]
    assert len(final["final_seed_mious"]) == 2
    assert final["final_miou_mean"] == pytest.approx(np.mean(final["final_seed_mious"]))
    assert final["final_miou_std"] == pytest.approx(np.std(final["final_seed_mious"], ddof=1))
    for k in range(K):
        assert os.listdir(run_dir / "checkpoints" / f"seed_{k}") == ["ckpt_000000002.pt"]
        assert states[k].step == 2
    shutil.rmtree(run_dir / "checkpoints")


def test_seed0_is_the_single_seed_trainer(straight, voc_tree):  # noqa: F811
    """Seed 0 takes the single-seed trainer's draws with its split seed:
    the same checkpoint, bit for bit; seed 1 is another run."""
    root, _ = straight
    single = voc_tree / "single_results"
    ttr._submit(single, "seed0", num_epochs=2, iters_per_epoch=2, split_seed=12345,
                data_on_device="off", save_model=False, checkpoint_interval=2)
    want = torch.load(single / "test_torch_mask_mt" / "seed0" / "checkpoints"
                      / "ckpt_000000004.pt", weights_only=True)
    got = _ckpt(root, "straight", 0, 4)
    assert states_equal(got, want)
    assert not states_equal(_ckpt(root, "straight", 1, 4)["student"], want["student"])
    shutil.rmtree(single)


def test_resume_is_exact(straight, tmp_path):
    root, _ = straight
    _submit(tmp_path, "split", num_epochs=1)
    _submit(tmp_path, "split", resume=True)
    log = (tmp_path / "test_torch_mseed" / "split" / "log_split.txt").read_text()
    assert "Resumed at epoch 1" in log and "Epoch 1 [seed" in log.split("Resumed")[0]
    for k in range(K):
        assert states_equal(_ckpt(tmp_path, "split", k, 4), _ckpt(root, "straight", k, 4))
    shutil.rmtree(tmp_path / "test_torch_mseed")


@pytest.mark.parametrize("flag", ["grad_accum", "spatial_train"])
def test_refusals_match_jax(flag, tmp_path):
    errors = []
    for fn, ctx_cls in ((jms.train_seg_semisup_mask_mt_multiseed, jjob.RunContext),
                        (tms.train_seg_semisup_mask_mt_multiseed, job.RunContext)):
        with pytest.raises(ValueError, match="not supported by the multi-seed trainer") as e:
            fn(ctx_cls(str(tmp_path), "guard"), **{flag: 2})
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_n_devices_must_match_the_world(voc_tree, tmp_path):  # noqa: F811
    with pytest.raises(ValueError, match="--n_devices 2 does not match"):
        _submit(tmp_path, "ndev", n_devices=2)


def test_world2_splits_the_seeds(straight, voc_tree):  # noqa: F811
    """Two ranks, two seeds: rank r trains seed r alone, and each seed ends
    in the world-1 run's state; only rank 0 writes the log and metrics,
    and each seed's owner its checkpoints."""
    root, states1 = straight
    w2 = voc_tree / "mseed_world2"
    out = ranks.run_ranks(voc_tree, {"kind": "multiseed", "arch": ttr.TINY_ARCH,
                                     "params": _params(), "root": str(w2), "desc": "w2"}, 2)
    for r, o in enumerate(out):
        assert sorted(o["digests"]) == [r]
        assert o["digests"][r] == ranks.digest(checkpoint.state_to_host(states1[r]))
        assert o["writes"]["save_checkpoint"] == 1  # its seed's, at the end
    assert out[1]["writes"]["log_metrics"] == 0 and out[0]["writes"]["log_metrics"] == 2 * K + 1
    for k in range(K):
        assert states_equal(_ckpt(w2, "w2", k, 4), _ckpt(root, "straight", k, 4))
    log = (w2 / "test_torch_mseed" / "w2" / "log_w2.txt").read_text()
    want = (root / "test_torch_mseed" / "straight" / "log_straight.txt").read_text()
    agg = [ln.split(": ", 1)[1] for ln in log.splitlines() if ln.startswith("SEEDS AGGREGATE")]
    assert agg and agg == [ln.split(": ", 1)[1] for ln in want.splitlines()
                           if ln.startswith("SEEDS AGGREGATE")]
    shutil.rmtree(w2)
