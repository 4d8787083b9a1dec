"""The port's tools/multi_seed_convergence.py against the JAX tool on the CPU
(the Cutout, ICT, VAT and aug_mt arms are in test_torch_convergence_arms.py).

A module fixture runs the JAX tool's ``main`` at a tiny size with its
``make_arm_runner`` replaced by a recorder: each arm's configuration, step
factory, stacked initial state, seed-stacked data, index streams, pair
geometry and ramps, exactly as the JAX tool builds them, with no training.

* The port's data generators, per-seed data, index streams, aug_mt pair
  geometry and ramps equal the recorded ones bit for bit.
* Each arm (and the CutMix arm with ``--strong_colour``) runs 4 iterations
  of 2 seeds at batch 2, 32x32, through ``jax.jit`` of the real JAX
  ``make_arm_runner`` (seeds vmapped, iterations scanned) and through the
  port's seeds-in-turn loop, from the same weights (carried across with
  ``from_jax_variables``), with the confidence gate at 0 so that every
  arm's consistency loss moves its student from the second iteration on
  (at the tool's 0.8 the untrained teacher's gate stays shut and every arm
  trains as the supervised one). The step's draws are replayed from each seed's
  JAX key chain (each step splits its key in 5; the draw key is the second,
  the next state's key the first) and injected: CutMix / Cutout rects, ICT
  lambdas, VAT noise, and the student views' colour draws from
  ``fold_in(PRNGKey(97), ck + salt)``.
  Tolerances: every iteration's sup loss within rtol 1e-4 (float32 sums in
  another order; the Adam sign effect below on later iterations); student
  and teacher parameters within 2 * lr * iterations everywhere (Adam moves
  an element whose gradient is at rounding noise by up to lr per step, in
  either direction) and all but 0.1% of them within 1e-6 + 1e-5 relative.
* The CLI end to end on the CPU writes the JAX tool's keys.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from cutmix_seg_tpu.masks.box_mask import sample_box_rects as jax_sample_box_rects
from cutmix_seg_tpu.ops.colour import ColourJitterConfig as JColourJitterConfig
from cutmix_seg_tpu.semisup import vat as jvat
from cutmix_seg_tpu.tools import multi_seed_convergence as jconv
from cutmix_seg_tpu.utils import compile_cache
from cutmix_seg_tpu_torch.core.schedules import make_lr_schedule
from cutmix_seg_tpu_torch.core.train_state import OptimizerConfig
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.tools import multi_seed_convergence as tconv
from tests.test_torch_aug import jax_colour_params

torch.set_num_threads(1)

ITERS, N_SEEDS, BATCH, HW_SIZE, N_SUP, N_UNSUP, N_VAL = 4, 2, 2, 32, 2, 6, 4
LR = 1e-3  # the tool's Adam rate
LOSS_RTOL = 1e-4
CONF_THRESH = 0.0
TINY_ARGS = ["--iters", str(ITERS), "--n_seeds", str(N_SEEDS), "--n_sup", str(N_SUP),
             "--n_unsup", str(N_UNSUP), "--n_val", str(N_VAL), "--batch", str(BATCH),
             "--hw", str(HW_SIZE), "--conf_thresh", str(CONF_THRESH)]
JAX_ONLY_FIELDS = {"pallas_cutmix"}  # the port has no such switch


def _record_jax_main(args, out):
    """Run the JAX tool's main with a recording runner; returns
    ({arm: record}, results document)."""
    records = []

    def recording_runner(model, tx, cfg, make_step, algorithm, n_sup, n_unsup, batch,
                         strong_colour=False):
        rec = dict(model=model, tx=tx, cfg=cfg, make_step=make_step, algorithm=algorithm,
                   n_sup=n_sup, n_unsup=n_unsup, batch=batch, strong_colour=strong_colour)
        records.append(rec)

        def run(state, data, xs, ramps):
            rec.setdefault("state", state)
            rec.setdefault("data", data)
            rec.setdefault("stream", {})
            for k, v in xs.items():
                rec["stream"][k] = np.concatenate(
                    [rec["stream"][k], np.asarray(v)]) if k in rec["stream"] else np.asarray(v)
            rec["ramps"] = np.concatenate([rec.get("ramps", np.zeros(0, np.float32)),
                                           np.asarray(ramps)])
            return state, jnp.zeros((len(ramps), N_SEEDS), jnp.float32)

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconv, "make_arm_runner", recording_runner)
        mp.setattr(jconv, "HW", jconv.HW)
        mp.setattr(jconv, "TASK", jconv.TASK)
        mp.setattr(compile_cache, "enable_persistent_compilation_cache", lambda *a: None)
        jconv.main.main(args + ["--out", out], standalone_mode=False)
    with open(os.path.join(out, "results.json")) as f:
        doc = json.load(f)
    arms = ["supervised"] + [a for a in doc["arms"] if a != "supervised"]
    assert len(arms) == len(records)
    return dict(zip(arms, records)), doc


def record_sweep(tmp_path_factory, algorithms, colour):
    """The JAX tool's records of ``algorithms`` (and of the CutMix arm with
    --strong_colour when ``colour``)."""
    out = tmp_path_factory.mktemp("jax_sweep")
    plain, doc = _record_jax_main(TINY_ARGS + ["--algorithms", algorithms], str(out / "plain"))
    sweep = {"arms": plain, "doc": doc}
    if colour:
        rec, _ = _record_jax_main(TINY_ARGS + ["--strong_colour", "--algorithms", "mask_mt"],
                                  str(out / "colour"))
        sweep["colour"] = rec["mask_mt"]
    return sweep


@pytest.fixture(scope="module")
def jax_sweep(tmp_path_factory):
    return record_sweep(tmp_path_factory, ",".join(tconv.ARMS[1:]), colour=True)


@pytest.mark.parametrize("task", ["shapes", "large_shapes", "context_size"])
@pytest.mark.parametrize("aug_src", [False, True])
def test_seed_data_bit_equal_to_jax(task, aug_src, monkeypatch):
    monkeypatch.setattr(jconv, "HW", (HW_SIZE, HW_SIZE))
    monkeypatch.setattr(jconv, "TASK", task)
    for seed in (0, 3):
        want = jconv.build_seed_data(seed, N_SUP, N_UNSUP, N_VAL, aug_src)
        got = tconv.build_seed_data(seed, N_SUP, N_UNSUP, N_VAL, aug_src,
                                    hw=(HW_SIZE, HW_SIZE), task=task)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("gen", ["make_image_large", "make_image_context"])
@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_generators_bit_equal_to_jax(gen, hw):
    r_t, r_j = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(4):
        (ti, tl), (ji, jl) = getattr(tconv, gen)(r_t, hw), getattr(jconv, gen)(r_j, hw)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_streams_geometry_ramps_bit_equal_to_jax(jax_sweep):
    seeds = list(range(N_SEEDS))
    want_streams = tconv.index_streams(ITERS, BATCH, seeds, N_SUP, N_UNSUP)
    geom = tconv._aug_geometry(ITERS, BATCH, seeds, (HW_SIZE, HW_SIZE))
    ramps = np.minimum(1.0, np.arange(ITERS) / (ITERS * 0.3)).astype(np.float32)
    for arm, rec in jax_sweep["arms"].items():
        for name, arr in want_streams.items():
            assert rec["stream"][name].dtype == arr.dtype
            np.testing.assert_array_equal(rec["stream"][name], arr, err_msg=(arm, name))
        if arm == "aug_mt":
            for name, arr in zip(("m0", "m1", "xf"), geom):
                assert rec["stream"][name].dtype == arr.dtype
                np.testing.assert_array_equal(rec["stream"][name], arr, err_msg=name)
        else:
            assert set(rec["stream"]) == set(want_streams)
        np.testing.assert_array_equal(rec["ramps"], ramps)
        # the seed-stacked data are the port's per-seed data
        for k, s in enumerate(seeds):
            d = tconv.build_seed_data(s, N_SUP, N_UNSUP, N_VAL, rec["algorithm"] == "aug_mt",
                                      hw=(HW_SIZE, HW_SIZE))
            for name in ("sup_x", "sup_y", "unsup_x"):
                np.testing.assert_array_equal(np.asarray(rec["data"][name][k]), d[name])
    assert "ck" in jax_sweep["colour"]["stream"]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in JAX_ONLY_FIELDS}


def test_arm_configs_equal_to_jax(jax_sweep):
    port = tconv.arm_configs(CONF_THRESH)
    assert set(port) == set(tconv.ARMS) == set(jax_sweep["arms"])
    for arm, rec in jax_sweep["arms"].items():
        cfg, _, algorithm = port[arm]
        assert algorithm == rec["algorithm"], arm
        want = _fields(rec["cfg"])
        got = _fields(cfg)
        if "box" in want:
            want["box"], got["box"] = _fields(want["box"]), _fields(got["box"])
        assert got == want, arm


def _seed_variables(tree, k):
    return jax.tree_util.tree_map(lambda a: np.asarray(a[k]), jax.device_get(tree))


def _key_chain(rng, iters):
    """Each step's draw key: split(key, 5)[1]; the next key: split(key, 5)[0]."""
    keys = []
    for _ in range(iters):
        parts = jax.random.split(rng, 5)
        keys.append(parts[1])
        rng = parts[0]
    return keys


def _draws(rec, arm):
    """draws(t, k) for the port's runner, replayed from the JAX key chains."""
    state, cfg, hw = rec["state"], rec["cfg"], (HW_SIZE, HW_SIZE)
    chains = [_key_chain(state.rng[k], ITERS) for k in range(N_SEEDS)]
    table = {}
    for k in range(N_SEEDS):
        for t in range(ITERS):
            key, d = chains[k][t], {}
            if arm in ("mask_mt", "cutout"):
                d["rects"] = torch.from_numpy(np.array(
                    jax_sample_box_rects(cfg.box, key, BATCH, hw)))
            elif arm == "ict":
                d["lam"] = torch.from_numpy(np.array(jax.random.beta(
                    key, cfg.ict_alpha, cfg.ict_alpha, shape=(BATCH, 1, 1, 1)), np.float32))
            elif arm == "vat_mt":
                noise = jax.random.normal(key, (BATCH,) + hw + (3,), jnp.float32)
                d["eps0"] = torch.from_numpy(np.array(jvat._normalize_per_sample(noise) * (
                    1.0e-6 * hw[0] * hw[1] / 1000.0)))
            if rec["strong_colour"]:
                ck = int(rec["stream"]["ck"][t, k, 0])
                d["colour"] = [jax_colour_params(
                    jax.random.fold_in(jax.random.PRNGKey(97), ck + salt), BATCH,
                    JColourJitterConfig()) for salt in (0, 1)]
            table[t, k] = d
    return lambda t, k: table[t, k]


def _close_params(port_module, jax_model_state, what):
    want = from_jax_variables({"params": jax_model_state["params"],
                               "batch_stats": jax_model_state["batch_stats"]})
    got = port_module.state_dict()
    assert set(got) == set(want)
    n_tight = n_all = 0
    for name, w in want.items():
        d = (got[name] - w).abs()
        assert d.max().item() <= 2 * LR * ITERS + 1e-6, (what, name, d.max().item())
        n_tight += int((d <= 1e-6 + 1e-5 * w.abs()).sum())
        n_all += d.numel()
    assert n_tight >= 0.999 * n_all, (what, n_all - n_tight, n_all)


def check_arm(arm, jax_sweep, monkeypatch):
    """One arm through the JAX runner and the port's loop, held as the
    module docstring says."""
    rec = jax_sweep["colour"] if arm == "mask_mt_strong_colour" else jax_sweep["arms"][arm]
    arm = arm.replace("_strong_colour", "")
    monkeypatch.setattr(jconv, "HW", (HW_SIZE, HW_SIZE))
    jrun = jconv.make_arm_runner(rec["model"], rec["tx"], rec["cfg"], rec["make_step"],
                                 rec["algorithm"], N_SUP, N_UNSUP, BATCH,
                                 strong_colour=rec["strong_colour"])
    state0 = rec["state"]
    stream = {k: jnp.asarray(v) for k, v in rec["stream"].items()}
    jstate, jlosses = jrun(jax.tree_util.tree_map(jnp.copy, state0), rec["data"], stream,
                           jnp.asarray(rec["ramps"]))
    jlosses = np.asarray(jlosses)

    # the port, from JAX's initial weights
    opt_cfg = OptimizerConfig(opt_type="adam", learning_rate=LR,
                              lr_schedule=make_lr_schedule("none", LR, ITERS))
    states, models = tconv.init_states(list(range(N_SEEDS)), opt_cfg, "cpu")
    for k, st in states.items():
        for net, tree in ((st.student, state0.student), (st.teacher, state0.teacher)):
            net.load_state_dict(from_jax_variables(
                {"params": _seed_variables(tree.params, k),
                 "batch_stats": _seed_variables(tree.batch_stats, k)}))
    cfg, make_step, algorithm = tconv.arm_configs(CONF_THRESH)[arm]
    seen = []

    def recording_step(model, opt, cfg):
        step = make_step(model, opt, cfg)

        def rec_step(*args, **kw):
            state, metrics = step(*args, **kw)
            seen.append(metrics)
            return state, metrics

        return rec_step

    run = tconv.make_arm_runner(cfg, recording_step, algorithm, models, BATCH,
                                hw=(HW_SIZE, HW_SIZE), strong_colour=rec["strong_colour"])
    data = {k: {"sup_x": torch.from_numpy(np.array(rec["data"]["sup_x"][k])),
                "sup_y": torch.from_numpy(np.array(rec["data"]["sup_y"][k])).long(),
                "unsup_x": torch.from_numpy(np.array(rec["data"]["unsup_x"][k]))}
            for k in range(N_SEEDS)}
    tstream = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
               for k, v in rec["stream"].items()}
    losses = run(states, data, tstream, rec["ramps"], draws=_draws(rec, arm))

    assert losses.shape == jlosses.shape == (ITERS, N_SEEDS)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=1e-7)
    # the iterations moved the loss, and every consistency arm's loss was on
    assert not np.allclose(jlosses[0], jlosses[-1])
    assert len(seen) == ITERS * N_SEEDS
    if cfg.cons_weight > 0:
        assert all(m["conf_rate"].item() == 1.0 for m in seen)
        # an untrained net's near-uniform logits can give VAT a zero first loss
        assert all(m["cons_loss"].item() > 0 for m in seen[N_SEEDS:]), arm
    for k, st in states.items():
        assert st.step == ITERS
        for net, tree, what in ((st.student, jstate.student, "student"),
                                (st.teacher, jstate.teacher, "teacher")):
            _close_params(net, {"params": _seed_variables(tree.params, k),
                                "batch_stats": _seed_variables(tree.batch_stats, k)},
                          f"{arm} seed {k} {what}")


@pytest.mark.parametrize("arm", ["supervised", "mask_mt", "mask_mt_strong_colour"])
def test_arm_matches_jax_runner(arm, jax_sweep, monkeypatch):
    check_arm(arm, jax_sweep, monkeypatch)


def _key_tree(doc):
    return {k: (sorted((arm, sorted(v)) for arm, v in doc[k].items()) if k == "arms" else None)
            for k in doc}


def test_cli_writes_the_jax_keys(jax_sweep, tmp_path):
    """Two iterations (the keys do not depend on the count)."""
    res = CliRunner().invoke(tconv.main, TINY_ARGS + ["--iters", "2", "--out", str(tmp_path),
                                                      "--device", "cpu"])
    assert res.exit_code == 0, res.output
    doc = json.loads(res.output.strip().splitlines()[-1])
    with open(tmp_path / "results.json") as f:
        assert json.load(f) == doc
    with open(tmp_path / "results_partial.json") as f:
        partial = json.load(f)
    assert set(partial) == {"arms", "n_seeds", "iters"} and set(partial["arms"]) == set(doc["arms"])
    assert _key_tree(doc) == _key_tree(jax_sweep["doc"])
    assert doc["device"] == "cpu" and doc["iters"] == 2
    for k in ("task", "n_seeds", "n_sup", "configs"):
        assert doc[k] == jax_sweep["doc"][k], k
    for arm in tconv.ARMS:
        mious = doc["arms"][arm]["miou_per_seed"]
        assert len(mious) == N_SEEDS and all(0.0 <= m <= 1.0 for m in mious)
        assert np.isfinite(doc["arms"][arm]["final_sup_loss_mean"])
