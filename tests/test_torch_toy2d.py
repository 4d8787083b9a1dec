"""The port's toy-2D subsystem (cutmix_seg_tpu_torch.toy2d) against the JAX
package's on the CPU: the data copy (spiral, image, cross-hatch, the
supervised-set file, renders) array for array; ToyMLP per norm layer, eval
and train mode, against flax on the same variables (``from_jax_variables(v,
'toy2d')``; f32, rtol 1e-5 / atol 1e-6, the statistics a train-mode forward
stores too); the distance-map sampler and the gradient probe; the fused step
of each model variant over 3 steps against ``jax.jit`` of
``Toy2DAlgo._train_step``; and the CLI.

Draws: the perturbation noise is replayed from the JAX step's key split
(``split(key, 5)[1]``) and given to the port's step (``noise=``); dropout
masks by call order: flax's ``nn.Dropout.__call__`` is patched inside the
test to take mask k of a step from a bank, and the same masks go to the
port's step (``drop_masks=``). The JAX step is jitted anew for each step, so
each step traces, and draws, its own masks.

Step tolerances, as test_torch_algorithms.py: losses rtol 1e-5; parameters
and statistics of student and teacher within Adam's 2 * lr * steps, and all
but 1% of the elements within 1e-6 + 1e-5 relative (Adam turns a gradient
that differs at rounding level into an update that differs by up to lr).
Under batch_norm a Dense bias feeds a BatchNorm, which removes it: its true
gradient is 0, so both sides' gradients are rounding noise that Adam scales
to steps of lr, and the running mean carries that bias. Those two tensors
are held to Adam's bound alone.
"""

import copy
import re
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from click.testing import CliRunner
from flax import linen as fnn
from flax.core.frozen_dict import unfreeze
from flax.linen.module import merge_param
from jax import lax

from cutmix_seg_tpu.core.train_state import ModelState
from cutmix_seg_tpu.toy2d import data as jdata
from cutmix_seg_tpu.toy2d import model as jmodel
from cutmix_seg_tpu.toy2d import train as jtrain
from cutmix_seg_tpu_torch.core.train_state import Optimizer, OptimizerConfig
from cutmix_seg_tpu_torch.models.weights import from_jax_variables
from cutmix_seg_tpu_torch.toy2d import data as tdata
from cutmix_seg_tpu_torch.toy2d import model as tmodel
from cutmix_seg_tpu_torch.toy2d import train as ttrain

torch.set_num_threads(1)

NORMS = tmodel.NORMS
CURVE = "data/toy2d/curve_mask_v3.png"
CURVE_SUP = "data/toy2d/curve_mask_v3_35.pkl"


# ---- the data copy ----

def _ds_arrays(ds):
    out = {k: getattr(ds, k) for k in ("X", "y", "sup_X", "sup_y", "unsup_X", "unsup_y",
                                        "sup_X_img", "dens_img", "px_grid_vis", "img_scale")}
    for k in ("image", "image_edges"):
        if getattr(ds, k, None) is not None:
            out[k] = getattr(ds, k)
    return out


DATASETS = {
    "spiral": lambda m, rng: m.spiral_classification_dataset(10, False, rng, N=400),
    "spiral_balanced": lambda m, rng: m.spiral_classification_dataset(10, True, rng, N=400),
    "image": lambda m, rng: m.classification_dataset_from_image(CURVE, 35, 2.0, 10, True, rng),
    "image_no_erosion": lambda m, rng: m.classification_dataset_from_image(CURVE, 0, 2.0, 10,
                                                                           True, rng),
    # the recipe lines' split: unbalanced (scikit-learn's stratified split in JAX)
    "image_recipe": lambda m, rng: m.classification_dataset_from_image(CURVE, 35, 2.0, 10,
                                                                       False, rng),
    "crosshatch": lambda m, rng: m.crosshatch_classification_dataset(rng, 4, 8),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_data_copy_matches_jax(name):
    a = DATASETS[name](jdata, np.random.RandomState(0))
    b = DATASETS[name](tdata, np.random.RandomState(0))
    want, got = _ds_arrays(a), _ds_arrays(b)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pred = np.random.RandomState(1).uniform(size=a.img_size)
    np.testing.assert_array_equal(b.semisup_image_plot(pred, pred),
                                  a.semisup_image_plot(pred, pred))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stratified_split_matches_sklearn(seed):
    """The NumPy copy draws what scikit-learn's StratifiedShuffleSplit draws,
    and leaves the RandomState where it leaves it."""
    from sklearn.model_selection import StratifiedShuffleSplit

    r = np.random.RandomState(seed)
    y = r.randint(0, 2 + seed % 2, 500 + 300 * seed)
    a, b = np.random.RandomState(seed + 10), np.random.RandomState(seed + 10)
    want = next(StratifiedShuffleSplit(n_splits=1, test_size=10 + seed, random_state=a)
                .split(y, y))
    got = tdata._stratified_shuffle_split(y, 10 + seed, b)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert a.randint(0, 2 ** 31) == b.randint(0, 2 ** 31)


def test_data_needs_no_sklearn(monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)  # any import of it fails
    ds = tdata.spiral_classification_dataset(10, False, np.random.RandomState(0), N=100)
    assert len(ds.sup_X) == 10


def test_load_supervised_matches_jax(tmp_path):
    a = DATASETS["image"](jdata, np.random.RandomState(0))
    b = DATASETS["image"](tdata, np.random.RandomState(0))
    a.load_supervised(CURVE_SUP)
    b.load_supervised(CURVE_SUP)
    for k in ("sup_X", "sup_y", "sup_X_img"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    tdata.save_supervised_split(str(tmp_path / "t.pkl"), b)
    jdata.save_supervised_split(str(tmp_path / "j.pkl"), a)
    assert (tmp_path / "t.pkl").read_bytes() == (tmp_path / "j.pkl").read_bytes()


# ---- the MLP ----

class MaskBank:
    """Dropout keep masks by call order, from seed + k; ``drawn`` keeps this
    step's."""

    def __init__(self, seed=300):
        self.seed, self.k, self.drawn = seed, 0, []

    def next(self, shape, keep_prob):
        mask = np.random.RandomState(self.seed + self.k).rand(*shape) < keep_prob
        self.k += 1
        self.drawn.append(mask)
        return mask

    def take(self):
        drawn, self.drawn = self.drawn, []
        return [torch.from_numpy(m) for m in drawn]


def patch_flax_dropout(monkeypatch, bank):
    def flax_call(self, inputs, deterministic=None, rng=None):
        if merge_param("deterministic", self.deterministic, deterministic) or self.rate == 0:
            return inputs
        keep_prob = 1.0 - self.rate
        mask = jnp.asarray(bank.next(inputs.shape, keep_prob))
        return lax.select(mask, inputs / keep_prob, jnp.zeros_like(inputs))

    monkeypatch.setattr(fnn.Dropout, "__call__", flax_call)


def _init(norm, hidden=16, n_hidden=2, seed=0, act="relu", randomise=True):
    """The flax MLP's variables (numpy), with the norms' scales, biases and
    running statistics drawn at random where ``randomise``."""
    net = jmodel.ToyMLP(n_hidden=n_hidden, hidden_size=hidden, hidden_act=act,
                        norm_layer=norm)
    variables = unfreeze(jax.device_get(
        net.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, 2)), train=False)))
    if randomise:
        rng = np.random.RandomState(seed + 1)
        for coll, tree in variables.items():
            for mod, leaves in tree.items():
                for name, v in leaves.items():
                    if name.endswith("scale") or name == "var":
                        leaves[name] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                    elif name in ("mean", "bias"):
                        leaves[name] = rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
    return net, variables


def _port(variables, norm, hidden=16, n_hidden=2, act="relu"):
    net = tmodel.ToyMLP(n_hidden=n_hidden, hidden_size=hidden, hidden_act=act,
                        norm_layer=norm)
    net.load_state_dict(from_jax_variables(variables, "toy2d"), strict=True)
    return net


def _assert_state_close(net, variables, rtol=1e-5, atol=1e-6):
    want = from_jax_variables(variables, "toy2d")
    got = net.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm", NORMS)
def test_toymlp_matches_flax(norm, train, monkeypatch):
    bank = MaskBank()
    patch_flax_dropout(monkeypatch, bank)
    act = "lrelu" if norm in ("group_norm", "spectral_norm") else "relu"
    jnet, variables = _init(norm, act=act)
    x = np.random.RandomState(2).uniform(-1, 1, (8, 2)).astype(np.float32)
    if train and "batch_stats" in variables:
        ref, upd = jnet.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        variables = dict(variables, batch_stats=unfreeze(jax.device_get(upd["batch_stats"])))
    else:
        ref = jnet.apply(variables, jnp.asarray(x), train=train)
    keep = bank.take()
    assert len(keep) == int(train)
    tnet = _port(_init(norm, act=act)[1], norm, act=act)
    tnet.train(train)
    with torch.no_grad():
        out = tnet(torch.from_numpy(x), keep=keep[0] if keep else None)
    assert np.abs(np.asarray(ref)).max() > 0.1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    _assert_state_close(tnet, variables)  # the statistics a train forward stores


def test_toy2d_layout_names():
    _, variables = _init("spectral_norm", randomise=False)
    sd = from_jax_variables(variables, "toy2d")
    assert {"dense0.weight", "dense0.u", "dense0.sigma", "final.weight"} <= set(sd)
    assert sd["dense0.weight"].shape == (16, 2) and sd["dense0.u"].shape == (1, 16)
    _, variables = _init("weight_norm", randomise=False)
    assert torch.equal(from_jax_variables(variables, "toy2d")["dense1.scale"], torch.ones(16))


def test_sample_dist_map_matches_jax():
    rng = np.random.RandomState(3)
    dist_map = rng.randn(24, 40).astype(np.float32) * 5
    pts = rng.uniform(-1.2, 1.2, (500, 2)).astype(np.float32)  # some fall outside
    ref = np.asarray(jtrain._sample_dist_map(jnp.asarray(dist_map), jnp.asarray(pts)))
    out = ttrain._sample_dist_map(torch.from_numpy(dist_map), torch.from_numpy(pts))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    # and torch's grid_sample, whose semantics the function has
    grid = torch.from_numpy(pts[:, ::-1].copy())[None, :, None, :]
    gs = torch.nn.functional.grid_sample(torch.from_numpy(dist_map)[None, None], grid,
                                         align_corners=False)
    np.testing.assert_allclose(gs[0, 0, :, 0].numpy(), ref, rtol=1e-5, atol=1e-4)


# ---- the algorithm ----

LR, STEPS = 1e-3, 3
N_SUP, N_UNSUP = 8, 16

STEP_CASES = {
    # name: (model, norm, extra Toy2DAlgo options)
    "mean_teacher_bn": ("mean_teacher", "batch_norm", {}),
    "mean_teacher_spectral_bce": ("mean_teacher", "spectral_norm", {"cons_loss_fn": "bce"}),
    "mean_teacher_gn_distmap": ("mean_teacher", "group_norm",
                                {"dist_contour_range": 3.0, "conf_thresh": 0.55}),
    "pi_weight_norm": ("pi", "weight_norm", {"cons_loss_fn": "logits_var"}),
    "pi_bn_no_dropout": ("pi", "batch_norm", {"cons_no_dropout": True, "conf_avg": True,
                                              "conf_thresh": 0.55}),
    "pi_onebatch_spectral": ("pi_onebatch", "spectral_norm", {}),
    "pi_onebatch_none": ("pi_onebatch", "none", {"cons_loss_fn": "bce"}),
}


def _algo_kw(model, extra, dist_map):
    kw = dict(model=model, cons_weight=2.0, cons_loss_fn="var", cons_no_dropout=False,
              conf_thresh=0.0, conf_avg=False, teacher_alpha=0.9,
              pstd_real=np.float32([0.2, 0.3]), dist_contour_range=0.0)
    kw.update(extra)
    return kw


def _dist_map(extra):
    if not extra.get("dist_contour_range"):
        return None
    return np.random.RandomState(7).randn(32, 32).astype(np.float32) * 4


def _close(net, variables, what):
    want = from_jax_variables(jax.device_get(variables), "toy2d")
    got = net.state_dict()
    assert set(got) == set(want)
    n_tight = n_all = 0
    for k, w in want.items():
        d = (got[k] - w).abs()
        assert d.max().item() <= 2 * LR * STEPS + 1e-6, (what, k, d.max().item())
        layer = k.split(".")[0]
        if k.endswith("bias") and f"bn{layer[5:]}.weight" in want or "running_mean" in k:
            continue  # the bias BN removes, and the running mean that carries it
        n_tight += int((d <= 1e-6 + 1e-5 * w.abs()).sum())
        n_all += d.numel()
    assert n_tight >= 0.99 * n_all, (what, n_all - n_tight, n_all)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_matches_jax(case, monkeypatch):
    model, norm, extra = STEP_CASES[case]
    bank = MaskBank()
    patch_flax_dropout(monkeypatch, bank)
    jnet, variables = _init(norm, hidden=16, randomise=False)
    dist_map = _dist_map(extra)
    kw = _algo_kw(model, extra, dist_map)
    tx = optax.adam(LR)
    jalgo = jtrain.Toy2DAlgo(jnet, tx, dist_map=None if dist_map is None else jnp.asarray(dist_map),
                             **kw)
    params, stats = variables["params"], variables.get("batch_stats", {})
    student = ModelState(params=params, batch_stats=stats)
    teacher = student if model == "mean_teacher" else None
    opt_state = tx.init(params)
    key = jax.random.PRNGKey(5)

    tstudent = _port(variables, norm)
    tteacher = copy.deepcopy(tstudent).requires_grad_(False) if model == "mean_teacher" else None
    names = dict(tstudent.named_parameters())
    opt = Optimizer(OptimizerConfig(opt_type="adam", learning_rate=LR), names,
                    {n: "new" for n in names})
    talgo = ttrain.Toy2DAlgo(opt, dist_map=None if dist_map is None else torch.from_numpy(dist_map),
                             **kw)

    rng = np.random.RandomState(11)
    for i in range(STEPS):
        sup_x = rng.uniform(-1, 1, (N_SUP, 2)).astype(np.float32)
        sup_y = rng.randint(0, 2, N_SUP).astype(np.int32)
        unsup_x = rng.uniform(-1, 1, (N_UNSUP, 2)).astype(np.float32)
        k_noise = jax.random.split(key, 5)[1]
        noise = np.array(jax.random.normal(k_noise, unsup_x.shape)
                           * jnp.asarray(kw["pstd_real"])[None, :])
        step = jax.jit(jalgo._train_step)  # traced anew: this step's masks
        student, teacher, opt_state, key, jm = step(
            student, teacher, opt_state, key, jnp.asarray(sup_x), jnp.asarray(sup_y),
            jnp.asarray(unsup_x))
        masks = bank.take()
        assert len(masks) == (1 if kw["cons_no_dropout"] else
                              2 if model == "pi_onebatch" else 3)
        tm = talgo.train_step(tstudent, tteacher, torch.from_numpy(sup_x),
                              torch.from_numpy(sup_y).long(), torch.from_numpy(unsup_x),
                              noise=torch.from_numpy(noise), drop_masks=masks)
        assert sorted(tm) == sorted(jm)
        for k in ("sup_loss", "cons_loss"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        assert abs(tm["conf_sum"].item() - float(jm["conf_sum"])) <= 1 + 1e-5
        assert float(jm["cons_loss"]) > 0
    _close(tstudent, {"params": student.params, "batch_stats": student.batch_stats}, "student")
    if model == "mean_teacher":
        _close(tteacher, {"params": teacher.params, "batch_stats": teacher.batch_stats},
               "teacher")


@pytest.mark.parametrize("norm", ["batch_norm", "spectral_norm"])
def test_predict_and_cons_grad_mag_match_jax(norm):
    jnet, variables = _init(norm)
    kw = _algo_kw("mean_teacher", {"conf_thresh": 0.0}, None)
    jalgo = jtrain.Toy2DAlgo(jnet, optax.adam(LR), **kw)
    state = ModelState(params=variables["params"], batch_stats=variables.get("batch_stats", {}))
    _, v2 = _init(norm, seed=4)
    state2 = ModelState(params=v2["params"], batch_stats=v2.get("batch_stats", {}))
    x = np.random.RandomState(5).uniform(-1, 1, (64, 2)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    k_noise = jax.random.split(key)[0]
    noise = np.array(jax.random.normal(k_noise, x.shape) * jnp.asarray(kw["pstd_real"])[None])
    ref = np.asarray(jalgo.cons_grad_mag(state, state2, jnp.asarray(x), key))
    names = {}
    talgo = ttrain.Toy2DAlgo(Optimizer(OptimizerConfig(), names, {}), **kw)
    tnet, tnet2 = _port(variables, norm), _port(v2, norm)
    out = talgo.cons_grad_mag(tnet, tnet2, torch.from_numpy(x), noise=torch.from_numpy(noise))
    assert ref.max() > 0
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-7)
    pred = talgo.predict(tnet, torch.from_numpy(x))
    np.testing.assert_allclose(pred.numpy(), np.asarray(jalgo.predict(state, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


# ---- the trainer ----

def _options(cmd):
    return {p.name: (p.default, getattr(p, "is_flag", False), type(p.type).__name__,
                     tuple(getattr(p.type, "choices", ()) or ()))
            for p in cmd.params}


def test_cli_has_the_jax_options_and_device():
    ours = _options(ttrain.experiment)
    assert ours.pop("device") == ("cuda", False, "StringParamType", ())
    assert ours == _options(jtrain.experiment)


@pytest.mark.parametrize("model", ["mean_teacher", "pi_onebatch"])
def test_cli_tiny_run(model, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = CliRunner().invoke(ttrain.experiment, [
        "--job_desc=tiny", "--dataset=spiral", "--n_sup=20", "--balance_classes",
        f"--model={model}", "--n_hidden=2", "--hidden_size=32", "--num_epochs=2",
        "--batch_size=256", "--conf_thresh=0.5", "--learning_rate=2e-3",
        "--render_cons_grad", "--save_output", "--device=cpu"], catch_exceptions=False)
    assert res.exit_code == 0, res.output
    run = tmp_path / "results" / "toy2d_train" / "tiny"
    assert sorted(p.name for p in run.glob("epoch_*.png")) == [
        "epoch_00000.png", "epoch_00001.png", "epoch_00002.png"]
    log = (run / "log_tiny.txt").read_text()
    assert re.search(r"Epoch 2: took [\d.]+s: clf loss=[\d.]+", log)
    err = float(re.search(r"FINAL RESULT: Error rate=([\d.]+)%", log).group(1))
    assert 0 <= err <= 100
    assert len((run / "metrics_tiny.jsonl").read_text().splitlines()) == 2


def test_cli_needs_a_gpu_unless_given_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CliRunner().invoke(ttrain.experiment, ["--job_desc=gpu", "--num_epochs=1"],
                           catch_exceptions=False)
