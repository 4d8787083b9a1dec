"""A cell as the benchmark states it: its configuration and traffic files,
found by the names in BENCHMARK.json, the recipe's command-line flags they
add up to, and the values the reference reads from those flags (the
published trainers' defaults where a flag is not given)."""

from __future__ import annotations

import json
import os
from typing import Dict, List

from benchmark.reference.pipeline import Geometry

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the published trainers' defaults of every option the reference reads
DEFAULTS = {
    "batch_size": 10, "unsup_batch_ratio": 1, "num_epochs": 300, "iters_per_epoch": -1,
    "freeze_bn": False, "opt_type": "adam", "learning_rate": 1e-4, "lr_sched": "none",
    "lr_poly_power": 0.9, "sgd_momentum": 0.9, "sgd_nesterov": False, "sgd_weight_decay": 5e-4,
    "teacher_alpha": 0.99, "cons_loss_fn": "var", "cons_weight": 1.0, "conf_thresh": 0.97,
    "conf_per_pixel": False, "rampup": -1, "grad_accum": 1, "crop_size": "321,321",
    "aug_hflip": False, "aug_vflip": False, "aug_hvflip": False, "aug_scale_hung": False,
    "aug_max_scale": 1.0, "aug_rot_mag": 0.0, "aug_scale_non_uniform": False,
    "aug_strong_colour": False, "aug_colour_brightness": 0.4, "aug_colour_contrast": 0.4,
    "aug_colour_saturation": 0.4, "aug_colour_hue": 0.1, "aug_colour_prob": 0.8,
    "aug_colour_greyscale_prob": 0.2, "mask_mode": "mix", "mask_prop_range": "0.5",
    "boxmask_n_boxes": 1, "boxmask_fixed_aspect_ratio": False, "boxmask_by_size": False,
    "boxmask_outside_bounds": False, "boxmask_no_invert": False, "model": "mean_teacher",
    "n_sup": 100, "split_seed": 12345, "split_path": None, "compute_dtype": "bfloat16",
}
# what the reference implements of each option; anything else is refused
SUPPORTED = {
    "unsup_batch_ratio": {1}, "cons_loss_fn": {"var"}, "conf_per_pixel": {False},
    "rampup": {-1, 0}, "grad_accum": {1}, "sgd_nesterov": {False}, "aug_scale_non_uniform": {False},
    "mask_mode": {"mix"}, "boxmask_n_boxes": {1}, "boxmask_fixed_aspect_ratio": {False},
    "boxmask_by_size": {False}, "boxmask_outside_bounds": {False}, "boxmask_no_invert": {False},
    "model": {"mean_teacher"}, "lr_sched": {"none", "poly"},
}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def load_cell(name: str, manifest_data: dict = None, root: str = ROOT) -> dict:
    """{'name', 'config', 'traffic', 'workload', 'entry', 'end_to_end',
    'per_layer'}: the cell's files and the metrics BENCHMARK.json lists for
    it (a per-layer metric only where the cell reports the end-to-end
    metric it moves). ``root``: the checkout that holds the configuration's
    ``file`` and the benchmark's ``traffic/`` and ``workloads/``."""
    m = manifest_data or manifest()
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in m["configs"] if c["name"] == entry["config"])
    here = os.path.join(root, os.path.relpath(HERE, ROOT))

    def listed(metric):
        return "workloads" not in metric or name in metric["workloads"]

    end_to_end = [x for x in m["end_to_end"] if listed(x)]
    reported = {x["name"] for x in end_to_end}
    return {
        "name": name, "entry": entry,
        "config": load_json(os.path.join(root, cfg_entry["file"])),
        "traffic": load_json(os.path.join(here, "traffic", f"{entry['traffic']}.json")),
        "workload": load_json(os.path.join(here, "workloads", f"{name}.json")),
        "end_to_end": end_to_end,
        # a per-layer metric is read in the cells that report what it moves
        "per_layer": [x for x in m["per_layer"] if listed(x) and x["moves"] in reported],
    }


def flags(cell: dict) -> List[str]:
    """The trainer's command line of the cell."""
    return list(cell["config"]["flags"]) + list(cell["traffic"]["flags"])


def parse_flags(argv: List[str]) -> Dict[str, object]:
    out = {}
    for a in argv:
        if not a.startswith("--"):
            raise ValueError(f"not a flag: {a!r}")
        key, eq, val = a[2:].partition("=")
        out[key] = val if eq else True
    return out


def _typed(key: str, val):
    d = DEFAULTS.get(key)
    if isinstance(d, bool):
        return bool(val)
    if isinstance(d, int) and not isinstance(d, bool):
        return int(val)
    if isinstance(d, float):
        return float(val)
    return val


def hyperparameters(cell: dict) -> dict:
    """The values the reference computes with."""
    given = parse_flags(flags(cell))
    hp = dict(DEFAULTS)
    for k, v in given.items():
        hp[k] = _typed(k, v)
    for k, ok in SUPPORTED.items():
        if hp[k] not in ok:
            raise ValueError(f"the reference does not implement --{k}={hp[k]}")
    props = [float(x) for x in str(hp["mask_prop_range"]).split(":")]
    if len(props) == 2 and props[0] != props[1]:
        raise ValueError("the reference implements one fixed box area (--mask_prop_range=p)")
    hp["mask_prop"] = props[0]
    hp["algorithm"] = cell["traffic"]["algorithm"]
    if hp["algorithm"] != "mask_mt":
        raise ValueError(f"the reference has no {hp['algorithm']} step")
    hp["mean"], hp["std"] = cell["config"]["mean"], cell["config"]["std"]
    hp["colour"] = {
        "brightness": hp["aug_colour_brightness"], "contrast": hp["aug_colour_contrast"],
        "saturation": hp["aug_colour_saturation"], "hue": hp["aug_colour_hue"],
        "prob": hp["aug_colour_prob"], "greyscale_prob": hp["aug_colour_greyscale_prob"]}
    if not hp["aug_strong_colour"]:
        raise ValueError("the reference implements the recipes' colour jitter (--aug_strong_colour)")
    if hp["split_path"] is not None:
        hp["split_path"] = os.path.join(ROOT, hp["split_path"])
    return hp


def geometry(hp: dict) -> Geometry:
    crop = tuple(int(x) for x in str(hp["crop_size"]).split(","))
    if hp["aug_scale_hung"]:
        mode = "scale_hung"
    elif hp["aug_max_scale"] != 1.0 or hp["aug_rot_mag"] != 0.0:
        mode = "rotate_scale"
    else:
        raise ValueError("the reference implements the recipes' scale-crop and rotate-scale crop")
    return Geometry(crop=crop, mode=mode, max_scale=hp["aug_max_scale"],
                    rot_deg=hp["aug_rot_mag"], hflip=hp["aug_hflip"], vflip=hp["aug_vflip"],
                    hvflip=hp["aug_hvflip"])
