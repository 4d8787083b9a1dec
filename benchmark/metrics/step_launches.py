"""Kernels launched per iteration inside ``trainer.step`` (a count)."""


def read(summary: dict, cell: dict):
    return summary["launches_per_iter_by_span"].get("trainer.step") or None
