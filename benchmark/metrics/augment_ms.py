"""Host ms per iteration inside the ``trainer.augment`` span of the trainer engine."""


def read(summary: dict, cell: dict):
    return summary["host_ms_per_iter"].get("trainer.augment") or None
