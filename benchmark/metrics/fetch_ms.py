"""Host ms per iteration inside the ``trainer.fetch`` span of the trainer engine."""


def read(summary: dict, cell: dict):
    return summary["host_ms_per_iter"].get("trainer.fetch") or None
