"""Device ms per iteration of the kernels launched inside ``trainer.augment``
(each kernel matched to its launch by the profiler's correlation ids)."""


def read(summary: dict, cell: dict):
    return summary["device_ms_per_iter_by_span"].get("trainer.augment") or None
