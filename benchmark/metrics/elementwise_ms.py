"""Device ms per iteration of the kernels the name table files as
elementwise (BN affines, activations, blends, casts)."""


def read(summary: dict, cell: dict):
    return summary["device_ms_per_iter_by_group"].get("elementwise") or None
