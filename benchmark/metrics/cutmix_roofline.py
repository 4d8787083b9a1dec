"""The CutMix kernel's share of its roofline: the bytes of one blend at
the cell's shapes (both inputs read, output and mask written, in float32)
over 3.35 TB/s (H100 SXM HBM), over its device time per launch."""

PEAK_BYTES = 3.35e12


def read(summary: dict, cell: dict):
    n = summary["cutmix_launches"]
    if not n:
        return None
    per_launch = summary["cutmix_s"] / n
    return 100.0 * cell["workload"]["counts"]["cutmix_bytes"] / PEAK_BYTES / per_launch
