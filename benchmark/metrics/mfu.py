"""The whole step's share of the chip's peak: the reference's model FLOPs
per iteration (no recomputation counted) times the traced iterations, over
the traced window, over 989 TFLOP/s (H100 SXM, dense bf16)."""

PEAK_FLOPS = 989e12


def read(summary: dict, cell: dict):
    if summary["window_s"] <= 0 or not summary["iterations"]:
        return None
    flops = cell["workload"]["counts"]["model_flops_per_iter"] * summary["iterations"]
    return 100.0 * flops / summary["window_s"] / PEAK_FLOPS
