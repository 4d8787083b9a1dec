"""The convolutions' share of the bf16 peak: the reference's convolution
FLOPs per iteration over the device time of the kernels the name table
files as convolution, over 989 TFLOP/s (H100 SXM, dense bf16)."""

PEAK_FLOPS = 989e12


def read(summary: dict, cell: dict):
    ms = summary["device_ms_per_iter_by_group"].get("convolution")
    if not ms:
        return None
    return 100.0 * cell["workload"]["counts"]["conv_flops_per_iter"] / (ms / 1e3) / PEAK_FLOPS
