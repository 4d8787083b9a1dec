"""GiB of the peak above what the window starts from: the largest
transient of an iteration (activations, gradients, augmented batches)
over set-up and window. Nothing to read off a CUDA device."""


def read(summary: dict, cell: dict):
    return summary.get("transient_gib")
