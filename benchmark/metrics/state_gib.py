"""GiB of device memory allocated when the window starts: weights, the
EMA teacher, the optimiser's state and the program's standing buffers.
Nothing to read off a CUDA device."""


def read(summary: dict, cell: dict):
    return summary.get("state_gib")
