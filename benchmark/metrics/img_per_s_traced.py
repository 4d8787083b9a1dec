"""Labelled images a second over the traced window (under the profiler):
the rate of a cell whose runs spread too widely to hold ``img_per_s`` end
to end."""


def read(summary: dict, cell: dict):
    return summary.get("img_per_s") or None
