"""One run of one benchmark cell with the train step's phase split:

    python3 benchmark/phase_run.py --workload <cell> --seed <n> --seconds <s> --trace 1

from the root of a checkout. It runs ``benchmark/run.py`` as it is, with
``trace.summarise`` wrapped so that the same raw events also go through
``phases.summarise``; after run.py's result line it prints one more JSON
line, ``{"step_phases": ..., "step_phase_cover": ...}`` (``phases.py``).
With ``--trace 0`` it is run.py alone.

Temporary: it stands in for run.py printing the split itself, which an
edit to run.py brings (PERF.md, Open questions). That edit deletes this
file and its test in ``benchmark/tests/test_bench_phases.py``. It works
only while run.py looks the function up as ``trace.summarise`` at each
call.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import phases, run, trace  # noqa: E402


def with_phases(summarise, captured: dict):
    """``summarise`` (``trace.summarise``), which also puts the phase split
    of the same events into ``captured``."""

    def wrapped(events, iterations: int, window_s: float) -> dict:
        events = list(events)
        out = summarise(events, iterations, window_s)
        captured.update(phases.summarise(events, iterations))
        return out

    return wrapped


def main(argv=None) -> int:
    captured = {}
    original = trace.summarise
    trace.summarise = with_phases(original, captured)
    try:
        rc = run.main(argv)
    finally:
        trace.summarise = original
    if rc == 0 and captured:
        print(json.dumps(captured))
    return rc


if __name__ == "__main__":
    sys.exit(main())
