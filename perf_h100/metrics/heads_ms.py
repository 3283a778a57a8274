"""Device milliseconds a train step of the detector's heads: the program's
``detector.heads`` span (every stack's corner-pool blocks, the pools'
forward scans included, and prediction heads in the train step's forward),
from the program trace's profiled stretch (``harness.program_trace``); None
where the run has no such span."""

from harness.program_trace import span_field


def read(run):
    return span_field(run, "detector.heads", "ms")
