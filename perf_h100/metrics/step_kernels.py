"""Device operations a train step launched inside the program's
``train.step`` span (forward, loss, backward on any thread, optimizer),
from the program trace's profiled stretch (``harness.program_trace``)."""

from harness.program_trace import span_field


def read(run):
    return span_field(run, "train.step", "kernels")
