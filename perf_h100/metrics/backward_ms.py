"""Device milliseconds a train step of the backward: the program's
``train.backward`` span (``torch.autograd.grad``, the corner pools' backward
scans on autograd's thread included), from the program trace's profiled
stretch (``harness.program_trace``); None where the run has no such span."""

from harness.program_trace import span_field


def read(run):
    return span_field(run, "train.backward", "ms")
