"""Device milliseconds a train step of the detector's backbone: the
program's ``detector.backbone`` span (the stem and the hourglass stacks of
the train step's forward), from the program trace's profiled stretch
(``harness.program_trace``); None where the run has no such span."""

from harness.program_trace import span_field


def read(run):
    return span_field(run, "detector.backbone", "ms")
