"""Device milliseconds a train step of the optimizer's update (the
program's ``train.optimizer`` span: Adam's ``_foreach`` passes), from the
program trace's profiled stretch (``harness.program_trace``)."""

from harness.program_trace import span_field


def read(run):
    return span_field(run, "train.optimizer", "ms")
