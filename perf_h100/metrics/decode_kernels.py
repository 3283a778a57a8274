"""Device operations a call launched inside the program's ``decode`` span
(``pipeline.decode.decode_objects_batch``), from the program trace's
profiled stretch (``harness.program_trace``)."""

from harness.program_trace import span_field


def read(run):
    return span_field(run, "decode", "kernels")
