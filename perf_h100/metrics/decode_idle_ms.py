"""Milliseconds a call that the card sat idle while the host was inside the
program's ``decode`` span (``pipeline.decode.decode_objects_batch``): the
host's pace through the decode's launches, from the program trace's
profiled stretch (``harness.program_trace``; the profiler's own cost on the
host lengthens it)."""

from harness.program_trace import span_field


def read(run):
    return span_field(run, "decode", "idle_ms")
