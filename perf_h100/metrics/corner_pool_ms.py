"""Device milliseconds a train step of the corner pools: the program's
``corner_pool.forward`` and ``corner_pool.backward`` spans (the backward's
scan on autograd's thread), from the program trace's profiled stretch
(``harness.program_trace``); None unless both are there."""

from harness.program_trace import span_field

SPANS = ("corner_pool.forward", "corner_pool.backward")


def read(run):
    parts = [span_field(run, s, "ms") for s in SPANS]
    return None if None in parts else sum(parts)
