"""Device milliseconds a call of the int8 route's ``int8.rescale`` spans: the
rescale back to the compute dtype (scale, bias, cast, layout), over every
int8 convolution of the forward, from the program trace's profiled stretch
(``harness.program_trace``)."""

from harness.program_trace import span_field


def read(run):
    return span_field(run, "int8.rescale", "ms")
