"""Device milliseconds a call of the int8 route's ``int8.mm`` spans: the int8
GEMMs (``torch._int_mm``, their padding and copy), over every int8
convolution of the forward, from the program trace's profiled stretch
(``harness.program_trace``)."""

from harness.program_trace import span_field


def read(run):
    return span_field(run, "int8.mm", "ms")
