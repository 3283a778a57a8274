"""Weights the program made again inside a call (its counter
``weights.built``: a cast that missed its cache, the stem kernel's taps, an
int8 conv's weights quantized again), a call, from the program trace's
unprofiled stretch (``harness.program_trace``); 0.0 where nothing was
rebuilt."""


def read(run):
    program = getattr(run, "program", None)
    return None if program is None else program["counts"].get("weights.built", 0.0)
