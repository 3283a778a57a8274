"""Seconds from the start of the process to the start of the window: imports,
seeded weights and inputs, the program's build (kernel builds included in a
checkout's first run), calibration and warm calls."""


def read(run):
    return run.setup_s
