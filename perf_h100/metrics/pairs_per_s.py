"""Stereo pairs served a second: every pair completed in the window over
the window's length on the host's clock. (``pairs_per_s.int8`` reads the
same of the int8 cell apart: its rate is set mostly by the card and holds a
tighter bound than the bf16 cell's, paced partly by the host; PERF.md
section 2.)"""


def read(run):
    return run.units / run.window_s
