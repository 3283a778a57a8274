"""Share of the traced run's window in which no operation ran on the card,
%: one less the device's busy seconds (its busy time a call in the device
trace of a stretch of calls after the window, times the window's calls)
over the window's length (``harness.trace.over_window``)."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
