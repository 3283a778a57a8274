"""Images trained a second: the steps completed in the window times the
batch, over the window's length on the host's clock (a synchronise closes
the window)."""


def read(run):
    return run.units / run.window_s
