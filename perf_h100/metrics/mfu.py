"""The whole step's share of the card's dense peak, %: the model's
convolution FLOPs a call, counted from shapes (``harness.flops.conv_flops``;
a train step counts the forward's three times: forward, grad-input,
grad-weight), times the calls of the traced window, over the window's length
and the peak of the step's precision (``harness.flops.PEAK``)."""

from harness.flops import PEAK


def read(run):
    f = run.info.get("flops_per_call")
    if not f or not run.calls:
        return None
    return 100.0 * f * run.calls / run.window_s / PEAK[run.info["peak"]]
