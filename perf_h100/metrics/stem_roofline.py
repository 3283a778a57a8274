"""The stem kernel's (``okt_stem_conv_bf16``) share of its roofline, %: the
least time for its bytes and FLOPs at the call's frames
(``harness.flops.stem_bound_s``) over its mean time a launch in the device
trace of the profiled stretch."""

from harness.flops import stem_bound_s

KERNEL = "stem_conv_bf16"


def read(run):
    if not run.trace:
        return None
    hits = [v for k, v in run.trace["kernels"].items() if KERNEL in k]
    seconds, count = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not count or seconds <= 0:
        return None
    n, _, h, w = run.info["frames"]
    return 100.0 * stem_bound_s(n, h, w)[0] / (seconds / count)
