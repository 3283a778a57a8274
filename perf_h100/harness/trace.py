"""Spans and the device trace of a traced run (``--trace 1``).

Spans are the benchmark's own: CUDA events recorded around its calls into
the program (``Spans``), read once the window has closed, so the window
itself waits on nothing they add. The device trace is ``torch.profiler``
over two stretches of calls after the window, back to back and cycling the
cell's pool, each call's parts marked with ``record_function``: one of the
traffic's ``trace_seconds`` with CUDA activity alone, for the busy time and
window of the stretch and the device time by kernel, and a short one of ``trace_calls`` calls with
the CPU's activity too, for the idle gaps by what the host was doing (the
benchmark's span active when the card went idle). The profiler's own cost
on the host slows a loop that launches thousands of kernels a step, so the
stretch's idle share is not the window's; ``over_window`` takes the
stretch's device time a call, which the profiler does not change, over the
measured window's calls and length instead.
"""

from __future__ import annotations

import collections
import re

import torch

from harness.program_trace import PREFIX

# identifiers that say nothing of which kernel ran
NOISE = {"void", "at", "native", "c10", "std", "anonymous", "namespace", "const", "unsigned",
         "char", "int", "long", "bool", "float", "double", "Half", "BFloat16", "array",
         "detail", "cuda", "cudnn", "unsigned_int", "gpu_kernel_impl", "gpu_kernel_impl_nocast",
         "binary_internal", "OffsetCalculator", "TrivialOffsetCalculator", "memory",
         "LoadWithoutCast", "StoreWithoutCast", "LoadWithCast", "StoreWithCast", "lambda",
         "Array", "IntDivider", "unsigned_long", "signed_char", "true", "false", "nullptr",
         "cutlass", "cute", "ul", "ull"}
NAME_LENGTH = 64
# long library kernel names, shortened so that their tile sizes stay inside the length
ABBREVIATIONS = (("implicit_gemm", "igemm"), ("bf16bf16_bf16f32_f32", "bf16"),
                 ("nhwckrsc_nhwc", "nhwc"), ("tilesize", "t"), ("warpgroupsize", "wg"),
                 ("execute_segment_k_off_kernel", ""), ("execute_kernel", ""), ("__5x_cudnn", ""),
                 ("_cudnn", ""))


def short_kernel_name(name: str, length: int = NAME_LENGTH) -> str:
    """A kernel's name cut to ``length`` characters so that kernels stay
    apart: the kernel's own name, then the functors and ops of its template
    arguments, then its element type, each once, without namespaces."""
    head = name.replace("(anonymous namespace)", "").split("(")[0]
    for long, short in ABBREVIATIONS:
        head = head.replace(long, short)
    words = re.findall(r"[A-Za-z_][A-Za-z0-9_]*", head)
    dtype = next((w for w in words if w in ("BFloat16", "Half", "float", "double")), "")
    kept = []
    for w in words:
        if w not in NOISE and w not in kept and len(w) > 1:
            kept.append(w)
    if not kept:
        return name[:length]
    out = kept[0] + (":" + ".".join(kept[1:]) if len(kept) > 1 else "")
    if dtype:
        out = out[:length - len(dtype) - 1] + "/" + dtype
    return out[:length]


class Spans:
    """CUDA events around named parts of each call; ``ms()`` after a
    synchronise gives each part's device-clock milliseconds per call."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events = collections.defaultdict(list)

    def mark(self):
        if not self.enabled:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def add(self, name, start, end):
        if self.enabled:
            self.events[name].append((start, end))

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {name: [a.elapsed_time(b) for a, b in pairs] for name, pairs in self.events.items()}


def profile(fn, length, host: bool):
    """``fn(record_function, j)`` for j = 0, 1, ... under torch.profiler,
    ending in a synchronise: without ``host``, CUDA activity alone, until
    ``length`` seconds have passed; with ``host`` the CPU's activity too
    (its per-op cost slows the host, so the busy share is read without it),
    ``length`` calls."""
    import time

    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0, j = time.perf_counter(), 0
        while (j < length) if host else (time.perf_counter() - t0 < length):
            with record_function("call"):
                fn(record_function, j)
            j += 1
        torch.cuda.synchronize()
    prof.calls = j
    return prof


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _events(prof, marks):
    """(device operations, host spans) of a profile: the device's kernels and
    copies, leaving out the spans' own annotations and the program's
    (``okt::`` ranges), as (start, end, name) in us on one clock; and the
    host's ``marks`` ranges."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name not in marks and not e.name.startswith(PREFIX):
                device.append((s, t, e.name))
        elif e.name in marks:
            host.append((s, t, e.name))
    return device, host


def reduce_trace(device_prof, host_prof, spans=("forward", "decode", "to_host", "step")) -> dict:
    """From ``device_prof`` (CUDA activity alone): busy_s and window_s (from
    the first device operation's start to the last one's end, the calls back
    to back; the card's idle share is 1 - busy_s / window_s), device seconds by kernel (``kernels``: full name -> [seconds,
    count]) and the ten that took most; from ``host_prof`` (CPU and CUDA
    activity): the ten longest idle gaps by the span the host was in when
    the card went idle (the host's tracing makes them longer)."""
    marks = set(spans) | {"call"}
    device, _ = _events(device_prof, marks)
    if not device:
        return {"busy_s": 0.0, "window_s": 0.0, "kernels": {}, "breakdown": None}
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for s, t, name in device:
        kernels[name][0] += (t - s) / 1e6
        kernels[name][1] += 1
    start, end = min(s for s, _, _ in device), max(t for _, t, _ in device)
    busy_us = sum(t - s for s, t in _union([(s, t) for s, t, _ in device]))
    by_short = collections.defaultdict(float)
    for name, (sec, _) in kernels.items():
        by_short[short_kernel_name(name)] += sec
    top = sorted(by_short.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us / 1e6, "window_s": (end - start) / 1e6,
            "kernels": {k: list(v) for k, v in kernels.items()},
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": idle_gaps(host_prof, marks)}}


def over_window(reduced: dict, stretch_calls: int, window_calls: int, window_s: float) -> dict:
    """``reduced`` (``reduce_trace``'s) for the measured window: busy_s the
    stretch's device seconds a call times the window's calls, window_s the
    window's length; the stretch's own pair is kept under ``stretch``."""
    if reduced["busy_s"] > 0 and stretch_calls:
        reduced["stretch"] = {"busy_s": reduced["busy_s"], "window_s": reduced["window_s"],
                              "calls": stretch_calls}
        reduced["busy_s"] = reduced["busy_s"] / stretch_calls * window_calls
        reduced["window_s"] = window_s
    return reduced


def idle_gaps(prof, marks):
    """The ten longest sums of the card's idle time by the host's span."""
    device, host = _events(prof, marks)
    calls = [(s, t) for s, t, n in host if n == "call"]
    if not device or not calls:
        return []
    start, end = min(s for s, _ in calls), max(t for _, t, _ in device)
    busy = _union([(max(s, start), min(t, end)) for s, t, _ in device if t > start])
    edges = [start] + [x for iv in busy for x in iv] + [end]
    parts = [(s, t, n) for s, t, n in host if n != "call"]
    gaps = collections.defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        inside = sorted((s, n) for s, t, n in parts if s <= a < t)  # innermost: latest start
        gaps[inside[-1][1] if inside else "between spans"] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]
