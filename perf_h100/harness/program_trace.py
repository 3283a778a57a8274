"""The program's own spans and counters over two stretches of a traced run.

The port marks its layer boundaries with spans and counts events
(``object_keypoints_tpu_torch.utils.timer``: ``serve``, ``decode`` and its
stages, the int8 conv's ``int8.quantize`` / ``im2col`` / ``mm`` /
``rescale``, ``train.step`` and its phases, ``corner_pool.forward`` /
``backward``; the counter ``weights.built``). Its tracing is off through the
window and the harness's profiled stretches, so that its cost on the host
reaches no other reading (``harness.trace`` leaves its ``okt::`` ranges out
of the device operations all the same). ``collect(call, calls)`` runs
after every other reading of a traced run has been taken, the device record
included, and turns the program's tracing on for two stretches of ``calls``
calls of the kind's traced ``call(record_function, j)`` (its marks left
out), restoring the earlier state after, also after an error; both kinds
keep what it returns as ``run.program``, which the per-layer metrics of
source ``program_span`` read through ``span_field``:

(a) no profiler: per span name the host ms a call (``host.<name>.ms``, the
    spans' whole length), self ms a call (``self_ms``, less their children)
    and spans a call; per counter its count a call (``counts``); and the
    mean wall ms of a call with tracing on (``wall_ms``, the calls back to
    back, a synchronise at the end), the readout of what tracing costs when
    it is on;
(b) under ``torch.profiler`` with CPU and CUDA activity, ``okt::``
    annotations never counted as device operations: per span name the
    device ms and kernels a call (``device.<name>``). A kernel belongs to
    every span, on any thread, whose interval holds the runtime call that
    launched it (matched by correlation id): ``ms`` and ``kernels`` count
    it in each of them, ``self_ms`` and ``self_kernels`` in the innermost
    one alone, the latest started (so a backward's kernels, launched from
    autograd's thread, go to ``corner_pool.backward`` or ``train.backward``).
    The card's idle gaps go to the spans open on the calling thread when
    the card went idle (``harness.trace.idle_gaps``'s rule): ``idle_ms``
    to each of them, ``self_idle_ms`` to the innermost. Work and idle time
    under no span are ``outside``. The profiler's cost on the host lengthens
    the idle gaps, as it lengthens the breakdown's.

Times are on ``time.time_ns()``'s clock, the spans' own; the profile's are
put on it by the trace's start (``clock_ms``: the median distance between a
span's start and its ``okt::`` range's in the profile).
"""

from __future__ import annotations

import collections
import contextlib
import statistics
import threading
import time

import torch
from torch.autograd import DeviceType

PREFIX = "okt::"  # the port's span ranges (utils.timer.PREFIX)


def span_field(run, span: str, field: str):
    """``field`` of ``span``'s row in a traced run's program trace
    (``collect``'s ``device``, a call's worth), or None where the run has no
    program trace or the span is not in it."""
    program = getattr(run, "program", None)
    row = (program or {}).get("device", {}).get(span)
    return None if row is None else row.get(field)


def _no_mark(name):
    return contextlib.nullcontext()


def _sync(device: str):
    if device != "cpu":
        torch.cuda.synchronize()


def collect(call, calls: int, device: str = "cuda") -> dict:
    """Stretches (a) and (b) of ``calls`` calls (see the module's doc)."""
    from object_keypoints_tpu_torch.utils import timer

    was = timer.enable(True)
    try:
        timer.snapshot()
        _sync(device)
        t0 = time.perf_counter()
        for j in range(calls):
            call(_no_mark, j)
        _sync(device)
        wall_s = time.perf_counter() - t0
        host = timer.snapshot()
        out = {"calls": calls, "wall_ms": 1e3 * wall_s / calls,
               "host": host_table(host["spans"], calls, timer.self_ms(host["spans"])),
               "counts": {k: v / calls for k, v in host["counts"].items()}}
        out.update(profiled(call, calls, device, timer))
        return out
    finally:
        timer.enable(was)
        if not was:
            timer.snapshot()


def host_table(spans, calls: int, self_ms: dict) -> dict:
    """Per span name: host ms, self ms and spans a call."""
    length, count = collections.Counter(), collections.Counter()
    for s in spans:
        if s["end"] is not None:
            length[s["name"]] += s["end"] - s["start"]
            count[s["name"]] += 1
    return {k: {"ms": length[k] / 1e6 / calls, "self_ms": self_ms.get(k, 0.0) / calls,
                "spans": n / calls} for k, n in count.items()}


def profiled(call, calls: int, device: str, timer) -> dict:
    """Stretch (b): the profile of ``calls`` calls, reduced by ``attribute``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    _sync(device)
    with profile(activities=activities) as prof:
        first = time.time_ns()
        for j in range(calls):
            call(_no_mark, j)
        _sync(device)
    spans = [s for s in timer.snapshot()["spans"] if s["end"] is not None]
    events = prof.events()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    out = attribute(spans, device_ops(events, start_ns), threading.get_ident(), first, calls)
    out["clock_ms"] = clock_ms(events, spans, start_ns)
    return out


def clock_ms(events, spans, start_ns):
    """The median |span start - its okt:: range's start| over the spans
    whose name has as many ranges in the profile, paired in order of start,
    ms (None where there are none)."""
    ranges = collections.defaultdict(list)
    for e in events:
        if e.name.startswith(PREFIX) and e.device_type == DeviceType.CPU:
            ranges[e.name[len(PREFIX):]].append(start_ns + e.time_range.start * 1e3)
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s["name"]].append(s["start"])
    gaps = [abs(a - b) / 1e6 for name, starts in by_name.items()
            if len(ranges[name]) == len(starts)
            for a, b in zip(sorted(starts), sorted(ranges[name]))]
    return statistics.median(gaps) if gaps else None


def _annotation(e) -> bool:
    return e.name.startswith(PREFIX) or bool(getattr(e, "is_user_annotation", False))


def device_ops(events, start_ns: int):
    """The device operations of a profile on ``time.time_ns()``'s clock:
    each CUDA-typed event that is no annotation as (start, end, name, launch
    ns or None), its launch the start of the runtime call (a host event
    named ``cu*``: ``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``, ...) with its correlation id, the latest that
    starts before the operation."""
    calls = collections.defaultdict(list)  # correlation id -> runtime calls' starts
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("cu") and not _annotation(e):
            calls[e.id].append(e.time_range.start)

    def ns(us):
        return start_ns + int(us * 1e3)

    def launch(k):
        starts = calls.get(k.id)
        if not starts:
            return None
        return ns(max([s for s in starts if s <= k.time_range.start] or starts))

    return [(ns(e.time_range.start), ns(e.time_range.end), e.name, launch(e))
            for e in events if e.device_type == DeviceType.CUDA and not _annotation(e)]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _holding(spans, t):
    """The spans whose interval holds ``t``, latest started last."""
    return sorted((s for s in spans if s["start"] <= t < s["end"]), key=lambda s: s["start"])


def attribute(spans, ops, thread, start, calls: int) -> dict:
    """Device ms, kernels and idle ms a call by span name (the module's
    rules), from ``spans`` (the store's closed records), ``ops``
    (``device_ops``: (start, end, name, launch)), the calling ``thread`` and
    the first call's ``start``, all in ns on one clock; ``ops`` and
    ``launched`` count the operations and those whose launch was found.
    Sums are kept in whole ns and counts until the division by ``calls``."""
    fields = ("ms", "kernels", "self_ms", "self_kernels", "idle_ms", "self_idle_ms")
    sums = collections.defaultdict(lambda: dict.fromkeys(fields, 0))
    outside = dict.fromkeys(("ms", "kernels", "idle_ms"), 0)
    for s, t, _, at in ops:
        held = _holding(spans, at) if at is not None else []
        if not held:
            outside["ms"] += t - s
            outside["kernels"] += 1
            continue
        for name in {h["name"] for h in held}:
            sums[name]["ms"] += t - s
            sums[name]["kernels"] += 1
        sums[held[-1]["name"]]["self_ms"] += t - s
        sums[held[-1]["name"]]["self_kernels"] += 1
    mine = [s for s in spans if s["thread"] == thread]
    if ops:
        end = max(t for _, t, _, _ in ops)
        busy = _union([(max(s, start), min(t, end)) for s, t, _, _ in ops if t > start])
        edges = [start] + [x for iv in busy for x in iv] + [end]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            held = _holding(mine, a)
            if not held:
                outside["idle_ms"] += b - a
                continue
            for name in {h["name"] for h in held}:
                sums[name]["idle_ms"] += b - a
            sums[held[-1]["name"]]["self_idle_ms"] += b - a

    def per_call(row):
        return {k: (v / 1e6 if k.endswith("ms") else v) / calls for k, v in row.items()}

    return {"device": {k: per_call(v) for k, v in sums.items()}, "outside": per_call(outside),
            "ops": len(ops), "launched": sum(at is not None for *_, at in ops)}
