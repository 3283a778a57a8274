"""Tag-based wall-clock timing, the port's spans and counters, and a
profiler trace around a code region.

``Timing`` is the port's copy of ``object_keypoints_tpu/utils/timer.py``'s
(the reference's perception/utils/timer.py:5-32).

Spans and counters mark the port's layer boundaries: ``span(name)`` around
a stretch of work, ``count(name)`` for an event. Both are off by default;
off, ``span`` returns one shared no-op context after a single flag check (no
clock read, no allocation, no profiler range) and ``count`` does nothing.
``enable(True)`` turns them on: a span then appends a record to the store
and opens ``torch.profiler.record_function("okt::" + name)``, so a running
profiler carries it on its own timeline; ``snapshot()`` takes the records
and counts out of the store. A record holds the span's ``name``, its
``parent`` (the index of the innermost span open on the same thread when it
opened, or None), its ``call``, its ``thread`` and its ``start`` and ``end``
from ``time.time_ns()``, the clock of the profiler's trace. A span opened on
a thread with no open span starts a call, unless a call is open on another
thread: it then joins the newest open call (autograd runs a CUDA backward on
a thread of its own, and its spans belong to the step that started it).
Take a snapshot between calls: the parent indices of spans open across it
point into the store it emptied.

The sites: ``serve`` (``serving.export.make_inference_fn``'s call),
``decode`` with ``decode.peaks``, ``decode.assign``, ``decode.capacity``
and ``decode.lift`` (``pipeline.decode.decode_objects_batch``);
``int8.quantize``, ``int8.im2col``, ``int8.mm`` and ``int8.rescale``
(``serving.quantize``, ``ops.int8_conv``); ``train.step`` with
``train.forward``, ``train.loss``, ``train.backward`` and
``train.optimizer`` (``training.detection``); ``detector.backbone`` and
``detector.heads`` (``models.cornernet``'s forward); ``corner_pool.forward``
and ``corner_pool.backward`` (``ops.corner_pool``). The counter
``weights.built`` counts weights made again inside a call: a cast of
``models.blocks.in_dtype`` that misses its cache, the stem kernel's taps
rebuilt (``ops.stem_conv.bf16_taps``), an int8 conv's weights quantized
again for an input at another scale (``serving.quantize.Int8Conv``). The
counters ``int8.quantize.kernel`` and ``int8.quantize.relayout`` count the
quantize kernel's launches and the inputs made channels_last before it
(``ops.int8_conv.quantize``); ``corner_pool.kernel`` and
``corner_pool.relayout`` the corner pools' kernel launches, forward and
backward, and the maps and cotangents made channels_last before them
(``ops.corner_pool``).

``trace(log_dir)`` runs ``torch.profiler.profile`` over the region (the CPU,
and the card where there is one) with the spans on and writes its Chrome
trace into ``log_dir``, the ``okt::`` ranges beside the kernels, where the
JAX package's starts ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import Counter, defaultdict

import numpy as np

TRACE_NAME = "trace.json"
SPANS_NAME = "spans.json"
PREFIX = "okt::"


class Timing:
    def __init__(self):
        self._starts = {}
        self._samples = defaultdict(list)

    def start(self, tag: str):
        self._starts[tag] = time.perf_counter()

    def end(self, tag: str):
        self._samples[tag].append(time.perf_counter() - self._starts.pop(tag))

    @contextlib.contextmanager
    def measure(self, tag: str):
        self.start(tag)
        try:
            yield
        finally:
            self.end(tag)

    def stats(self):
        return {
            tag: (float(np.mean(v)), float(np.std(v)), len(v))
            for tag, v in self._samples.items()
        }

    def print_timing(self):
        print(f"{'tag':<30} {'mean (ms)':>12} {'std (ms)':>12} {'n':>6}")
        for tag, (mean, std, n) in self.stats().items():
            print(f"{tag:<30} {mean * 1e3:>12.3f} {std * 1e3:>12.3f} {n:>6}")


_on = False
_lock = threading.Lock()
_local = threading.local()
_spans: list = []
_counts: Counter = Counter()
_open_calls: list = []  # the calls of the open outermost spans, oldest first
_call_ids = itertools.count()


def enable(on: bool = True) -> bool:
    """Turn the spans and counters on or off; returns the earlier state."""
    global _on
    was, _on = _on, bool(on)
    return was


def enabled() -> bool:
    return _on


class _Off:
    """The shared context of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "record", "range", "root")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        from torch.profiler import record_function

        stack = _stack()
        with _lock:
            self.root = not stack and not _open_calls
            if stack:
                parent, call = stack[-1]
            else:
                parent = None
                call = next(_call_ids) if self.root else _open_calls[-1]
            if self.root:
                _open_calls.append(call)
            self.record = {"name": self.name, "parent": parent, "call": call,
                           "thread": threading.get_ident(), "start": None, "end": None}
            stack.append((len(_spans), call))
            _spans.append(self.record)
        self.range = record_function(PREFIX + self.name)
        self.range.__enter__()
        self.record["start"] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.record["end"] = time.time_ns()
        self.range.__exit__(*exc)
        _stack().pop()
        if self.root:
            with _lock:
                _open_calls.remove(self.record["call"])
        return False


def span(name: str):
    """A context that records a span named ``name`` while tracing is on."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        with _lock:
            _counts[name] += n


def snapshot() -> dict:
    """``{"spans": records, "counts": {name: n}}``, taken out of the store."""
    global _spans
    with _lock:
        spans, _spans = _spans, []
        counts = dict(_counts)
        _counts.clear()
    return {"spans": spans, "counts": counts}


def self_ms(spans) -> dict:
    """Per span name, the milliseconds of its closed spans less the part
    that their children (the spans whose ``parent`` they are) cover."""
    out = defaultdict(float)
    for s in spans:
        if s["end"] is not None:
            out[s["name"]] += (s["end"] - s["start"]) / 1e6
    for s in spans:
        p = s["parent"]
        if p is not None and s["end"] is not None and spans[p]["end"] is not None:
            out[spans[p]["name"]] -= (s["end"] - s["start"]) / 1e6
    return dict(out)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region with ``torch.profiler`` and the spans on, and write
    its Chrome trace to ``log_dir/trace.json`` (open it in Perfetto or
    chrome://tracing); the tracing state is restored after. Where tracing
    was off before, the region's spans and counts leave the store for
    ``log_dir/spans.json`` (with ``self_ms`` of the spans)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was = enable(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        enable(was)
        taken = None if was else snapshot()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))
    if taken is not None:
        with open(os.path.join(log_dir, SPANS_NAME), "wt") as f:
            json.dump(dict(taken, self_ms=self_ms(taken["spans"])), f)
