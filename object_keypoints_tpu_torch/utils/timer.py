"""Tag-based wall-clock timing and a profiler trace around a code region.

The port's copy of ``object_keypoints_tpu/utils/timer.py`` (the reference's
perception/utils/timer.py:5-32). ``Timing`` is a copy. ``trace(log_dir)``
keeps the JAX package's context-manager signature; it runs
``torch.profiler.profile`` over the region (the CPU, and the card where
there is one) and writes a Chrome trace into ``log_dir``, where the JAX
package's starts ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np

TRACE_NAME = "trace.json"


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


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region with ``torch.profiler`` and write its Chrome trace
    to ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))
