"""Progress + timing helpers: the port's copy of
``object_keypoints_tpu/utils/progress.py``.

- ``Timer``: tic/toc with running average (corner_net_lite/core/utils/
  timer.py), used by the inference drivers to report average per-image time
  (core/test/cornernet.py:40,49-51,63).
- ``stdout_to_tqdm``: redirect print through a tqdm-compatible writer
  (core/utils/tqdm.py) so progress bars don't get shredded by prints.
"""

from __future__ import annotations

import contextlib
import sys
import time


class Timer:
    def __init__(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0
        self.average_time = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self, average: bool = True):
        self.diff = time.perf_counter() - self.start_time
        self.total_time += self.diff
        self.calls += 1
        self.average_time = self.total_time / self.calls
        return self.average_time if average else self.diff


class _TqdmWriter:
    def __init__(self, file):
        self.file = file

    def write(self, x):
        if x.rstrip():
            try:
                from tqdm import tqdm

                tqdm.write(x.rstrip(), file=self.file)
            except ImportError:
                self.file.write(x)

    def flush(self):
        self.file.flush()


@contextlib.contextmanager
def stdout_to_tqdm():
    saved = sys.stdout
    try:
        sys.stdout = _TqdmWriter(saved)
        yield saved
    finally:
        sys.stdout = saved
