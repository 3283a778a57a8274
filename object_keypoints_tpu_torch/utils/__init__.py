"""Host utilities: visualization, metrics, event files, detector configs,
timers, the ROS message conversions and the MeanShift wrapper.

``Rate`` is the port's copy of ``object_keypoints_tpu/utils/__init__.py``'s
(the reference's perception/utils/__init__.py:3-14).
"""

import time

from object_keypoints_tpu_torch.utils.timer import Timing  # noqa: F401


class Rate:
    """Fixed-rate sleeper (perception/utils/__init__.py:3-14)."""

    def __init__(self, hz: float):
        self.period = 1.0 / hz
        self._last = time.monotonic()

    def sleep(self):
        now = time.monotonic()
        remaining = self.period - (now - self._last)
        if remaining > 0:
            time.sleep(remaining)
        self._last = time.monotonic()
