#!/usr/bin/env python3
"""Benchmark of object_keypoints_tpu_torch on NVIDIA H100 cards.

    python3 perf_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cells, configurations and metrics are
those of ``BENCHMARK.json``; see ``harness/core.py``.
"""

import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core  # noqa: E402

core.set_cache_env()

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T0))
