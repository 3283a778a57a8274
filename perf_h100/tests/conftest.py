"""Shared fixtures of the benchmark's own tests (run on the CPU:
``python -m pytest perf_h100/tests``; the card's tests are marked ``gpu``
and skip without one)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]

from harness import core  # noqa: E402

# a configuration's CPU size: the same code paths at widths the CPU runs in seconds
TINY_DIR = os.path.join(HERE, "tests", "tiny")


def tiny_config(name):
    """``tests/tiny/<name>.json``: what a configuration's CPU-sized copy sets
    (its widths, the program's factory and arguments, its input and output
    sizes); a group that is an object in both is updated key by key."""
    path = os.path.join(TINY_DIR, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"configuration {name!r} has no CPU size: "
                                f"{os.path.relpath(path, ROOT)} not found")
    return core.read_json(path)


def shrink(cell):
    """Cut a cell's configuration (by its tiny file) and traffic (by its
    kind) to a CPU-sized copy in place."""
    cfg, tr = cell.config, cell.traffic
    for key, value in tiny_config(cell.workload["config"]).items():
        if isinstance(value, dict) and isinstance(cfg.get(key), dict):
            cfg[key].update(value)
        else:
            cfg[key] = value
    if tr["kind"] == "keypoint_serve":
        tr.update(pairs=2, frame=63, pool=2, warm_calls=1, ref_block=2,
                  sample={"calls": 2, "from_first": 3})
        if tr.get("quantize"):
            tr["quantize"] = dict(tr["quantize"], batches=1, batch=2)
    else:
        tr.update(batch=4, dtype="float32",
                  objects=dict(tr["objects"], sides=[[4, 8], [8, 16], [16, 40]]))
    return cell


@pytest.fixture
def manifest():
    return core.read_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.fixture
def tiny_cell(manifest):
    def make(name):
        return shrink(core.Cell(manifest, name))

    return make
