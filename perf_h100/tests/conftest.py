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

# tiny widths: the same code paths at a size the CPU runs in seconds
TINY_KEYPOINT = dict(features=8, levels=2, dims=[16, 16, 32], mods=[1, 1, 1],
                     stem_features=[8, 16], cnv_dim=16)
TINY_SQUEEZE = dict(stacks=2, levels=2, dims=[8, 8, 16], mods=[1, 1, 1], cnv_dim=8,
                    stem_residuals=1, head_kernel=1)


def shrink(cell):
    """Cut a cell's configuration and traffic to a CPU-sized copy in place."""
    cfg, tr = cell.config, cell.traffic
    if tr["kind"] == "keypoint_serve":
        cfg["model"].update(TINY_KEYPOINT)
        cfg["output_size"] = 8
        tr.update(pairs=2, frame=63, pool=2, warm_calls=1, ref_block=2,
                  sample={"calls": 2, "from_first": 3})
        if tr.get("quantize"):
            tr["quantize"] = dict(tr["quantize"], batches=1, batch=2)
    else:
        cfg["model"].update(TINY_SQUEEZE)
        cfg["program_factory"] = "object_keypoints_tpu_torch.models.cornernet:CornerNetModel"
        cfg["program_kwargs"] = dict(TINY_SQUEEZE, hourglass="fire")
        cfg["db"].update(categories=3, input_size=[64, 64], output_sizes=[[16, 16]])
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
