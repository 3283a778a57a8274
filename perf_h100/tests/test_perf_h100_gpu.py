"""The controls on the card, at the published widths and a batch a test run
holds: the program's run reads as correct and the control's (the reference
in the program's place, a precision below the cell's) as not correct, on
three seeds, for each of the cell's controls, in every cell of
``BENCHMARK.json``. Marked ``gpu``; without a card each test skips.

    python -m pytest perf_h100/tests/test_perf_h100_gpu.py
"""

import argparse
import time

import pytest
import torch

from harness import core

CELLS = [w["name"] for w in core.read_json(f"{core.ROOT}/BENCHMARK.json")["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def card_cell(manifest, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = core.Cell(manifest, name)
    if cell.traffic["kind"] == "keypoint_serve":
        cell.traffic.update(pairs=8, pool=2, sample={"calls": 2, "from_first": 4})
    else:
        cell.traffic.update(batch=8)
    return cell


def readings(cell, seed, program=None):
    args = argparse.Namespace(seed=seed, seconds=1.0, trace=0)
    kw = {} if program is None else {"program": program}
    rec = core.run_cell(cell, args, time.perf_counter(), **kw)
    torch.cuda.empty_cache()
    return core.judge(rec.readings, cell.limits)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_program_correct_control_not(manifest, name, seed):
    cell = card_cell(manifest, name)
    ok, checks = readings(cell, seed)
    assert ok, checks
    for control in cell.kind.CONTROLS.values():
        ok, checks = readings(cell, seed, control)
        assert not ok, (control.__name__, checks)
