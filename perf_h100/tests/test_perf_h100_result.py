"""A run driven on the CPU at a tiny size (the look for a card skipped): the
result line's keys, the checks, and the broken paths that must read as not
correct."""

import argparse
import json
import time
import types

import pytest

from harness import core
from harness.faults import FAULTS

MANIFEST = core.read_json(f"{core.ROOT}/BENCHMARK.json")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
KINDS = {w["name"]: core.read_json(f"{core.HERE}/traffic/{w['traffic']}.json")["kind"]
         for w in MANIFEST["workloads"]}


def drive(cell, program=None, seed=2**31 + 17, seconds=0.3):
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
    kw = {} if program is None else {"program": program}
    rec = core.run_cell(cell, args, time.perf_counter(), device="cpu", **kw)
    return core.result_line(cell, rec, False)


@pytest.mark.parametrize("name", CELLS)
def test_result_line(tiny_cell, name):
    cell = tiny_cell(name)
    out, checks = drive(cell)
    # the contract's keys, with the compared numbers beside their limits last
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True, checks
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(checks) == set(cell.limits)
    json.dumps(out)


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in FAULTS[KINDS[c]]])
def test_broken_path_is_not_correct(tiny_cell, name, fault):
    cell = tiny_cell(name)
    broken = FAULTS[cell.traffic["kind"]][fault](cell.kind.Program)
    out, checks = drive(cell, broken)
    assert out["correct"] is False, checks


def test_seed_streams_take_large_and_negative_seeds():
    a = core.seed_streams(2**31 + 5)
    assert a == core.seed_streams(2**31 + 5) and len(set(a)) == 3
    assert core.seed_streams(-3) != core.seed_streams(3)
    assert all(0 <= s < 2**63 for s in core.seed_streams(2**40))


def test_judge():
    ok, checks = core.judge({"a": 0.1, "b": 0}, {"a": 0.2, "b": 0})
    assert ok and checks["a"] == {"value": 0.1, "limit": 0.2}
    assert not core.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not core.judge({}, {"a": 1.0})[0]


def test_traced_result_line_keys(tiny_cell):
    cell = tiny_cell("valve-depth-b48")
    rec = types.SimpleNamespace(
        readings={"maps_gap": 0.1, "decode_frames_off": 0}, attempted=3, failed=0,
        units=6, window_s=1.0, calls=3, latencies_s=[0.3, 0.3, 0.4],
        spans={"forward": [1.0], "decode": [0.5]}, info={"flops_per_call": 1e9, "peak": "bf16",
                                                          "frames": [4, 3, 63, 63]},
        device={"platform": "gpu", "kind": "card", "count": 1, "memory_peak_bytes": 1},
        trace={"busy_s": 0.5, "window_s": 1.0, "kernels": {"stem_conv_bf16_kernel": [1e-3, 2]},
               "breakdown": {"device_ops": [["k", 0.5]], "idle_gaps": [["decode", 0.5]]}},
        program={"counts": {}, "device": {"decode": {"ms": 2.2, "kernels": 1260.0,
                                                     "idle_ms": 9.0}}})
    out, _ = core.result_line(cell, rec, True)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer}
    assert out["metrics"]["device_idle.serve"]["value"] == 50.0
    assert out["metrics"]["decode_kernels.serve"] == {"value": 1260.0, "unit": "kernels"}
    assert out["metrics"]["weight_builds.serve"]["value"] == 0.0


def test_heads_gap():
    import torch

    heads_gap = core.load_module(f"{core.HERE}/kinds/detector_train.py", "perf_kind_t").heads_gap
    want = [torch.full((2, 3, 4, 4), 4.0), torch.full((2, 1, 4, 4), 0.5)]
    got = [want[0] + 0.4, want[1] + 0.2]
    assert abs(heads_gap(got, want) - 0.2) < 1e-6  # 0.4 / 4 against 0.2 / max(1, 0.5)
    assert heads_gap(got[:1], want) == float("inf")
    assert heads_gap([want[0][:1], want[1]], want) == float("inf")
