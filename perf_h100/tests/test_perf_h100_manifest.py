"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import os
import re

from conftest import HERE, ROOT
from harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_size(manifest):
    assert set(manifest) == TOP
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert "perf_h100" in manifest["paths"] and len(manifest["paths"]) <= 16
    assert manifest["command"][1] == "perf_h100/run.py"
    assert 1 <= manifest["run_seconds"] <= 51


def test_names_and_units(manifest):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in manifest[k]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in manifest["workloads"]]:
        assert NAME.match(n), n
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for e in manifest["configs"] + manifest["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]


def test_entry_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_and_metric_is_found_by_name(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for w in manifest["workloads"]:
        cell = core.Cell(manifest, w["name"])
        here = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in here and len(here) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        assert set(cell.readers) == here | {m["name"] for m in cell.per_layer}
        for m in cell.per_layer:
            assert m["moves"] in here, (w["name"], m["name"])
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
    for c in manifest["configs"]:
        assert c["file"].startswith("perf_h100/configs/")
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == c["name"]
        assert os.path.isfile(os.path.join(ROOT, c["file"][:-5] + ".py"))


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirnames, files in os.walk(HERE):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
