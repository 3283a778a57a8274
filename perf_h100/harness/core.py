"""The harness: one run of one cell of ``BENCHMARK.json``.

    python3 perf_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, metric or cell
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (the ``file`` of the configuration) and its plain
  reference ``configs/<config>.py`` (``reference_model(config)``);
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  general generator ``kinds/<kind>.py`` that reads it;
- ``metrics/<metric>.py``, or where there is none ``metrics/<stem>.py`` for
  the part of the metric's name before its first dot (``mfu.py`` reads
  ``mfu.serve``, ``mfu.int8`` and ``mfu.train``): ``read(run)`` returns the
  metric's value from what the run recorded, or None where it finds
  nothing to read;
- ``limits/<cell>.json``: each number the correctness check compares, with
  its limit.

A run sets its build and kernel caches inside the checkout, checks for the
cards, builds the cell from the seed, measures for ``--seconds``, checks the
outputs against the plain reference, and prints one JSON line last on
standard output. It prints no result, and exits non-zero, when there is no
card, when the check cannot be made, or when jax, jaxlib, flax or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # perf_h100/
ROOT = os.path.dirname(HERE)  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "object_keypoints_tpu")
CACHE_DIR = os.path.join(ROOT, ".perf_h100_cache")


def set_cache_env(env=os.environ):
    """Fixed cache directories inside the checkout, so that only a cell's
    first run in a checkout builds or compiles anything."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        env[var] = os.path.join(CACHE_DIR, sub)
    env["USE_FLAX"] = "0"  # keep libraries that could load JAX from doing so
    env["USE_JAX"] = "0"


def load_module(path: str, name: str):
    """A module from ``path`` under ``name`` (a file found by a name)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{os.path.relpath(path, ROOT)} not found")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: str):
    with open(path, "rt") as f:
        return json.load(f)


def loaded_forbidden(modules=None):
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name starts with the JAX package's)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


class Cell:
    """One entry of ``workloads`` with everything it names, loaded by name."""

    def __init__(self, manifest: dict, workload: str, root: str = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        config_path = os.path.join(root, self.config_entry["file"])
        self.config = read_json(config_path)
        self.reference = load_module(config_path[:-len(".json")] + ".py",
                                     f"perf_config_{self.workload['config']}")
        self.traffic = read_json(os.path.join(HERE, "traffic", self.workload["traffic"] + ".json"))
        self.kind = load_module(os.path.join(HERE, "kinds", self.traffic["kind"] + ".py"),
                                f"perf_kind_{self.traffic['kind']}")
        self.limits = read_json(os.path.join(HERE, "limits", workload + ".json"))
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in manifest["end_to_end"] if self._here(m)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]
        self.readers = {m["name"]: load_module(reader_path(m["name"]),
                                               "perf_metric_" + m["name"].replace(".", "_"))
                        for m in self.end_to_end + self.per_layer}

    def _here(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]


def reader_path(metric: str) -> str:
    """The file that reads ``metric``: ``metrics/<metric>.py``, or where there
    is none the reader of its stem (the name before the first dot)."""
    whole = os.path.join(HERE, "metrics", metric + ".py")
    return whole if os.path.isfile(whole) else os.path.join(HERE, "metrics",
                                                             metric.split(".")[0] + ".py")


def seed_streams(seed: int):
    """Independent 63-bit seeds for the weights, the inputs and the sample,
    all from ``--seed`` (any whole number)."""
    import numpy as np

    ss = np.random.SeedSequence(abs(int(seed)) + (1 << 64 if seed < 0 else 0))
    return [int(s.generate_state(2, np.uint32).view(np.uint64)[0] >> 1) for s in ss.spawn(3)]


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def judge(readings: dict, limits: dict):
    """(correct, checks): every limit's number read, finite, and at or under
    its limit; checks maps each name to its number and its limit."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        ok = finite(value) and value <= limit
        correct &= ok
        checks[name] = {"value": value if finite(value) else None, "limit": limit}
    return correct, checks


def dtype(name: str):
    """A traffic file's compute dtype by name."""
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def sync(device: str):
    """Wait for the card (nothing to wait for on the CPU)."""
    import torch

    if device != "cpu":
        torch.cuda.synchronize()


def device_record(ctx) -> dict:
    """The result's ``device``: the card's name, the cards used, and the
    process's peak of allocated memory so far (read before the check runs)."""
    import torch

    if ctx.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": ctx.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(cell: Cell, args, t0: float, device: str = "cuda", program=None):
    """Drive the cell's kind; returns its ``Record`` (what the run recorded)."""
    ctx = types.SimpleNamespace(config=cell.config, traffic=cell.traffic, limits=cell.limits,
                                reference=cell.reference, seed=args.seed, seconds=args.seconds,
                                trace=bool(args.trace), device=device, t0=t0, chips=cell.chips,
                                streams=seed_streams(args.seed))
    return cell.kind.run(ctx, program) if program is not None else cell.kind.run(ctx)


def result_line(cell: Cell, rec, trace: bool):
    """(result dict, checks) of a finished run."""
    correct, checks = judge(rec.readings, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = dict(rec.device)
    out = {"correct": bool(correct), "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
        out["breakdown"] = rec.trace["breakdown"]
    out["checks"] = checks
    return out, checks


def nvidia_smi() -> str:
    """The card's name, power limit and clocks as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
                               "temperature.gpu", "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"unread: {err}"


def parse_args(argv):
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    manifest = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = Cell(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perf_h100: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    rec = run_cell(cell, args, t0)
    found = loaded_forbidden()
    if found:
        print(f"perf_h100: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    out, checks = result_line(cell, rec, bool(args.trace))
    print(json.dumps({"perf_h100": {"cell": cell.name, "seed": args.seed, "seconds": args.seconds,
                                    "trace": bool(args.trace), "calls": rec.calls,
                                    "window_s": rec.window_s, "info": rec.info,
                                    "nvidia_smi": nvidia_smi()}}), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
