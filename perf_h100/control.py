#!/usr/bin/env python3
"""Readings that the correctness limits are set from, in one process.

    python3 perf_h100/control.py --workload <cell> --seeds 12 --first-seed <n> \
        [--control-seeds 3] [--faults half_batch ...] [--seconds 2]

For a cell: the program's readings on ``--seeds`` seeds (a short window at
the cell's own load each, the run's own check after it), the control's (the
reference in the program's place, a precision below the configuration's)
on ``--control-seeds`` seeds (each of the kind's ``CONTROLS``), and each named fault's (``harness.faults``)
on as many. Prints one JSON line a reading and a summary line last: the
largest program reading and the smallest control and fault readings of each
number. Needs the card; the benchmark's runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import core  # noqa: E402
from harness.faults import FAULTS  # noqa: E402

core.set_cache_env()


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("control.py needs a CUDA card")
    cell = core.Cell(core.read_json(os.path.join(core.ROOT, "BENCHMARK.json")), args.workload)
    kind = cell.kind
    plans = [("program", kind.Program, args.seeds)]
    plans += [(name, cls, args.control_seeds) for name, cls in kind.CONTROLS.items()]
    plans += [(f, FAULTS[cell.traffic["kind"]][f](kind.Program), args.control_seeds)
              for f in args.faults]
    summary, seed = {}, args.first_seed
    for name, cls, n in plans:
        for _ in range(n):
            ns = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
            t0 = time.perf_counter()
            rec = core.run_cell(cell, ns, t0, program=cls)
            line = {"cell": cell.name, "as": name, "seed": seed, "readings": rec.readings,
                    "calls": rec.calls, "setup_s": rec.setup_s,
                    "memory_peak_bytes": rec.device["memory_peak_bytes"],
                    "seconds_all": time.perf_counter() - t0, "info": rec.info}
            print(json.dumps(line), flush=True)
            for k, v in rec.readings.items():
                agg = summary.setdefault(name, {})
                agg[k] = max(agg.get(k, v), v) if name == "program" else min(agg.get(k, v), v)
            seed += 1
            torch.cuda.empty_cache()
    print(json.dumps({"cell": cell.name, "summary": summary}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
