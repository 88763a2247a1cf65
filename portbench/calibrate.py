"""Readings that the limits of a cell's check are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--fault half_batch:4,5,6]

In one process, for each seed: the cell's set-up, the checked items (no
measured window) and the numbers compared, as a run reads them (the
program against the float32 reference).  On each control seed the same
with the reference in float8 put in the program's place; on each fault's
seeds, the program with that fault planted in its timed path
(``unchanged``, ``half_batch``, ``altered_answer``).  One JSON line a
reading, then a summary: the largest reading of the program and the
smallest of the control and of each fault, by number.  The benchmark's own
runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import run  # noqa: E402


def readings(cell, model, seed, device, fault=None, control=False) -> dict:
    import torch

    entry = run.load_module("entries", cell["entry"])
    runner = entry.Runner(cell, model, seed, device, fault)
    t0 = time.perf_counter()
    runner.setup()
    for i in runner.checked:
        runner.item(i)
    runner.close_window()
    t1 = time.perf_counter()
    out = runner.readings(control=control)
    t2 = time.perf_counter()
    detail = getattr(runner, "detail", None)
    del runner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"readings": out, "setup_and_items_s": t1 - t0,
            "reference_s": t2 - t1, "detail": detail}


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", action="append", default=[],
                    help="name:seed,seed,...")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = run.load_json("workloads", args.workload)
    model = run.load_json("configs", cell["config"])["model"]
    plan = [("program", None, False, s) for s in _seeds(args.seeds)]
    plan += [("control", None, True, s) for s in _seeds(args.control_seeds)]
    for spec in args.fault:
        name, seeds = spec.split(":")
        plan += [(name, name, False, s) for s in _seeds(seeds)]
    summary = {}
    for kind, fault, control, seed in plan:
        rec = readings(cell, model, seed, device, fault, control)
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, **rec}), flush=True)
        agg = summary.setdefault(kind, {})
        for k, v in rec["readings"].items():
            agg.setdefault(k, []).append(v)
    print(json.dumps({"summary": {
        kind: {k: (max(v) if kind == "program" else min(v))
               for k, v in agg.items()} for kind, agg in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
