"""Readings that the limits of `correct` are set from.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control <k>]

For each seed, in one process: the cell's set-up, a window of `--seconds`
at the cell's own load, then the compared numbers with the plain reference
in the program's place (the program's readings), and for the first `k`
seeds the same numbers with the control in the program's place: the
reference computed one precision below the configuration's (bfloat16 for
float32). With `--fault <name>` the program runs with that fault planted
(`faults.py`) and the readings are the fault's. Prints one JSON line per
seed and kind; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import run  # noqa: F401  (sets the import paths and build caches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None,
                    help="plant this fault (perfbench/faults.py) after "
                    "set-up: the readings are then the fault's")
    args = ap.parse_args(argv)
    run._paths()
    import torch

    from perfbench import harness

    bench = harness.load_benchmark()
    entry = harness.cell_entry(bench, args.workload)
    cell = harness.load_cell(entry["traffic"])
    config = harness.load_config(bench, entry["config"])
    for n, seed in enumerate(args.seeds):
        drv = harness.driver_class(cell["entry"])(cell, config, seed,
                                                  args.device)
        drv.setup()
        undo = None
        if args.fault:
            from perfbench.faults import plant
            undo = plant(args.fault, drv)
        calls, failed = harness.run_window(drv, args.seconds)
        if undo is not None:
            undo()
        drv.release()
        kinds = [(args.fault or "program", torch.float32)]
        if n < args.control and not args.fault:
            kinds.append(("control", torch.bfloat16))
        for kind, dtype in kinds:
            t0 = time.perf_counter()
            got = drv.readings(dtype)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, "calls": len(calls),
                              "failed": failed, "readings": got,
                              "limits": cell["limits"],
                              "check_s": time.perf_counter() - t0}),
                  flush=True)
        del drv
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
