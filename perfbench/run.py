"""The benchmark's one command.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json on the card this process finds: set-up,
a measured window of `--seconds`, with `--trace 1` a short traced window
after it, then the comparison with the plain reference. The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device, with --trace 1 breakdown, then checks: each compared number with
its limit); the compared numbers are also the last lines of standard
error. Exits non-zero, printing no result, without a CUDA card (or fewer
than the cell asks for), without the program's sources, or if JAX or the
JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """Import paths and the program's build caches, all inside the
    checkout at fixed places (only a cell's first run there builds)."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    build = ROOT / "build"
    os.environ["REPRO_CACHE_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"run.py: the program's sources are missing "
              f"({ROOT / 'src' / 'repro_torch'})", file=sys.stderr)
        return 3
    import torch

    from perfbench import harness

    entry = harness.cell_entry(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("run.py: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"run.py: the cell needs {entry['chips']} card(s), "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda",
                           t_start=T_START)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"run.py: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
