"""The benchmark's harness: finds a cell's files by name, runs its window,
reads the metrics and decides `correct`.

Everything that belongs to one cell, configuration, entry kind or metric
lives in a file of its own, found by the name `BENCHMARK.json` gives:

  perfbench/workloads/<cell>.json    the cell's traffic and checks (data)
  perfbench/configs/<config>.json    the configuration's sizes (data)
  perfbench/drivers/<entry>.py       one driver per entry kind (`Driver`)
  perfbench/metrics/<metric>.py      one reader per metric (`read(ctx)`)

A run: the driver's set-up (inputs drawn from the seed, one warm call per
shape), then a closed loop of calls with one client for `seconds` (each
call starts when the previous one's results are on the host), then, with
`trace`, a short window of the same calls under the profiler, then the
driver's comparison with the plain reference.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "perfbench"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_cell(traffic: str) -> dict:
    """A traffic mix's parameters (perfbench/workloads/<traffic>.json)."""
    return json.loads((BENCH_DIR / "workloads" / f"{traffic}.json")
                      .read_text())


def load_config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def driver_class(entry: str):
    return importlib.import_module(f"perfbench.drivers.{entry}").Driver


def metric_reader(name: str):
    """`read(ctx)` of perfbench/metrics/<name>.py (loaded by path: a
    metric's name may hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: the end-to-end ones without
    `trace` (an entry without `workloads` in every cell), the per-layer
    ones with it, each where its `workloads` names the cell (every
    per-layer entry has the key)."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


@dataclass
class Call:
    t0: float
    t1: float
    info: dict


@dataclass
class Context:
    """What a metric reader sees."""
    cell: str
    setup_s: float
    calls: list                      # Call of the measured window
    window_s: float
    counters_before: dict
    counters_after: dict
    traced_calls: list = field(default_factory=list)
    trace: Optional[dict] = None     # perfbench.trace.read_trace's output

    def work(self, unit: str) -> Optional[float]:
        vals = [c.info["work"][unit] for c in self.calls
                if unit in c.info.get("work", {})]
        return float(sum(vals)) if vals else None

    def bound_share(self) -> Optional[float]:
        """The window's calls' summed counted least time (the simulated
        work at the card's f32 CUDA-core and HBM peaks) over their summed
        wall time, in percent."""
        done = [c for c in self.calls if c.info]
        wall = sum(c.t1 - c.t0 for c in done)
        bound = sum(c.info["bound_s"] for c in done)
        if wall <= 0.0 or bound <= 0.0:
            return None
        return 100.0 * bound / wall


def run_window(drv, seconds: float, tag: Optional[str] = None) -> tuple:
    """Closed loop of calls for `seconds`, the interpreter's cyclic garbage
    collector held off (as `timeit` does), so its pauses do not land in
    random calls; returns (calls, failed)."""
    gc.collect()
    gc.disable()
    try:
        return _loop(drv, seconds, tag, [])
    finally:
        gc.enable()


def _loop(drv, seconds: float, tag, calls: list) -> tuple:
    import torch

    failed = 0
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        try:
            if tag:
                with torch.profiler.record_function(tag):
                    info = drv.call(i)
            else:
                info = drv.call(i)
        except Exception as e:  # a failed call counts against attempted
            failed += 1
            print(f"call {i} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            info = {}
        t1 = time.perf_counter()
        calls.append(Call(t0, t1, info))
        i += 1
        if t1 - start >= seconds:
            return calls, failed


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device, overrides: Optional[dict] = None,
             t_start: Optional[float] = None, patch=None) -> dict:
    """One run of cell `name`; returns the result line's dict (with
    "checks" last). `overrides` replaces keys of the cell's file (tests run
    small sizes); `patch(driver)`, if given, runs after set-up (tests plant
    faults through it)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = load_benchmark()
    entry = cell_entry(bench, name)
    cell = load_cell(entry["traffic"])
    if overrides:
        cell = dict(cell, **overrides)
    config = load_config(bench, entry["config"])
    cuda = torch.device(device).type == "cuda"
    drv = driver_class(cell["entry"])(cell, config, seed, device)
    drv.setup()
    if patch is not None:
        patch(drv)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    before = drv.counters()
    mem0 = _allocator(cuda)
    calls, failed = run_window(drv, seconds)
    window_s = calls[-1].t1 - calls[0].t0
    after = drv.counters()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    alloc = {k: v - mem0.get(k, 0) for k, v in _allocator(cuda).items()}
    ctx = Context(name, setup_s, calls, window_s, before, after)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        from perfbench.trace import traced_window
        ctx.traced_calls, ctx.trace = traced_window(drv, run_window)
        failed += sum(not c.info for c in ctx.traced_calls)
        if ctx.trace is not None:
            device_info["busy_s"] = ctx.trace["busy_s"]
            device_info["window_s"] = ctx.trace["window_s"]
            breakdown = {"device_ops": ctx.trace["device_ops"],
                         "idle_gaps": ctx.trace["idle_gaps"]}
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    drv.release()
    if cuda:
        torch.cuda.synchronize()
    t_check = time.perf_counter()
    checks = drv.check()
    print(f"check took {time.perf_counter() - t_check:.3f} s, window "
          f"{window_s:.3f} s, {len(calls)} calls, set-up {setup_s:.3f} s; "
          f"{_thirds(calls)}; allocator in the window: {alloc}",
          file=sys.stderr)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    out = {"correct": bool(correct),
           "attempted": len(calls) + len(ctx.traced_calls),
           "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def _allocator(cuda: bool) -> dict:
    """The card's caching-allocator counters (device mallocs and frees,
    retries after a failed malloc, reserved bytes): where they move inside
    the window, the allocator is working there."""
    if not cuda:
        return {}
    import torch

    st = torch.cuda.memory_stats()
    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries",
            "reserved_bytes.all.current")
    return {k: st.get(k, 0) for k in keys}


def _thirds(calls: list) -> str:
    """Median call ms in each third of the window (drift within a run)."""
    import numpy as np

    n = len(calls)
    parts = [calls[i * n // 3:(i + 1) * n // 3] for i in range(3)]
    return "median call ms by thirds " + " / ".join(
        f"{np.median([(c.t1 - c.t0) * 1e3 for c in p]):.3f}" if p else "-"
        for p in parts)


def forbidden_loaded() -> list:
    """Top-level module names of the JAX package or JAX in sys.modules,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))
