"""Fleet launcher for co-design DSE sweeps: `python -m repro_torch.launch.fleet`
(port of `repro.launch.fleet`).

One launchable job runs a (chiplets x placements x workloads) co-design
grid as one sharded `sweep_workload` across a `torch.distributed` group
(`repro_torch.core.distributed`), with the shared kernel-library cache
(`repro_torch.runtime.cache`) so workers start warm.

Ways to run it::

    # one process, the card (or --device cpu)
    python -m repro_torch.launch.fleet --chiplets 4,16,36 --intervals 16

    # launcher: spawn N local worker processes in one gloo group
    python -m repro_torch.launch.fleet --processes 2 --out fleet.json

    # one worker of an externally orchestrated fleet (one per host)
    python -m repro_torch.launch.fleet --processes 8 --process-id 3 \\
        --coordinator head-node:12345 --collectives nccl

    # emulated host: compute only shard 1 of 4 (the contiguous rows a real
    # 4-process fleet member owns)
    python -m repro_torch.launch.fleet --shard 1:4

    # four emulated devices in one process (blocks run in turn)
    python -m repro_torch.launch.fleet --local-device-count 4

Every process builds the identical grid from the seed; sharding is a
placement decision only (see `core.distributed.GridSharding`).
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

_PLACEMENT_SEED_SALT = 0x9E37


def _parse_ints(s: str):
    return [int(x) for x in s.split(",") if x.strip()]


def _parse_names(s: str):
    return [x.strip() for x in s.split(",") if x.strip()]


def sample_placements(cfg, count: int, seed: int):
    """Deterministic placement candidates: the default edge scheme plus
    `count - 1` seeded draws of `max_gateways_per_chiplet` distinct border
    slots on the chiplet's mesh (every process draws the same list)."""
    import numpy as np

    out = [None]
    if count <= 1:
        return out[:max(count, 1)]
    r = cfg.mesh_x
    border = [(x, y) for x in range(r) for y in range(r)
              if x in (0, r - 1) or y in (0, r - 1)]
    rng = np.random.default_rng(seed ^ _PLACEMENT_SEED_SALT)
    g = cfg.max_gateways_per_chiplet
    for _ in range(count - 1):
        idx = rng.choice(len(border), size=g, replace=False)
        out.append(tuple(border[i] for i in sorted(idx)))
    return out


def _spec_for(name: str, intervals: int):
    from repro_torch.core import traffic

    if name == "uniform":
        return traffic.UniformSpec(n_intervals=intervals)
    if name == "bursty":
        return traffic.BurstySpec(n_intervals=intervals)
    return traffic.ParsecSpec(name, n_intervals=intervals)


def build_grid(cfg, *, chiplets, placements: int, workloads,
               intervals: int, seed: int) -> dict:
    """The co-design grid: K = |chiplets| x |placements| x |workloads|
    zipped element-wise lists (one grid point per combination), identical
    on every process (deterministic from `seed`)."""
    from repro_torch.core import traffic

    placement_list = sample_placements(cfg, placements, seed)
    specs, n_chiplets, gateway_positions, labels = [], [], [], []
    for c in chiplets:
        for p_i, pos in enumerate(placement_list):
            for w in workloads:
                specs.append(traffic.as_spec(w) if not isinstance(w, str)
                             else traffic.as_spec(_spec_for(w, intervals)))
                n_chiplets.append(int(c))
                gateway_positions.append(pos)
                labels.append(f"c{c}/p{p_i}/{w}")
    return {"specs": specs, "labels": labels,
            "grids": {"n_chiplets": n_chiplets,
                      "gateway_positions": gateway_positions},
            "k": len(specs)}


def slice_grid(grid: dict, start: int, stop: int) -> dict:
    """One worker's contiguous rows (emulated-host shard)."""
    return {"specs": grid["specs"][start:stop],
            "labels": grid["labels"][start:stop],
            "grids": {g: v[start:stop] for g, v in grid["grids"].items()},
            "k": stop - start}


def run_sweep(args, *, shard=None) -> dict:
    """Join the fleet, build the grid, run the (sharded) co-design sweep
    and return the result record. `shard=(i, n)` computes only that
    emulated-host block; otherwise the grid shards over this process's
    `--local-device-count` devices and every process of the group."""
    import numpy as np
    import torch

    from repro_torch import backend
    from repro_torch import random as trandom
    from repro_torch.backend import resolve_device
    from repro_torch.core.distributed import (init_distributed,
                                              is_distributed,
                                              partition_bounds,
                                              process_count, process_index)
    from repro_torch.core.simulator import Arch, SimConfig, sweep_workload
    from repro_torch.runtime import cache as rcache

    info = init_distributed(coordinator=args.coordinator,
                            num_processes=args.processes
                            if args.process_id is not None else None,
                            process_id=args.process_id,
                            collectives=args.collectives)
    if not args.no_cache:
        rcache.enable_persistent_cache(args.cache_dir)
    dev = resolve_device(args.device)

    sim = SimConfig().with_arch(
        Arch[args.arch.upper()] if isinstance(args.arch, str) else args.arch)
    grid = build_grid(sim.cfg, chiplets=args.chiplets,
                      placements=args.placements, workloads=args.workloads,
                      intervals=args.intervals, seed=args.seed)
    k_full = grid["k"]
    # Per-lane keys, the trace-generation chiplet count and the padded
    # width are pinned to the full grid, so an emulated-host shard
    # reproduces exactly the rows a real fleet member owns (see
    # sweep_workload's gen_chiplets and pad_chiplets).
    keys = trandom.split(trandom.prng_key(args.seed, device=dev), k_full)
    gen_c = max(args.chiplets)
    if shard is not None:
        i, n = shard
        start, stop = partition_bounds(k_full, n, i)
        grid = slice_grid(grid, start, stop)
        keys = keys[start:stop]

    devices = [dev] * max(args.local_device_count or 1, 1)
    sharded = len(devices) > 1 or process_count() > 1

    def call():
        out = sweep_workload(grid["specs"], sim, keys=keys,
                             gen_chiplets=gen_c, pad_chiplets=gen_c,
                             device=dev,
                             devices=devices if sharded else None,
                             **grid["grids"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    t0 = time.perf_counter()
    out = call()
    first_call_s = time.perf_counter() - t0
    walls = []
    for _ in range(max(args.reps, 1)):
        t0 = time.perf_counter()
        out = call()
        walls.append(time.perf_counter() - t0)
    sweep_wall_s = min(walls)

    summ = {k: out["summary"][k].cpu().numpy().astype(np.float64)
            for k in ("mean_latency", "mean_power_mw", "mean_energy")}
    lat, pwr = summ["mean_latency"], summ["mean_power_mw"]
    result = {
        "mode": ("shard" if shard is not None else
                 "distributed" if is_distributed() else "local"),
        "shard": list(shard) if shard is not None else None,
        "grid_points": grid["k"], "grid_points_full": k_full,
        "intervals": args.intervals,
        "chiplets": args.chiplets, "placements": args.placements,
        "workloads": args.workloads,
        "process_count": process_count(),
        "process_index": process_index(),
        "device_count": len(devices) * process_count(),
        "device": str(dev),
        "first_call_s": first_call_s,
        "sweep_wall_s": sweep_wall_s,
        "points_per_sec": grid["k"] / sweep_wall_s,
        "pad_lanes": int(out.get("sharding", {}).get("pad_lanes", 0)),
        "best_point": {"label": grid["labels"][int(np.argmin(lat))],
                       "mean_latency": float(lat.min())},
        "mean_latency_mean": float(lat.mean()),
        "mean_power_mw_mean": float(pwr.mean()),
        "cache": rcache.persistent_cache_stats(),
        "kernel_builds": dict(backend.COUNTERS["builds"]),
        "kernel_launches": dict(backend.COUNTERS["launches"]),
        "distributed": info,
    }
    if args.dump_points:
        for k, v in summ.items():
            result[k] = [float(x) for x in v]
        result["labels"] = grid["labels"]
    return result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local_fleet(args) -> int:
    """Spawn `--processes` local workers in one `torch.distributed` group
    (the single-machine stand-in for one worker per host)."""
    coord = f"127.0.0.1:{_free_port()}"
    env = os.environ.copy()
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    procs = []
    for i in range(args.processes):
        cmd = [sys.executable, "-m", "repro_torch.launch.fleet",
               "--processes", str(args.processes), "--process-id", str(i),
               "--coordinator", coord] + _passthrough(args)
        if i == 0 and args.out:
            cmd += ["--out", args.out]
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=None if i == 0 else subprocess.PIPE,
            stderr=None if i == 0 else subprocess.STDOUT))
    rc = 0
    for i, p in enumerate(procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            rc = p.returncode
            if out:
                sys.stderr.write(f"--- worker {i} output ---\n"
                                 f"{out.decode(errors='replace')}\n")
    return rc


def _passthrough(args):
    out = ["--chiplets", ",".join(map(str, args.chiplets)),
           "--placements", str(args.placements),
           "--workloads", ",".join(args.workloads),
           "--intervals", str(args.intervals),
           "--seed", str(args.seed),
           "--reps", str(args.reps),
           "--arch", args.arch,
           "--device", args.device,
           "--collectives", args.collectives]
    if args.local_device_count:
        out += ["--local-device-count", str(args.local_device_count)]
    if args.cache_dir:
        out += ["--cache-dir", args.cache_dir]
    if args.no_cache:
        out += ["--no-cache"]
    if args.dump_points:
        out += ["--dump-points"]
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.fleet",
        description="Sharded co-design DSE sweep "
                    "(chiplets x placements x workloads)")
    p.add_argument("--processes", type=int, default=None,
                   help="fleet size; without --process-id, spawn this many "
                        "local workers")
    p.add_argument("--process-id", type=int, default=None,
                   help="this worker's rank (externally orchestrated fleet)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (torch.distributed tcp://)")
    p.add_argument("--collectives", default="gloo", choices=("gloo", "nccl"),
                   help="the group's backend (default gloo)")
    p.add_argument("--device", default="cuda",
                   help="device of each worker (default the card; cpu)")
    p.add_argument("--shard", default=None, metavar="I:N",
                   help="emulated-host mode: compute only grid shard I of N")
    p.add_argument("--local-device-count", type=int, default=None,
                   help="emulated devices per worker on --device (the grid "
                        "splits into that many blocks, run in turn)")
    p.add_argument("--chiplets", type=_parse_ints, default=[4, 16, 36, 64],
                   help="comma list of chiplet counts (default 4,16,36,64)")
    p.add_argument("--placements", type=int, default=4,
                   help="placement candidates per point (default edge "
                        "scheme + seeded border draws)")
    p.add_argument("--workloads", type=_parse_names,
                   default=["uniform", "bursty", "dedup", "canneal"],
                   help="comma list: uniform,bursty,<parsec app>,...")
    p.add_argument("--intervals", type=int, default=24)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=1,
                   help="timed repetitions after the first call")
    p.add_argument("--arch", default="resipi")
    p.add_argument("--cache-dir", default=None,
                   help="shared kernel-library cache directory")
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--dump-points", action="store_true",
                   help="include per-point summaries in the JSON")
    p.add_argument("--out", default=None, help="result JSON path")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.process_id is None and args.processes and args.processes > 1 \
            and args.shard is None:
        return launch_local_fleet(args)

    shard = None
    if args.shard:
        i, n = (int(x) for x in args.shard.split(":"))
        shard = (i, n)

    from repro_torch.core.distributed import shutdown_distributed

    try:
        result = run_sweep(args, shard=shard)
    finally:
        shutdown_distributed()
    if result["process_index"] == 0:
        line = (f"fleet: {result['grid_points']} points "
                f"({result['mode']}, {result['process_count']} proc x "
                f"{result['device_count'] // result['process_count']} dev "
                f"on {result['device']}) first "
                f"{result['first_call_s']:.2f}s, sweep "
                f"{result['sweep_wall_s']:.3f}s = "
                f"{result['points_per_sec']:.1f} points/s, best "
                f"{result['best_point']['label']}")
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
