"""Fleet walkthrough for the PyTorch port: one co-design DSE job, four ways.

    PYTHONPATH=src python examples/torch_fleet_sweep.py             # the card
    PYTHONPATH=src python examples/torch_fleet_sweep.py --device cpu

Runs the same small (chiplets x placements x workloads) grid through
`python -m repro_torch.launch.fleet`:

  1. a fresh process with an empty kernel-library cache (on the card its
     first call builds the epoch_step kernel with nvcc),
  2. the same job in a new process sharing that cache (the warm start of
     a fleet worker joining mid-campaign: no build),
  3. one emulated-host shard (`--shard 0:2`): the rows a real 2-process
     fleet member owns, bit for bit rows 0..k/2 of the full run,
  4. a 2-process gloo group, every point equal to the one-process run's.

On a multi-host deployment the same job runs as one worker per host:

    python -m repro_torch.launch.fleet --processes 8 --process-id $RANK \
        --coordinator head-node:12345 --collectives nccl \
        --cache-dir /shared/kernels
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

GRID = ["--chiplets", "4,9", "--placements", "2",
        "--workloads", "uniform,bursty", "--intervals", "8",
        "--reps", "2", "--seed", "0", "--dump-points"]


def fleet(extra, out_path, cache_dir, device):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", *GRID, *extra,
         "--device", device, "--cache-dir", str(cache_dir), "--out",
         str(out_path)], cwd=REPO, env=env, check=True)
    with open(out_path) as f:
        return json.load(f)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    device = p.parse_args(argv).device
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cache = tmp / "kernels"

        print("== 1. cold run (empty kernel-library cache) ==")
        cold = fleet([], tmp / "cold.json", cache, device)
        print(f"   {cold['grid_points']} grid points, first call "
              f"{cold['first_call_s']:.2f}s (builds "
              f"{cold['kernel_builds']}), then "
              f"{cold['points_per_sec']:.1f} points/s; best point "
              f"{cold['best_point']['label']}")

        print("== 2. warm run (new process, same cache) ==")
        warm = fleet([], tmp / "warm.json", cache, device)
        print(f"   first call {warm['first_call_s']:.2f}s, builds "
              f"{warm['kernel_builds']} ({warm['cache']['entries']} cached "
              f"libraries, {warm['cache']['bytes'] / 1e6:.1f} MB)")

        print("== 3. emulated-host shard 0 of 2 ==")
        shard = fleet(["--shard", "0:2"], tmp / "shard.json", cache, device)
        k = shard["grid_points"]
        same = shard["mean_latency"] == cold["mean_latency"][:k]
        print(f"   {k} of {shard['grid_points_full']} points "
              f"({shard['sweep_wall_s']:.3f}s), the first rows of the full "
              f"run bit for bit: {same}")

        print("== 4. a 2-process gloo group ==")
        group = fleet(["--processes", "2"], tmp / "group.json", cache,
                      device)
        print(f"   {group['process_count']} processes, "
              f"{group['points_per_sec']:.1f} points/s; every point the "
              f"one-process run's: "
              f"{group['mean_latency'] == cold['mean_latency']}")


if __name__ == "__main__":
    main()
