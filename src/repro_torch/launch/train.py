"""End-to-end training driver of the port (from `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
        --smoke --steps 200 --batch 8 --seq 256 [--device cpu]

Integrates every subsystem: the model registry, the synthetic data
pipeline, the optimizer, checkpointing with restart, the fault-tolerance
guards and the ReSiPI Level-2 lane controller (epoch-metered collective
traffic -> lane-width decisions -> photonic-model energy accounting). The
weights start from the twin key `prng_key(0)`, so a run starts from the
reference launcher's weights. It runs on the card unless `--device` names
another; `--smoke` takes the reduced configs. A step is timed up to
`float(loss)`, which waits for the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import reconfig_runtime as lanes
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import get_model
from repro_torch.random import prng_key
from repro_torch.runtime.fault_tolerance import Heartbeat, StepGuard
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--epoch-steps", type=int, default=20,
                    help="ReSiPI reconfiguration interval (steps)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = get_model(cfg)
    dcfg = DataConfig(global_batch=args.batch, seq_len=args.seq)
    data = SyntheticLM(cfg, dcfg)

    state = init_train_state(model, prng_key(0, device=dev))
    start_step = 0
    if args.resume and args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state = ckpt.restore_checkpoint(state, args.ckpt_dir)
            start_step = last
            print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(
        model, accum=args.accum,
        opt_overrides={"lr": args.lr, "total_steps": args.steps})

    # --- ReSiPI Level-2 lane controller -----------------------------------
    lane_cfg = lanes.LaneConfig()
    lane_state = lanes.LaneState.init(lane_cfg)
    lane_history = []

    heartbeat = Heartbeat()
    guard = StepGuard()
    losses = []

    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.host_slice(step).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        dt = time.perf_counter() - t0
        heartbeat.beat(dt)

        # The non-finite skip already happened inside the step (on the
        # device); the host-side guard is telemetry + abort policy.
        if not guard.check(loss, gnorm):
            print(f"[guard] step {step} skipped in-step "
                  f"(loss={loss:.4g} gnorm={gnorm:.4g})")

        # lane metering: static DP-sync bytes + dynamic MoE imbalance
        lane_state = lanes.meter_step(
            lane_state, float(metrics["collective_bytes"]))
        if (step + 1) % args.epoch_steps == 0:
            lane_state, rec = lanes.epoch_update(lane_state, lane_cfg)
            lane_history.append(int(rec["lanes_after"]))
            if bool(rec["reconfigured"]):
                print(f"[lanes] epoch {int(lane_state.epoch)}: "
                      f"load={float(rec['load']):.3f} -> "
                      f"{int(rec['lanes_after'])} lanes")

        losses.append(loss)
        if step % args.log_every == 0:
            print(f"[train] step {step}: loss {loss:.4f} "
                  f"gnorm {gnorm:.3f} ({dt*1000:.0f} ms)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = ckpt.save_checkpoint(state, args.ckpt_dir, step + 1)
            print(f"[ckpt] saved {path}")

    if lane_history:
        energy = lanes.lane_energy_report(torch.as_tensor(lane_history),
                                          lane_cfg)
        print(f"[lanes] mean width {float(energy['mean_lanes']):.2f}, "
              f"model power {float(energy['mean_power_mw']):.0f} mW, "
              f"reconfig {float(energy['reconfig_nj']):.0f} nJ")
    print(f"[train] final loss {np.mean(losses[-10:]):.4f} "
          f"(first-10 {np.mean(losses[:10]):.4f})")
    return losses


if __name__ == "__main__":
    main()
