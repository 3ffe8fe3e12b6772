"""Continuous-batching session-server launcher (port of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --ticks 24 --lanes 8 \
        --chunk 8 --arrival-rate 2 --burst-at 8 --burst-size 12

Drives a `SessionServer` under a bursty multi-tenant arrival mix (batch /
standard / premium classes), optionally with a mid-run fault storm and the
closed-loop healer, and prints the metrics/health surface. The arrival
process and the traces are the reference's for the same `--seed` (the
session traces are drawn with the threefry twin, `random.prng_key`). Runs
on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch import backend
from repro_torch import random as trandom
from repro_torch.core import faults, traffic
from repro_torch.core.gateway_controller import ControllerConfig
from repro_torch.core.simulator import Arch, SimConfig
from repro_torch.serve.engine import SessionServer
from repro_torch.serve.policies import PRIORITY_CLASSES, ServerPolicy
from repro_torch.serve.resilience import ResiliencePolicy
from repro_torch.serve.scheduler import SessionRequest


def _arrivals(args, rng, device):
    """Bursty multi-tenant arrival process: ~arrival_rate sessions per
    tick (priority mix 50/35/15 batch/standard/premium), plus one burst."""
    apps = ("dedup", "canneal", "streamcluster")

    def gen(now):
        n = rng.poisson(args.arrival_rate)
        if now == args.burst_at:
            n += args.burst_size
        reqs = []
        for _ in range(n):
            t = int(rng.integers(args.min_intervals, args.max_intervals + 1))
            tr = traffic.generate_trace(
                apps[int(rng.integers(len(apps)))], t,
                trandom.prng_key(int(rng.integers(1 << 30)), device=device),
                device=device)
            pr = PRIORITY_CLASSES[
                int(rng.choice(3, p=[0.50, 0.35, 0.15]))]
            reqs.append(SessionRequest(
                trace=tr, priority=pr,
                deadline_ticks=args.deadline if args.deadline > 0 else None))
        return reqs
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=24)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--queue-capacity", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=2.0)
    ap.add_argument("--burst-at", type=int, default=8)
    ap.add_argument("--burst-size", type=int, default=12)
    ap.add_argument("--min-intervals", type=int, default=8)
    ap.add_argument("--max-intervals", type=int, default=24)
    ap.add_argument("--deadline", type=int, default=0,
                    help="per-session deadline in ticks (0 = none)")
    ap.add_argument("--storm-at", type=int, default=-1,
                    help="hardware tick a gateway fault storm starts "
                         "(-1 = no faults)")
    ap.add_argument("--heal", action="store_true",
                    help="close the self-healing loop (blocked re-place)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to serve on: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = backend.resolve_device(args.device)

    sim = SimConfig().with_arch(Arch.RESIPI)
    policy = ServerPolicy(lanes=args.lanes, chunk_intervals=args.chunk,
                          queue_capacity=args.queue_capacity)
    env = None
    if args.storm_at >= 0:
        # Pin the gateway count for storm runs: with the adaptive
        # controller free to add gateways it absorbs the lost capacity and
        # the latency breach the detector keys on never materialises.
        sim = dataclasses.replace(sim, ctl=ControllerConfig(
            l_m=sim.ctl.l_m, max_gateways=4, min_gateways=4))
        horizon = args.ticks * args.chunk * policy.degrade_coalesce
        victims = SessionServer(sim, policy, device=dev).placement[:2]
        env = faults.FaultInjector(
            [faults.GatewayFault(start=args.storm_at * args.chunk,
                                 position=p) for p in victims],
            horizon, seed=args.seed)
    server = SessionServer(
        sim, policy, fault_env=env,
        resilience=ResiliencePolicy(threshold_frac=0.10, hysteresis=2,
                                    cooldown=1) if args.heal else None,
        device=dev)

    rng = np.random.default_rng(args.seed)
    server.run(args.ticks, arrivals=_arrivals(args, rng, dev))
    drain_ticks = server.drain()
    m = server.metrics()

    print(f"[serve] {m['submitted']} submitted -> {m['admitted']} admitted, "
          f"{m['completed']} completed over {m['ticks']} ticks "
          f"(+{drain_ticks} drain)")
    print(f"[serve] shed: queue_full={m['shed_queue_full']} "
          f"memory={m['shed_memory']} priority={m['shed_priority']} "
          f"displaced={m['displaced']}; expired={m['deadline_expired']} "
          f"evicted={m['idle_evicted']} retries={m['retries']}")
    p99 = f"{m['p99_chunk_s'] * 1e3:.2f}" if m["p99_chunk_s"] else "n/a"
    p50 = f"{m['p50_chunk_s'] * 1e3:.2f}" if m["p50_chunk_s"] else "n/a"
    print(f"[serve] {m['served_chunks']} chunks in {m['dispatches']} "
          f"dispatches ({m['coalesced_dispatches']} coalesced, "
          f"{m['degraded_ticks']} degraded ticks); chunk wall "
          f"p50={p50}ms p99={p99}ms")
    if args.heal:
        print(f"[serve] heals={m['heals']} pcm={m['total_pcm_nj']:.0f}nJ "
              f"availability="
              f"{m['availability']:.0%}" if m["availability"] is not None
              else "[serve] heals=0")
    print(f"[serve] health: {server.health()}")
    return server


if __name__ == "__main__":
    main()
