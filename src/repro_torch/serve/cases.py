"""The reference's two serving walkthroughs, run on the port.

`examples/noc_reconfig_demo.py`'s `fault_storm_recovery_walkthrough` and
`session_server_walkthrough` with the same inputs (dedup traces at twice
their load from twin keys, the controller pinned at 4 gateways, routers
under the first two gateways dead from interval 32), returning what they
print as data instead of printing it. `chip_smoke.py` phase 9 runs them
on the card and holds them to the reference's numbers;
`tests/test_torch_resilience.py` and `tests/test_torch_serve.py` run
them on the CPU beside the reference. `dse_traces` and `dse_server` make
the server phase 9 (c) runs at full size (and the tests at a small one):
the 8 PARSEC apps, a quarter with destination matrices, under the same
storm and healer.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import backend
from repro_torch import random as trandom
from repro_torch.core import faults, traffic
from repro_torch.core.gateway_controller import ControllerConfig
from repro_torch.core.simulator import Arch, SimConfig, SimSession
from repro_torch.serve.engine import SessionServer
from repro_torch.serve.policies import (PRIORITY_BATCH, PRIORITY_PREMIUM,
                                        ServerPolicy)
from repro_torch.serve.resilience import ResiliencePolicy, ResilienceRuntime
from repro_torch.serve.scheduler import SessionRequest

STORM_START = 32
LOAD_SCALE = 2.0
# The DSE-size server's sessions: lengths, priorities and twin keys from
# this seed, at least this many intervals each; its fault injector's
# horizon in hardware intervals (past every run it serves).
DSE_SEED, DSE_MIN_T, DSE_HORIZON = 19, 64, 1 << 14
# The burst of the server walkthrough: (trace seed, priority), 16
# intervals each.
BURST = ((10, PRIORITY_BATCH), (11, PRIORITY_PREMIUM), (12, PRIORITY_BATCH),
         (13, PRIORITY_BATCH))


def storm_sim() -> SimConfig:
    """RESIPI with the controller pinned at 4 gateways, so a dead router
    is a real capacity loss."""
    base = SimConfig().with_arch(Arch.RESIPI)
    return dataclasses.replace(base, ctl=ControllerConfig(
        l_m=base.ctl.l_m, max_gateways=4, min_gateways=4))


def scaled_trace(seed: int, t: int, device) -> dict:
    """dedup over `t` intervals from `prng_key(seed)` at twice its load."""
    tr = traffic.generate_trace("dedup", t,
                                trandom.prng_key(seed, device=device),
                                device=device)
    for k in ("ext_load", "mem_load", "int_load"):
        tr[k] = tr[k] * LOAD_SCALE
    return tr


def fault_storm_recovery(device=None) -> dict:
    """`ResilienceRuntime` over 64 intervals in chunks of 8 with the
    routers under the first two gateways dead from interval 32. Returns
    the victims, one event per chunk, the recovered placement and the
    bill."""
    dev = backend.resolve_device(device)
    sim = storm_sim()
    tr = scaled_trace(0, 64, dev)
    runtime = ResilienceRuntime(
        SimSession.init(sim, device=dev),
        ResiliencePolicy(threshold_frac=0.10, hysteresis=2, cooldown=1))
    victims = runtime.session.placement[:2]
    injector = faults.FaultInjector(
        [faults.GatewayFault(start=STORM_START, position=p)
         for p in victims], 64)
    for i, chunk in enumerate(traffic.chunk_trace(tr, 8)):
        t0 = i * 8
        faulted = injector.inject(chunk, runtime.current_cfg, t0)
        runtime.report_failed_positions(injector.failed_positions(t0))
        runtime.observe(faulted)
    return {"victims": victims, "events": runtime.events,
            "placement": runtime.session.placement,
            "total_pcm_nj": runtime.total_pcm_nj,
            "total_stall_cycles": runtime.total_stall_cycles,
            "replacements": runtime.replacements}


def session_server(device=None) -> dict:
    """A 2-lane server (chunk 8, queue capacity 3, search 4 x 6) under the
    same storm: two long streams, two more queued, a burst of four past
    capacity, then a drain. Returns the server, the victims and each
    submission's (signal, reason) in order."""
    dev = backend.resolve_device(device)
    sim = storm_sim()
    policy = ServerPolicy(lanes=2, chunk_intervals=8, queue_capacity=3)
    victims = SessionServer(sim, policy, device=dev).placement[:2]
    env = faults.FaultInjector(
        [faults.GatewayFault(start=STORM_START, position=p)
         for p in victims], 256)
    server = SessionServer(
        sim, policy, fault_env=env,
        resilience=ResiliencePolicy(threshold_frac=0.10, hysteresis=2,
                                    cooldown=1, search_generations=4,
                                    search_population=6),
        device=dev)
    submits = []

    def submit(seed, t, **kw):
        out = server.submit(SessionRequest(
            trace=scaled_trace(seed, t, dev), **kw))
        submits.append((out["signal"], out["reason"]))

    for i in range(2):
        submit(i, 64)
    server.run(1)
    for i in range(2, 4):
        submit(i, 64)
    for seed, pr in BURST:
        submit(seed, 16, priority=pr)
    server.drain()
    return {"server": server, "victims": victims, "submits": submits}


def dse_traces(n: int, device, *, max_t: int = 256) -> list:
    """`n` sessions of a DSE user's serving load: the 8 PARSEC apps in
    turn at DSE_MIN_T-`max_t` intervals (lengths and priorities from
    `np.random.default_rng(DSE_SEED)`), traces from the twin keys
    `split(prng_key(DSE_SEED), n)` at twice their load, every fourth with
    its destination matrix. Returns [(trace, priority)], traces on
    `device`."""
    dev = backend.resolve_device(device)
    rng = np.random.default_rng(DSE_SEED)
    keys = trandom.split(trandom.prng_key(DSE_SEED, device=dev), n)
    apps = traffic.APP_NAMES
    out = []
    for i in range(n):
        t = int(rng.integers(DSE_MIN_T, max_t + 1))
        tr = traffic.generate(traffic.ParsecSpec(apps[i % len(apps)], t),
                              keys[i], dest=i % 4 == 3, device=dev)
        for k in ("ext_load", "mem_load", "int_load"):
            tr[k] = tr[k] * LOAD_SCALE
        out.append((tr, int(rng.integers(3))))
    return out


def dse_server(policy: ServerPolicy, device, *,
               storm_dispatch: int) -> SessionServer:
    """A server on `storm_sim()` whose routers under the first two
    gateways die at hardware interval `storm_dispatch` x chunk, healed by
    the launcher's `ResiliencePolicy` (10% band, hysteresis 2, cooldown
    1, the default 8 x 8 device search)."""
    dev = backend.resolve_device(device)
    sim = storm_sim()
    victims = SessionServer(sim, policy, device=dev).placement[:2]
    env = faults.FaultInjector(
        [faults.GatewayFault(start=storm_dispatch * policy.chunk_intervals,
                             position=p) for p in victims], DSE_HORIZON)
    return SessionServer(
        sim, policy, fault_env=env,
        resilience=ResiliencePolicy(threshold_frac=0.10, hysteresis=2,
                                    cooldown=1), device=dev)
