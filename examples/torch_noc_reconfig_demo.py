"""ReSiPI reconfiguration walkthrough on the PyTorch port (the port of
`examples/noc_reconfig_demo.py`, section for section): the controller and
PCMCs reacting to a live application switch, a 16-256 chiplet topology scan
in one padded `epoch_step` launch, the device placement search and its
islands, a mixed-workload sweep of ragged lengths, a streaming session, a
fault storm detected and healed, the session server under overload and
storm, destination-aware routing, and the Pareto co-design of a 256-chiplet
floorplan across 8 workloads.

    PYTHONPATH=src python examples/torch_noc_reconfig_demo.py          # card
    PYTHONPATH=src python examples/torch_noc_reconfig_demo.py --device cpu

The scan, the searches, the storm, the server and the co-design take their
settings from the cases `chip_smoke.py` phases 7-10 and
`repro_torch.serve.cases` hold to the reference's numbers. Where the JAX
demo prints `engine_stats()` trace counts, this one prints the port's
kernel launch counters (`backend.COUNTERS`): on the card each RESIPI sweep
is one `epoch_step` launch and each search generation one more; on the CPU
the kernel's plain version runs and nothing is launched.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cases  # noqa: E402
from repro_torch import backend  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import pareto, photonics, traffic  # noqa: E402
from repro_torch.core.constants import NETWORK  # noqa: E402
from repro_torch.core.simulator import (  # noqa: E402
    Arch, SimConfig, SimSession, reset_engine_stats, search_codesign,
    search_placement, search_placement_islands, simulate, sweep_topology,
    sweep_workload)
from repro_torch.serve import cases as serve_cases  # noqa: E402
from repro_torch.serve.engine import replay_standalone  # noqa: E402

SECTIONS = ("reconfiguration walkthrough", "hundreds-of-chiplets scan",
            "placement search", "island search", "mixed-workload sweep",
            "streaming session", "fault-storm recovery", "session server",
            "destination-aware frontier", "Pareto co-design")


def launches() -> str:
    return (f"{backend.COUNTERS['launches'].get('epoch_step', 0)} "
            f"epoch_step launch(es)")


def header(i: int, detail: str = "") -> None:
    print(f"\n== {SECTIONS[i]} ==" + (f" {detail}" if detail else ""))


def reconfiguration_walkthrough(dev):
    seq = ["blackscholes", "facesim", "dedup"]
    keys = trandom.split(trandom.prng_key(0, device=dev), 3)
    tr = traffic.concat_traces([traffic.generate_trace(app, 30, k, device=dev)
                                for app, k in zip(seq, keys)])
    reset_engine_stats()
    recs = simulate(tr, SimConfig().with_arch(Arch.RESIPI),
                    device=dev)["records"]
    g = recs["g"].cpu().numpy()
    power = recs["power_mw"].cpu().numpy()
    lat = recs["latency"].cpu().numpy()
    gmax = NETWORK.max_gateways_per_chiplet

    header(0)
    print("interval | app          | GT | latency | power_mW | kappa chain")
    for i in range(0, 90, 6):
        slots = torch.arange(gmax)[None, :] < torch.as_tensor(g[i])[:, None]
        active = torch.cat([slots.reshape(-1),
                            torch.ones(NETWORK.memory_gateways,
                                       dtype=torch.bool)])
        kappa = photonics.kappa_schedule(active)
        k_str = ",".join(f"{float(k):.2f}" for k in kappa[:5])
        print(f"{i:8d} | {seq[i // 30]:12s} | "
              f"{int(g[i].sum()) + NETWORK.memory_gateways:2d} | "
              f"{lat[i]:7.2f} | {power[i]:8.1f} | [{k_str},...]")
    print(f"\nPCM reconfiguration energy total: "
          f"{float(recs['reconfig_nj'].sum()):.0f} nJ (zero while the "
          f"activity pattern holds: non-volatile)")
    print(f"kernels: {launches()} for the walkthrough (one a simulate call "
          f"on the card)")


def hundreds_of_chiplets_scan(dev):
    counts = list(cases.WALK_COUNTS)
    cfg = NETWORK.with_topology(n_chiplets=max(counts))
    tr = traffic.generate_trace("canneal", 16,
                                trandom.prng_key(1, device=dev), cfg,
                                device=dev)
    reset_engine_stats()
    out = sweep_topology(tr, SimConfig().with_arch(Arch.RESIPI), device=dev,
                         n_chiplets=counts)["summary"]
    header(1, "(one padded launch)")
    print("chiplets | latency | power_mW | mean GT")
    for i, c in enumerate(counts):
        print(f"{c:8d} | {float(out['mean_latency'][i]):7.2f} | "
              f"{float(out['mean_power_mw'][i]):8.0f} | "
              f"{float(out['mean_gateways'][i]):7.1f}")
    print(f"kernels: {launches()} for {len(counts)} topologies (padded to "
          f"{max(counts)} chiplets, masked slots idle)")


def placement_search_walkthrough(dev):
    tr = traffic.generate_trace("dedup", 24, trandom.prng_key(2, device=dev),
                                device=dev)
    reset_engine_stats()
    res = search_placement(tr, SimConfig().with_arch(Arch.RESIPI),
                           generations=cases.SEARCH_GENERATIONS,
                           population=cases.SEARCH_POPULATION, seed=0,
                           device=dev)
    header(2, "(Table 1 system, objective: inter-chiplet latency)")
    print("generation | incumbent | best-so-far | accepted")
    for h in res["history"]:
        print(f"{h['generation']:10d} | {h['parent_score']:9.3f} | "
              f"{h['best_score']:11.3f} | {h['accepted']}")
    print(f"default edge scheme {res['default_score']:.3f} -> best "
          f"{res['best_placement']} at {res['best_score']:.3f} "
          f"(inter-chiplet latency {-res['improvement_frac']:+.1%})")
    print(f"kernels: {launches()} for {res['generations']} generations x "
          f"{res['population']} candidates (one a generation)")


def island_search_walkthrough(dev):
    tr = traffic.generate_trace("dedup", 24, trandom.prng_key(3, device=dev),
                                device=dev)
    lms = list(cases.ISLAND_LM)
    reset_engine_stats()
    res = search_placement_islands(
        tr, SimConfig().with_arch(Arch.RESIPI),
        generations=cases.SEARCH_GENERATIONS,
        population=cases.SEARCH_POPULATION, seed=0, l_m=lms, device=dev)
    header(3, f"(best placement per L_m, {res['islands']} chains)")
    print("island |    L_m | default | best    | found placement")
    for k in range(res["islands"]):
        print(f"{k:6d} | {lms[k]:6.4f} | "
              f"{res['island_default_scores'][k]:7.3f} | "
              f"{res['island_best_scores'][k]:7.3f} | "
              f"{res['island_best_placements'][k]}")
    print(f"overall best: island {res['best_island']} at "
          f"{res['best_score']:.3f} ({-res['improvement_frac']:+.1%} vs its "
          f"default)")
    print(f"kernels: {launches()} for {res['islands']} islands x "
          f"{res['generations']} generations x {res['population']} "
          f"candidates")


def mixed_workload_sweep(dev):
    specs = [traffic.ParsecSpec(app="blackscholes", n_intervals=30),
             traffic.ParsecSpec(app="facesim", n_intervals=18),
             traffic.UniformSpec(n_intervals=24),
             traffic.HotspotSpec(n_hotspots=1, n_intervals=24),
             traffic.PermutationSpec(pattern="transpose", n_intervals=20),
             traffic.BurstySpec(n_intervals=28)]
    reset_engine_stats()
    out = sweep_workload(specs, SimConfig().with_arch(Arch.RESIPI), seed=0,
                         device=dev)["summary"]
    header(4, "(ragged lengths, one padded launch)")
    print("workload     |  T | latency | power_mW | mean GT | saturated")
    for i, s in enumerate(specs):
        print(f"{s.name:12s} | {s.n_intervals:2d} | "
              f"{float(out['mean_latency'][i]):7.2f} | "
              f"{float(out['mean_power_mw'][i]):8.0f} | "
              f"{float(out['mean_gateways'][i]):7.1f} | "
              f"{float(out['saturated_frac'][i]):9.2f}")
    print(f"kernels: {launches()} for {len(specs)} workloads (T = 18..30 "
          f"padded to 30, masked tails zero)")


def streaming_session_walkthrough(dev):
    base = SimConfig().with_arch(Arch.RESIPI)
    apps = ["blackscholes", "facesim", "dedup"]
    keys = trandom.split(trandom.prng_key(4, device=dev), 3)
    full = traffic.concat_traces([traffic.generate_trace(a, 20, k, device=dev)
                                  for a, k in zip(apps, keys)])
    reset_engine_stats()
    session = SimSession.init(base, device=dev)
    header(5, "(chunks of 10, state persists across chunks)")
    print("chunk | intervals seen | chunk latency | running latency")
    for i, chunk in enumerate(traffic.chunk_trace(full, 10)):
        out = session.step_chunk(chunk)
        print(f"{i:5d} | {session.intervals_seen:14d} | "
              f"{float(out['summary']['mean_latency']):13.2f} | "
              f"{float(session.summary()['mean_latency']):15.2f}")
    streamed = launches()
    one = simulate(full, base, device=dev)
    drift = abs(float(session.summary()["mean_latency"])
                - float(one["summary"]["mean_latency"]))
    print(f"kernels: {streamed} for 6 chunks; chunked-vs-oneshot mean "
          f"latency drift {drift:.2e}")


def fault_storm_recovery_walkthrough(dev):
    reset_engine_stats()
    res = serve_cases.fault_storm_recovery(dev)
    v = res["victims"]
    header(6, f"(routers {v[0]}/{v[1]} die at interval "
              f"{serve_cases.STORM_START})")
    print("chunk | latency | baseline | breach | action")
    for i, e in enumerate(res["events"]):
        action = "-"
        if e["healed"] is not None:
            h = e["healed"]
            action = (f"HEAL: moved {h['moved_gateways']} gateways off "
                      f"{list(h['blocked_positions'])} "
                      f"({h['pcm_nj']:.0f} nJ PCM)")
        elif e["breach"]:
            action = "breach (hysteresis holding)"
        print(f"{i:5d} | {e['latency']:7.2f} | {e['baseline']:8.2f} | "
              f"{str(e['breach']):6s} | {action}")
    print(f"recovered placement: {res['placement']}")
    print(f"bill: {res['total_pcm_nj']:.0f} nJ PCM, "
          f"{res['total_stall_cycles']} stall cycles, "
          f"{res['replacements']} re-placement(s); {launches()}")


def session_server_walkthrough(dev):
    reset_engine_stats()
    res = serve_cases.session_server(dev)
    server, v = res["server"], res["victims"]
    header(7, f"(2 lanes, queue capacity 3, routers {v[0]}/{v[1]} die at "
              f"hardware interval {serve_cases.STORM_START})")
    for i, (signal, reason) in enumerate(res["submits"]):
        print(f"  submit {i}: {signal}" + (f" ({reason})" if reason else ""))
    print("tick | in-flight | queue | deg | latency | breach | action")
    for e in server.events:
        lat = "      -" if e["latency"] is None else f"{e['latency']:7.2f}"
        action = "-"
        if e.get("healed"):
            h = e["healed"]
            action = (f"HEAL: moved {h['moved_gateways']} gateways off "
                      f"{list(h['blocked_positions'])} "
                      f"({h['pcm_nj']:.0f} nJ PCM)"
                      if h["moved_gateways"] else
                      "re-search: incumbent confirmed (0 nJ)")
        elif e["breach"]:
            action = "breach (hysteresis holding)"
        deg = "  *" if e["degraded"] else "   "
        print(f"{e['tick']:4d} | {e['in_flight']:9d} | "
              f"{e['queue_depth']:5d} | {deg} | {lat} | "
              f"{str(e['breach']):6s} | {action}")
    m = server.metrics()
    sess = server.completed[0]
    replay = replay_standalone(server.sim, sess, device=dev)
    parity = all(float(replay[k]) == sess.summary()[k]
                 for k in ("mean_latency", "mean_energy", "valid_intervals"))
    print(f"drained: {m['completed']}/{m['admitted']} admitted sessions "
          f"completed ({m['shed_queue_full'] + m['shed_priority']} shed, "
          f"{m['displaced']} displaced), {m['heals']} heal(s), bill "
          f"{m['total_pcm_nj']:.0f} nJ PCM; {launches()}")
    print(f"replay parity: lane-packed {sess.id} equals its standalone "
          f"SimSession replay = {parity}")


def destination_fidelity_walkthrough(dev):
    sim = SimConfig()
    specs = [("uniform", traffic.UniformSpec(mean_load=0.05,
                                             n_intervals=48)),
             ("transpose", traffic.PermutationSpec(
                 pattern="transpose", mean_load=0.05, n_intervals=48)),
             ("tornado", traffic.PermutationSpec(
                 pattern="tornado", mean_load=0.05, n_intervals=48))]

    def inter_latency(trace, device):
        trace = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                 for k, v in trace.items()}
        out = simulate(trace, sim, device=device)
        tm = trace.get("t_mask")
        valid = float(tm.sum()) if tm is not None \
            else float(np.prod(trace["mem_load"].shape))
        return (float(out["records"]["mean_inter_latency"].sum()) / valid,
                float(out["summary"]["mean_power_mw"]))

    header(8, "(mean_load 0.05 for every pattern)")
    print("pattern    | blind lat | dest lat | dest power | plain lat")
    for name, spec in specs:
        tr = traffic.generate(spec, trandom.prng_key(0, device=dev),
                              dest=True, device=dev)
        blind, _ = inter_latency({k: v for k, v in tr.items()
                                  if k != "dest"}, dev)
        lat, pw = inter_latency(tr, dev)
        lat_plain, _ = inter_latency(tr, "cpu")
        print(f"{name:10s} | {blind:9.2f} | {lat:8.2f} | {pw:10.0f} | "
              f"{lat_plain:9.2f}")
    print("destination matrices move each pattern off the blind numbers; "
          "the plain version on the CPU lands on the same frontier")


def pareto_codesign_walkthrough(dev):
    sim = SimConfig().with_arch(Arch.RESIPI)
    counts = list(cases.PARETO_COUNTS)
    n_int, seed, dest = cases.PARETO_TRACES["a"]
    cfg = sim.cfg.with_topology(n_chiplets=max(counts))
    keys = trandom.split(trandom.prng_key(seed, device=dev),
                         len(cases.PARETO_APPS))
    traces = [traffic.generate(traffic.ParsecSpec(a, n_int), keys[i], cfg,
                               dest=dest, device=dev)
              for i, a in enumerate(cases.PARETO_APPS)]
    run = cases.PARETO_RUNS["a"]
    reset_engine_stats()
    res = search_codesign(traces, sim, device=dev, n_chiplets=counts, **run)
    header(9, f"({max(counts)}-chiplet x {len(traces)}-workload frontier)")
    print("chiplets |   L_m  | latency | power_mW |   energy | placement")
    for e in res["front"][:8]:
        o = e["objectives"]
        print(f"{e['topology']['n_chiplets']:8d} | "
              f"{e['knobs']['l_m']:6.4f} | {o['latency']:7.2f} | "
              f"{o['power_mw']:8.0f} | {o['energy']:8.3g} | "
              f"{e['placement']}")
    if len(res["front"]) > 8:
        print(f"  ... {len(res['front']) - 8} more front points")
    front = np.asarray([[e["objectives"][k] for k in
                         ("latency", "power_mw", "energy")]
                        for e in res["front"]])
    hv = pareto.hypervolume(front, tuple(2.0 * front.max(axis=0)))
    print(f"front: {len(res['front'])} non-dominated (topology, placement, "
          f"knob) points over {res['candidate_evals']} candidate evals; "
          f"hypervolume {hv:.3g}")
    print(f"kernels: {launches()} for {run['generations']} generations (all "
          f"{len(counts)} topologies and {run['islands']} islands in each "
          f"launch)")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    dev = backend.resolve_device(p.parse_args(argv).device)
    reconfiguration_walkthrough(dev)
    hundreds_of_chiplets_scan(dev)
    placement_search_walkthrough(dev)
    island_search_walkthrough(dev)
    mixed_workload_sweep(dev)
    streaming_session_walkthrough(dev)
    fault_storm_recovery_walkthrough(dev)
    session_server_walkthrough(dev)
    destination_fidelity_walkthrough(dev)
    pareto_codesign_walkthrough(dev)


if __name__ == "__main__":
    main()
