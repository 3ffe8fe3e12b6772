"""The paper's Figs. 10-13 from the port alone.

Counterparts of the reference's `benchmarks/fig10_lm_dse.py`,
`fig11_main.py`, `fig12_adaptivity.py` and `fig13_residency.py`. Figs.
10-12 take traces as arguments; `fig10_traces`, `fig11_traces` and
`fig12_trace` make them with the port's generator from the seeds and keys
those scripts use, which gives the reference's traces (the generator draws
with the threefry twin). Fig. 13 draws its arrivals with the twin too. They
return the same result dicts, without writing files.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.backend import resolve_device
from repro_torch.core import traffic
from repro_torch.core.simulator import (Arch, SimConfig, simulate,
                                        simulate_all_archs, stack_traces,
                                        sweep_batch)
from repro_torch.kernels.noc_step.ops import simulate_residency

GATEWAY_COUNTS = (1, 2, 3, 4)
FIG12_SEQUENCE = ("blackscholes", "facesim", "dedup")


def fig10_traces(n_intervals: int = 60, seed: int = 7, *,
                 device=None) -> list:
    """Fig. 10's workload: every PARSEC app, app i from key i of
    `split(prng_key(seed), 8)`."""
    traces = traffic.all_app_traces(n_intervals, seed=seed, device=device)
    return [traces[a] for a in traffic.APP_NAMES]


def fig11_traces(n_intervals: int = 100, seed: int = 1, *,
                 device=None) -> dict:
    """Fig. 11's workload: every PARSEC app from the one key
    `prng_key(seed)`."""
    key = trandom.prng_key(seed, device=resolve_device(device))
    return {a: traffic.generate_trace(a, n_intervals, key, device=device)
            for a in traffic.APP_NAMES}


def fig12_trace(per_app: int = 100, seed: int = 3, *, device=None) -> dict:
    """Fig. 12's workload: the `FIG12_SEQUENCE` apps concatenated, app i
    from key i of `split(prng_key(seed), 3)`."""
    keys = trandom.split(trandom.prng_key(seed,
                                          device=resolve_device(device)),
                         len(FIG12_SEQUENCE))
    return traffic.concat_traces([
        traffic.generate_trace(a, per_app, k, device=device)
        for a, k in zip(FIG12_SEQUENCE, keys)])


def fig10_dse(batch, base: SimConfig = None, *, device=None) -> dict:
    """Fig. 10: the L_m design-space exploration.

    Every app at every fixed gateway count g in 1..4 gives an (average
    per-gateway load, average latency) point; points within 10% of the
    best latency at their g are accepted and L_m is the largest accepted
    load (§4.2). `batch` is a list of traces or a `stack_traces` dict; the
    whole app x g grid is one `sweep_batch`.
    """
    base = base or SimConfig().with_arch(Arch.RESIPI)
    if isinstance(batch, (list, tuple)):
        batch = stack_traces(list(batch))
    gs = np.asarray(GATEWAY_COUNTS)
    out = sweep_batch(batch, base, device=device, max_gateways=gs,
                      min_gateways=gs)
    lat = out["summary"]["mean_latency"].cpu().numpy()            # [N, G]
    load = torch.mean(out["records"]["gw_load"],
                      dim=(2, 3)).cpu().numpy()                   # [N, G]
    apps = list(batch.get("app", [str(i) for i in range(lat.shape[0])]))
    points = [{"app": app, "g": g, "load": float(load[i, gi]),
               "latency": float(lat[i, gi])}
              for gi, g in enumerate(GATEWAY_COUNTS)
              for i, app in enumerate(apps)]
    accepted = []
    for g in GATEWAY_COUNTS:
        pg = [p for p in points if p["g"] == g]
        best = min(p["latency"] for p in pg)
        accepted += [p for p in pg if p["latency"] <= 1.1 * best]
    return {"points": points,
            "l_m_selected": max(p["load"] for p in accepted),
            "l_m_paper": 0.0152, "n_accepted": len(accepted)}


def fig11_main(traces: dict, base: SimConfig = SimConfig(), *,
               device=None) -> dict:
    """Fig. 11: latency / power / energy of every app (`traces` maps app
    name -> trace) under the four architectures, and ReSiPI's mean
    reductions against PROWAVES (paper: -37% / -25% / -53%)."""
    rows = {}
    for app, tr in traces.items():
        out = simulate_all_archs(tr, base, device=device)
        rows[app] = {a: {k: float(v) for k, v in s.items()}
                     for a, s in out.items()}

    def delta(metric, ref="prowaves"):
        return float(np.mean([1 - rows[a]["resipi"][metric]
                              / rows[a][ref][metric] for a in rows]))

    summary = {
        "latency_reduction_vs_prowaves": delta("mean_latency"),
        "power_reduction_vs_prowaves": delta("mean_power_mw"),
        "energy_reduction_vs_prowaves": delta("mean_energy"),
        "paper_claims": {"latency": 0.37, "power": 0.25, "energy": 0.53},
        "energy_reduction_vs_resipi_all": delta("mean_energy",
                                                "resipi_all"),
    }
    return {"per_app": rows, "summary": summary}


def settle_time(series: np.ndarray, start: int, window: int = 30,
                tol: float = 0.5) -> int:
    """Intervals after `start` until the series stays within +-tol of its
    eventual steady value for 3 consecutive intervals."""
    steady = np.median(series[start + window // 2: start + window])
    run = 0
    for i in range(start, min(start + window, len(series))):
        if abs(series[i] - steady) <= tol:
            run += 1
            if run >= 3:
                return max(i - start - 2, 1)
        else:
            run = 0
    return window


def fig12_adaptivity(trace: dict, per_app: int = 100, *,
                     device=None) -> dict:
    """Fig. 12: adaptivity across an application sequence.

    `trace` is the concatenation of `FIG12_SEQUENCE` segments of `per_app`
    intervals each. Runs ReSiPI and PROWAVES and measures the settle time
    of the active gateway total (ReSiPI) and of the mean wavelength count
    (PROWAVES) after each application switch (paper: ~3 vs ~5 intervals).
    """
    res_cfg = SimConfig().with_arch(Arch.RESIPI)
    res = simulate(trace, res_cfg, device=device)["records"]
    pro = simulate(trace, SimConfig().with_arch(Arch.PROWAVES),
                   device=device)["records"]
    g_total = res["g"].cpu().numpy().sum(axis=1) \
        + res_cfg.cfg.memory_gateways
    lam = pro["wavelengths"].cpu().numpy().mean(axis=1)
    switches = [per_app, 2 * per_app]
    adapt = {"resipi_settle": [settle_time(g_total, s) for s in switches],
             "prowaves_settle": [settle_time(lam, s) for s in switches]}
    return {
        "latency_resipi": res["latency"].cpu().numpy().tolist(),
        "latency_prowaves": pro["latency"].cpu().numpy().tolist(),
        "power_resipi": res["power_mw"].cpu().numpy().tolist(),
        "power_prowaves": pro["power_mw"].cpu().numpy().tolist(),
        "gateways_resipi": g_total.tolist(),
        "wavelengths_prowaves": lam.tolist(),
        "adaptation": adapt,
        "paper": {"resipi_settle": 3, "prowaves_settle": 5,
                  "max_gateways": 18},
        "max_gateways_used": int(g_total.max()),
    }


def fig13_residency(load: float = 0.10, cycles: int = 8192, seed: int = 5,
                    *, device=None) -> dict:
    """Fig. 13: per-router flit residency maps of one chiplet under
    dedup-class traffic. PROWAVES routes everything through one
    16-wavelength gateway (port-bound); ReSiPI spreads it over 2 active
    gateways of 4 wavelengths. The paper shows PROWAVES' gateway router far
    above every ReSiPI router: a max ratio > 1 reproduces the claim."""
    pro, pro_drained = simulate_residency(load, g_active=1, wavelengths=16,
                                          cycles=cycles, seed=seed,
                                          device=device)
    res, res_drained = simulate_residency(load, g_active=2, wavelengths=4,
                                          cycles=cycles, seed=seed,
                                          device=device)
    return {
        "prowaves_residency": pro.tolist(),
        "resipi_residency": res.tolist(),
        "prowaves_max": float(pro.max()),
        "prowaves_mean": float(pro.mean()),
        "resipi_max": float(res.max()),
        "resipi_mean": float(res.mean()),
        "max_ratio_pro_over_resipi": float(pro.max() / max(res.max(), 1e-9)),
        "drained": {"prowaves": pro_drained, "resipi": res_drained},
        "note": ("paper Fig. 13 shows the G-router residency in PROWAVES "
                 "far above every ReSiPI router; ratio > 1 reproduces the "
                 "congestion-distribution claim"),
    }
