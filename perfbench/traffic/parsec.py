"""PARSEC-like application traces for the epoch-level cells.

The calibrated profile model of the ReSiPI reproduction (per-application
mean inter-chiplet load, coefficient of variation, phase period, share of
traffic that crosses the interposer, share of that bound for memory):
a slow raised-cosine phase, unit-mean lognormal jitter per interval and
chiplet, and a static per-chiplet weight in [0.7, 1.3]. Drawn with
torch's own generator on the target device, a few large calls per batch,
so a seed gives the same traces on every run; destination matrices are
the profile's ring-distance decay (`reference.epoch.parsec_destinations`).
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.epoch import parsec_destinations
from perfbench.seeds import generator

# (mean_ext_load, cv, phase_period, ext_frac, mem_frac) per application.
PARSEC = {
    "blackscholes": (0.044, 0.25, 20.0, 0.40, 0.30),
    "swaptions": (0.018, 0.30, 16.0, 0.30, 0.25),
    "streamcluster": (0.034, 0.35, 12.0, 0.45, 0.35),
    "facesim": (0.006, 0.20, 24.0, 0.25, 0.30),
    "fluidanimate": (0.028, 0.40, 10.0, 0.35, 0.25),
    "bodytrack": (0.022, 0.35, 14.0, 0.30, 0.30),
    "canneal": (0.038, 0.30, 18.0, 0.50, 0.40),
    "dedup": (0.024, 0.45, 8.0, 0.35, 0.30),
}


def app_batch(apps, n_intervals: int, n_chiplets: int, seed: int,
              stream: int, device, *, dest: bool = True) -> list:
    """One trace dict per app ({ext_load [T, C], mem_load [T], int_load
    [T, C], ext_frac [], dest [C, C], app}), float32 on `device`, drawn
    from (seed, stream)."""
    gen = generator(seed, stream, device)
    n, t, c = len(apps), n_intervals, n_chiplets
    prof = torch.tensor([PARSEC[a] for a in apps], dtype=torch.float64)
    mean, cv, period, ext_frac, mem_frac = (
        prof[:, i].to(device=device, dtype=torch.float32) for i in range(5))
    offset = torch.rand((n,), generator=gen, device=device) * 6.28
    jit_n = torch.randn((n, t, c), generator=gen, device=device)
    chip_n = torch.randn((n, c), generator=gen, device=device)
    steps = torch.arange(t, dtype=torch.float32, device=device)
    phase = torch.sin(steps[None, :] * (2.0 * math.pi / period[:, None])
                      + offset[:, None]) * 0.5 + 1.0
    sigma = torch.sqrt(torch.log1p(cv * cv))
    jitter = torch.exp(jit_n * sigma[:, None, None]
                       - 0.5 * (sigma * sigma)[:, None, None])
    chip_w = torch.clamp(1.0 + 0.15 * chip_n, 0.7, 1.3)
    ext = (phase * mean[:, None])[:, :, None] * jitter * chip_w[:, None, :]
    intra = ext * ((1.0 - ext_frac) / torch.clamp_min(ext_frac, 1e-6))[
        :, None, None]
    mem = torch.sum(ext, dim=-1) * mem_frac[:, None]
    out = []
    for i, app in enumerate(apps):
        tr = {"ext_load": ext[i].contiguous(), "mem_load": mem[i].contiguous(),
              "int_load": intra[i].contiguous(),
              "ext_frac": ext_frac[i].clone(), "app": app}
        if dest:
            tr["dest"] = torch.as_tensor(
                parsec_destinations(PARSEC[app][3], c),
                device=device)
        out.append(tr)
    return out


def stacked(traces: list) -> dict:
    """The batch's arrays stacked along a leading trace axis (what the
    reference reads): ext, intra [N, T, C], mem, t_mask [N, T], dest
    [N, C, C] or None."""
    ext = torch.stack([tr["ext_load"] for tr in traces])
    return {"ext": ext, "intra": torch.stack([tr["int_load"]
                                              for tr in traces]),
            "mem": torch.stack([tr["mem_load"] for tr in traces]),
            "t_mask": torch.ones(ext.shape[:2], dtype=torch.float32,
                                 device=ext.device),
            "dest": torch.stack([tr["dest"] for tr in traces])
            if "dest" in traces[0] else None}
