"""Trace generation: spec + `torch.Generator` -> trace dict.

Port of `repro.core.traffic.generators`. A trace is a dict over
reconfiguration intervals:
  ext_load   [T, C] — inter-chiplet packet injection per chiplet (pkts/cycle)
  mem_load   [T]    — traffic to the memory-controller gateways (pkts/cycle)
  int_load   [T, C] — intra-chiplet-only traffic (pkts/cycle per chiplet)
  ext_frac   []     — fraction of packets that cross the interposer
  app        str    — workload label (the spec's `name`)

The generators draw the SAME DISTRIBUTIONS as the reference (uniform phase
offsets, lognormal jitter, normal per-chiplet imbalance, random hotspot sets,
Markov on/off chains) with an explicit `torch.Generator` on the CPU, but NOT
the same bits as `jax.random`: a seed here and a key there give different
traces. Bit parity needs a torch twin of jax's threefry PRNG, which is still
to be ported; until then the parity tests hand both packages one
reference-made trace. Draws happen on the CPU (reproducible per seed on any
machine) and the finished trace moves to `device`.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core.constants import NETWORK, NetworkConfig
from repro_torch.core.traffic.specs import (APP_NAMES, BurstySpec,
                                            HotspotSpec, ParsecSpec,
                                            PermutationSpec, UniformSpec,
                                            as_spec,
                                            permutation_destinations)

_F32 = torch.float32


def _lognormal_jitter(gen: torch.Generator, shape, cv: float
                      ) -> torch.Tensor:
    """Unit-mean lognormal multiplicative jitter with coefficient cv."""
    if cv <= 0.0:
        return torch.ones(shape, dtype=_F32)
    sigma = torch.sqrt(torch.log1p(torch.tensor(cv ** 2, dtype=_F32)))
    return torch.exp(torch.randn(shape, generator=gen, dtype=_F32) * sigma
                     - 0.5 * sigma ** 2)


def _package(ext: torch.Tensor, intra: torch.Tensor, ext_frac: float,
             mem_frac: float) -> dict:
    return {"ext_load": ext,
            "mem_load": mem_frac * torch.sum(ext, dim=1),
            "int_load": intra,
            "ext_frac": torch.tensor(ext_frac, dtype=_F32)}


def _gen_parsec(spec: ParsecSpec, gen: torch.Generator,
                cfg: NetworkConfig) -> dict:
    prof = spec.profile
    c = cfg.n_chiplets
    t = torch.arange(spec.n_intervals, dtype=_F32)
    # Application phases: raised cosine keeps load non-negative and gives
    # the controller real transitions to track.
    offset = torch.rand((), generator=gen, dtype=_F32) * 6.28
    phase = 1.0 + 0.5 * torch.sin(2.0 * math.pi * t / prof.phase_period
                                  + offset)
    jitter = _lognormal_jitter(gen, (spec.n_intervals, c), prof.cv)
    # Mild static per-chiplet imbalance (placement effects).
    chip_w = 1.0 + 0.15 * torch.randn((c,), generator=gen, dtype=_F32)
    chip_w = torch.clamp(chip_w, 0.7, 1.3)
    ext = prof.mean_ext_load * phase[:, None] * jitter * chip_w[None, :]
    intra = ext * (1.0 - prof.ext_frac) / max(prof.ext_frac, 1e-6)
    return _package(ext, intra, prof.ext_frac, prof.mem_frac)


def _gen_uniform(spec: UniformSpec, gen: torch.Generator,
                 cfg: NetworkConfig) -> dict:
    ext = spec.mean_load * _lognormal_jitter(
        gen, (spec.n_intervals, cfg.n_chiplets), spec.cv)
    intra = ext * (1.0 - spec.ext_frac) / spec.ext_frac
    return _package(ext, intra, spec.ext_frac, spec.mem_frac)


def _gen_hotspot(spec: HotspotSpec, gen: torch.Generator,
                 cfg: NetworkConfig) -> dict:
    c = cfg.n_chiplets
    n_hot = min(spec.n_hotspots, c)
    perm = torch.randperm(c, generator=gen)
    jitter = _lognormal_jitter(gen, (spec.n_intervals, c), spec.cv)
    if n_hot >= c:                      # degenerate: everything is a hotspot
        w = torch.ones((c,), dtype=_F32)
    else:
        hot = torch.zeros((c,), dtype=_F32)
        hot[perm[:n_hot]] = 1.0
        w = (hot * (spec.hotspot_frac * c / n_hot)
             + (1.0 - hot) * ((1.0 - spec.hotspot_frac) * c / (c - n_hot)))
    ext = spec.mean_load * w[None, :] * jitter
    intra = ext * (1.0 - spec.ext_frac) / spec.ext_frac
    return _package(ext, intra, spec.ext_frac, spec.mem_frac)


def _gen_permutation(spec: PermutationSpec, gen: torch.Generator,
                     cfg: NetworkConfig) -> dict:
    c = cfg.n_chiplets
    dst = permutation_destinations(spec.pattern, c)
    self_paired = torch.as_tensor(dst == np.arange(c), dtype=_F32)
    jitter = _lognormal_jitter(gen, (spec.n_intervals, c), spec.cv)
    offered = (spec.mean_load / spec.ext_frac) * jitter   # total load/chiplet
    # Self-paired chiplets keep their whole load on the local mesh.
    ext = spec.ext_frac * offered * (1.0 - self_paired)[None, :]
    intra = offered - ext
    return _package(ext, intra, spec.ext_frac, spec.mem_frac)


def _gen_bursty(spec: BurstySpec, gen: torch.Generator,
                cfg: NetworkConfig) -> dict:
    c = cfg.n_chiplets
    duty = spec.duty
    on = torch.rand((c,), generator=gen, dtype=_F32) < duty  # stationary
    u = torch.rand((spec.n_intervals, c), generator=gen, dtype=_F32)
    states = []
    for u_t in u:
        on = torch.where(on, u_t >= spec.p_off, u_t < spec.p_on)
        states.append(on)
    on_load = spec.mean_load / duty               # calibrated: E[ext]=mean
    jitter = _lognormal_jitter(gen, (spec.n_intervals, c), spec.cv)
    ext = on_load * torch.stack(states).to(_F32) * jitter
    intra = ext * (1.0 - spec.ext_frac) / spec.ext_frac
    return _package(ext, intra, spec.ext_frac, spec.mem_frac)


_GENERATORS = {ParsecSpec: _gen_parsec, UniformSpec: _gen_uniform,
               HotspotSpec: _gen_hotspot, PermutationSpec: _gen_permutation,
               BurstySpec: _gen_bursty}


def _as_generator(generator) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator().manual_seed(int(generator))


def generate(spec, generator, cfg: NetworkConfig = NETWORK, *,
             dest: bool = False, device=None) -> dict:
    """Generate one trace from a spec (or PARSEC app name).

    `generator` is a CPU `torch.Generator` (advanced by the draws) or an
    int seed. `dest=True` attaches the spec's row-stochastic destination
    matrix. The trace lands on `device` (default: the card).
    """
    dev = resolve_device(device)
    spec = as_spec(spec)
    gen = _GENERATORS.get(type(spec))
    if gen is None:
        raise TypeError(f"no generator registered for "
                        f"{type(spec).__name__} (known: "
                        f"{sorted(c.__name__ for c in _GENERATORS)})")
    arrays = gen(spec, _as_generator(generator), cfg)
    out = {k: v.to(dev) for k, v in arrays.items()}
    out["app"] = spec.name
    if dest:
        from repro_torch.core.traffic.dest import destination_matrix_torch
        out["dest"] = destination_matrix_torch(spec, cfg, dev)
    return out


def generate_trace(app: str, n_intervals: int, generator,
                   cfg: NetworkConfig = NETWORK, *, device=None) -> dict:
    """One PARSEC application trace over `n_intervals` epochs (sugar for
    ``generate(ParsecSpec(app, n_intervals), generator, cfg)``)."""
    return generate(ParsecSpec(app=app, n_intervals=int(n_intervals)),
                    generator, cfg, device=device)


def all_app_traces(n_intervals: int, seed: int = 0,
                   cfg: NetworkConfig = NETWORK, *, dest: bool = False,
                   device=None) -> Dict[str, dict]:
    """Every PARSEC app, drawn in `APP_NAMES` order from one generator
    seeded with `seed`."""
    gen = torch.Generator().manual_seed(int(seed))
    return {name: generate(ParsecSpec(app=name,
                                      n_intervals=int(n_intervals)),
                           gen, cfg, dest=dest, device=device)
            for name in APP_NAMES}
