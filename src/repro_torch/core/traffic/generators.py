"""Trace generation: spec + threefry key -> trace dict.

Port of `repro.core.traffic.generators`. A trace is a dict over
reconfiguration intervals:
  ext_load   [T, C] — inter-chiplet packet injection per chiplet (pkts/cycle)
  mem_load   [T]    — traffic to the memory-controller gateways (pkts/cycle)
  int_load   [T, C] — intra-chiplet-only traffic (pkts/cycle per chiplet)
  ext_frac   []     — fraction of packets that cross the interposer
  app        str    — workload label (the spec's `name`)

`generate(spec, key, cfg)` takes a key of the threefry twin
(`repro_torch.random.prng_key(seed)`, or a key carried over from jax with
`interop.key_from_jax`) and makes the reference's trace from the same key:
the same splits and draws (`uniform`, `normal`, `permutation`, all bit for
bit the reference's), then the same float32 arithmetic as the reference's
compiled generator. That program is not the Python source literally: XLA
folds chains of constant factors left to right in float32 (`x * a / b` is
`x * f32(f32(a) * f32(1 / b))`, `0.15 * normal` is `erf_inv(u) *
f32(0.15 * sqrt(2))`), fuses a multiply into the add that consumes it (one
rounding), and sums `mem_load` over chiplets in index order, fusing each
term's last product into the running sum up to 32 chiplets (a tree of
32-wide windows past that; `repro_torch.random.xla_row_sum`). The
generators below write those forms out (`repro_torch.random.fma`, `_fold`,
`_mem_load`). The one remaining difference is `sin` in the PARSEC phase
(libm's `sinf` there, float64 `sin` rounded here): it moves a few elements
by an ulp.

Draws run on the key's device; the finished trace moves to `device`.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.backend import resolve_device
from repro_torch.core.constants import NETWORK, NetworkConfig
from repro_torch.core.traffic.specs import (APP_NAMES, BurstySpec,
                                            HotspotSpec, ParsecSpec,
                                            PermutationSpec, UniformSpec,
                                            as_spec,
                                            permutation_destinations)

_F32 = torch.float32


def _c(v: float) -> float:
    """A Python float as the reference's weakly typed float32 constant."""
    return float(np.float32(v))


def _fold(*factors: float) -> float:
    """Constant factors multiplied left to right in float32, as XLA folds a
    chain `x * a * b ...` into `x * (a * b ...)`."""
    acc = np.float32(factors[0])
    for f in factors[1:]:
        acc = np.float32(acc * np.float32(f))
    return float(acc)


def _recip(v: float) -> float:
    """float32 1 / v: XLA divides by a constant as a multiply by this."""
    return float(np.float32(1.0) / np.float32(v))


def _sigma_consts(cv: float):
    """(sqrt(2) sigma, -sigma^2 / 2) of the unit-mean lognormal, sigma =
    sqrt(log1p(cv^2)), folded to float32 as the reference's program holds
    them."""
    sig = np.float32(np.sqrt(np.float64(np.float32(
        np.log1p(np.float64(np.float32(cv * cv)))))))
    return (float(np.float32(np.float32(trandom.SQRT2_F32) * sig)),
            float(-np.float32(np.float32(0.5) * np.float32(sig * sig))))


def _lognormal_jitter(key: torch.Tensor, shape, cv: float) -> torch.Tensor:
    """Unit-mean lognormal multiplicative jitter with coefficient cv:
    exp(normal * sigma - sigma^2 / 2)."""
    if cv <= 0.0:
        return torch.ones(shape, dtype=_F32, device=key.device)
    k1, k2 = _sigma_consts(cv)
    return trandom.xla_exp(trandom.fma(trandom.normal_erf_inv(key, shape),
                                       k1, k2))


def _mem_load(a: torch.Tensor, b, mem_frac: float, *, fused: bool = True,
              vectorized: bool = False) -> torch.Tensor:
    """mem_frac * sum over chiplets of ext = a * b [T, C] (a, b [T, C] or
    [C] tensors, or b a scalar) in XLA's CPU order
    (`random.xla_row_sum`); `fused`: up to 32 chiplets each product is
    fused into the running sum, else rounded first; `vectorized`: b (or
    a) is a per-chiplet vector the reference's fusion computes."""
    if not fused:
        return trandom.xla_row_sum(a * b) * _c(mem_frac)
    return trandom.xla_row_sum(a, b, vectorized=vectorized) * _c(mem_frac)


def _package(ext: torch.Tensor, mem: torch.Tensor, intra: torch.Tensor,
             ext_frac: float) -> dict:
    return {"ext_load": ext, "mem_load": mem, "int_load": intra,
            "ext_frac": torch.tensor(ext_frac, dtype=_F32,
                                     device=ext.device)}


def _intra(ext: torch.Tensor, ext_frac: float, denom: float) -> torch.Tensor:
    """ext * (1 - ext_frac) / denom, its two factors folded."""
    ratio = _fold(1.0 - ext_frac, _recip(denom))
    return ext if ratio == 1.0 else ext * ratio


def _gen_parsec(spec: ParsecSpec, key: torch.Tensor,
                cfg: NetworkConfig) -> dict:
    """The calibrated PARSEC-like generator: slow raised-cosine phase,
    lognormal jitter and a static per-chiplet weight."""
    prof = spec.profile
    c = cfg.n_chiplets
    k_phase, k_jit, k_chip = trandom.split(key, 3).unbind(-2)
    t = torch.arange(spec.n_intervals, dtype=_F32, device=key.device)
    # Application phases: raised cosine keeps load non-negative and gives
    # the controller real transitions to track.
    offset = trandom.uniform(k_phase, ()) * _c(6.28)
    arg = trandom.fma(t, _fold(2.0 * math.pi, _recip(prof.phase_period)),
                      offset)
    phase = trandom.sin(arg) * 0.5 + 1.0
    jitter = _lognormal_jitter(k_jit, (spec.n_intervals, c), prof.cv)
    # Mild static per-chiplet imbalance (placement effects).
    chip_w = trandom.fma(trandom.normal_erf_inv(k_chip, (c,)),
                         _fold(0.15, trandom.SQRT2_F32), 1.0)
    chip_w = torch.clamp(chip_w, _c(0.7), _c(1.3))
    a = (phase * _c(prof.mean_ext_load))[:, None] * jitter
    ext = a * chip_w[None, :]
    intra = _intra(ext, prof.ext_frac, max(prof.ext_frac, 1e-6))
    return _package(ext, _mem_load(a, chip_w, prof.mem_frac,
                                   vectorized=True), intra, prof.ext_frac)


def _gen_uniform(spec: UniformSpec, key: torch.Tensor,
                 cfg: NetworkConfig) -> dict:
    jitter = _lognormal_jitter(key, (spec.n_intervals, cfg.n_chiplets),
                               spec.cv)
    load = _c(spec.mean_load)
    intra = jitter * _fold(spec.mean_load, 1.0 - spec.ext_frac,
                           _recip(spec.ext_frac))
    return _package(jitter * load, _mem_load(jitter, load, spec.mem_frac),
                    intra, spec.ext_frac)


def _gen_hotspot(spec: HotspotSpec, key: torch.Tensor,
                 cfg: NetworkConfig) -> dict:
    c = cfg.n_chiplets
    n_hot = min(spec.n_hotspots, c)
    k_pick, k_jit = trandom.split(key, 2).unbind(-2)
    jitter = _lognormal_jitter(k_jit, (spec.n_intervals, c), spec.cv)
    if n_hot >= c:                      # degenerate: everything is a hotspot
        w = torch.ones((c,), dtype=_F32, device=key.device)
    else:
        # Unit-mean spatial weights: the hotspot set carries hotspot_frac of
        # the total offered load, the rest share the remainder evenly.
        hot = torch.zeros((c,), dtype=_F32, device=key.device)
        hot[trandom.permutation(k_pick, c)[:n_hot]] = 1.0
        w = (hot * _c(spec.hotspot_frac * c / n_hot)
             + (1.0 - hot) * _c((1.0 - spec.hotspot_frac) * c / (c - n_hot)))
    a = w * _c(spec.mean_load)
    ext = a[None, :] * jitter
    intra = _intra(ext, spec.ext_frac, spec.ext_frac)
    return _package(ext, _mem_load(a, jitter, spec.mem_frac,
                                   vectorized=n_hot < c), intra,
                    spec.ext_frac)


def _gen_permutation(spec: PermutationSpec, key: torch.Tensor,
                     cfg: NetworkConfig) -> dict:
    c = cfg.n_chiplets
    dst = permutation_destinations(spec.pattern, c)
    keep = torch.as_tensor(dst != np.arange(c), dtype=_F32,
                           device=key.device)
    jitter = _lognormal_jitter(key, (spec.n_intervals, c), spec.cv)
    per_load = _c(spec.mean_load / spec.ext_frac)  # total load / chiplet
    # Self-paired chiplets keep their whole load on the local mesh; the rest
    # split ext_frac : 1 - ext_frac between interposer and mesh.
    ext_w = keep * _fold(per_load, spec.ext_frac)
    ext = jitter * ext_w[None, :]
    intra = trandom.fma(jitter, per_load, -ext)
    # A weight vector that is not one constant keeps its product rounded.
    uniform_w = bool((keep != 0).all())
    return _package(ext, _mem_load(jitter, ext_w, spec.mem_frac,
                                   fused=uniform_w), intra, spec.ext_frac)


def _gen_bursty(spec: BurstySpec, key: torch.Tensor,
                cfg: NetworkConfig) -> dict:
    c = cfg.n_chiplets
    k0, k_chain, k_jit = trandom.split(key, 3).unbind(-2)
    on = trandom.uniform(k0, (c,)) < _c(spec.duty)   # stationary start
    u = trandom.uniform(k_chain, (spec.n_intervals, c))
    states = []
    for u_t in u:
        on = torch.where(on, u_t >= _c(spec.p_off), u_t < _c(spec.p_on))
        states.append(on)
    # ON-state load calibrated so that E[ext] = mean_load.
    a = torch.stack(states).to(_F32) * _c(spec.mean_load / spec.duty)
    jitter = _lognormal_jitter(k_jit, (spec.n_intervals, c), spec.cv)
    ext = a * jitter
    intra = _intra(ext, spec.ext_frac, spec.ext_frac)
    return _package(ext, _mem_load(a, jitter, spec.mem_frac, fused=False),
                    intra, spec.ext_frac)


_GENERATORS = {ParsecSpec: _gen_parsec, UniformSpec: _gen_uniform,
               HotspotSpec: _gen_hotspot, PermutationSpec: _gen_permutation,
               BurstySpec: _gen_bursty}


def _as_key(key, device: torch.device) -> torch.Tensor:
    """A twin key on `device`: a key tensor [2] as it is, an int a seed
    (`prng_key(seed)`)."""
    if isinstance(key, torch.Tensor):
        if key.shape != (2,):
            raise ValueError(f"generate() takes one threefry key [2], got "
                             f"shape {tuple(key.shape)}")
        return key.to(device)
    if isinstance(key, (int, np.integer)):
        return trandom.prng_key(int(key), device=device)
    raise TypeError(f"expected a threefry key tensor or an int seed, got "
                    f"{type(key).__name__}")


def generate(spec, key, cfg: NetworkConfig = NETWORK, *,
             dest: bool = False, device=None) -> dict:
    """Generate one trace from a spec (or PARSEC app name) and a threefry
    key (`random.prng_key(seed)`; an int is taken as the seed), the
    reference's trace for the same key. `dest=True` attaches the spec's
    row-stochastic destination matrix. Draws and trace run on `device`
    (default: the card)."""
    dev = resolve_device(device)
    spec = as_spec(spec)
    gen = _GENERATORS.get(type(spec))
    if gen is None:
        raise TypeError(f"no generator registered for "
                        f"{type(spec).__name__} (known: "
                        f"{sorted(c.__name__ for c in _GENERATORS)})")
    out = dict(gen(spec, _as_key(key, dev), cfg))
    out["app"] = spec.name
    if dest:
        from repro_torch.core.traffic.dest import destination_matrix_torch
        out["dest"] = destination_matrix_torch(spec, cfg, dev)
    return out


def generate_trace(app: str, n_intervals: int, key,
                   cfg: NetworkConfig = NETWORK, *, device=None) -> dict:
    """One PARSEC application trace over `n_intervals` epochs (sugar for
    ``generate(ParsecSpec(app, n_intervals), key, cfg)``)."""
    return generate(ParsecSpec(app=app, n_intervals=int(n_intervals)),
                    key, cfg, device=device)


def all_app_traces(n_intervals: int, seed: int = 0,
                   cfg: NetworkConfig = NETWORK, *, dest: bool = False,
                   device=None) -> Dict[str, dict]:
    """Every PARSEC app in `APP_NAMES` order, app i from key i of
    `split(prng_key(seed), 8)`, as the reference draws them."""
    dev = resolve_device(device)
    keys = trandom.split(trandom.prng_key(seed, device=dev), len(APP_NAMES))
    return {name: generate(ParsecSpec(app=name,
                                      n_intervals=int(n_intervals)),
                           keys[i], cfg, dest=dest, device=dev)
            for i, name in enumerate(APP_NAMES)}
