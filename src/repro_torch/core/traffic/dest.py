"""Spec-conditioned destination matrices: who sends to whom.

Port of `repro.core.traffic.dest`. ``dest[i, j]`` is the fraction of chiplet
i's inter-chiplet packets bound for chiplet j (row-stochastic [C, C]):

  * `UniformSpec` / `BurstySpec` / `HotspotSpec` — uniform over the C-1
    other chiplets;
  * `PermutationSpec` — one-hot rows onto the fixed partner chiplet
    (self-paired chiplets keep their one-hot on the diagonal);
  * `ParsecSpec` — ring-distance exponential decay with a locality scale
    derived from the profile's `ext_frac`, zero diagonal, row-normalized.

The numpy builder is a verbatim copy of the reference's (memoized per
(spec, cfg), read-only arrays); `destination_matrix_torch` is its memoized
tensor view.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core.constants import NETWORK, NetworkConfig
from repro_torch.core.traffic.specs import (ParsecSpec, PermutationSpec,
                                            TrafficSpec, as_spec,
                                            permutation_destinations)


def _uniform_offdiag(c: int) -> np.ndarray:
    if c <= 1:
        return np.ones((c, c), np.float32)
    d = np.full((c, c), 1.0 / (c - 1), np.float32)
    np.fill_diagonal(d, 0.0)
    return d


def _permutation_dest(spec: PermutationSpec, c: int) -> np.ndarray:
    dst = permutation_destinations(spec.pattern, c)
    d = np.zeros((c, c), np.float32)
    d[np.arange(c), dst] = 1.0
    return d


def _parsec_dest(spec: ParsecSpec, c: int) -> np.ndarray:
    if c <= 1:
        return np.ones((c, c), np.float32)
    # Ring distance on the chiplet index: adjacent chiplets are cheap to
    # reach, so low-ext_frac (locality-heavy) apps concentrate there while
    # interposer-bound apps spread nearly uniformly.
    i = np.arange(c)
    hops = np.abs(i[:, None] - i[None, :])
    hops = np.minimum(hops, c - hops)
    tau = 1.0 + 4.0 * spec.profile.ext_frac
    d = np.exp(-hops / tau).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return d / d.sum(axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _destination_matrix(spec: TrafficSpec, cfg: NetworkConfig) -> np.ndarray:
    c = cfg.n_chiplets
    if isinstance(spec, PermutationSpec):
        d = _permutation_dest(spec, c)
    elif isinstance(spec, ParsecSpec):
        d = _parsec_dest(spec, c)
    else:                       # Uniform / Hotspot / Bursty (see module doc)
        d = _uniform_offdiag(c)
    d.setflags(write=False)
    return d


def destination_matrix(spec, cfg: NetworkConfig = NETWORK) -> np.ndarray:
    """Row-stochastic destination distribution for a spec ([C, C], numpy).

    ``dest[i, j]`` is the fraction of chiplet i's inter-chiplet packets
    destined to chiplet j. Memoized per (spec, cfg); the returned array is
    read-only (shared across callers).
    """
    return _destination_matrix(as_spec(spec), cfg)


@functools.lru_cache(maxsize=None)
def _destination_matrix_torch(spec: TrafficSpec, cfg: NetworkConfig,
                              device: str) -> torch.Tensor:
    return torch.as_tensor(np.array(_destination_matrix(spec, cfg)),
                           device=device)


def destination_matrix_torch(spec, cfg: NetworkConfig = NETWORK,
                             device=None) -> torch.Tensor:
    """Tensor view of `destination_matrix`, memoized per (spec, cfg,
    device). Shared across callers: treat it as read-only. `device=None`
    means the card (see `backend.resolve_device`)."""
    return _destination_matrix_torch(as_spec(spec), cfg,
                                     str(resolve_device(device)))


def clear_destination_caches() -> None:
    """Drop both memoized views (wired into
    `simulator.clear_engine_caches`)."""
    _destination_matrix_torch.cache_clear()
    _destination_matrix.cache_clear()
