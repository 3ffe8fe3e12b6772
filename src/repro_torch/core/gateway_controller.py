"""ReSiPI dynamic gateway management (§3.3, Fig. 6-7) on tensors.

Port of `repro.core.gateway_controller`. The epoch controller measures the
mean per-gateway load of each chiplet over a reconfiguration interval
(Eq. 5) and applies hysteresis thresholds:

    activate   when L_c >  T_P_g = L_m                 (Eq. 6)
    deactivate when L_c <  T_N_g = L_m * (1 - 1/g)     (Eq. 7, from Eqs. 8-10)

Every function broadcasts over leading axes, so one call updates a whole
batch of lanes. `ControllerConfig` fields may hold tensors (per-lane sweep
knobs shaped to broadcast against `g`) as well as Python numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core.constants import NETWORK, PAPER_L_M, NetworkConfig


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    l_m: float = PAPER_L_M        # maximum allowable per-gateway load (§4.2)
    max_gateways: int = 4         # G: per-chiplet maximum
    min_gateways: int = 1


def activation_order(positions, cfg: NetworkConfig = NETWORK) -> np.ndarray:
    """Controller activation order for an arbitrary gateway placement.

    Level 1 gets the position closest to the mesh center (fewest mean hops);
    each further level greedily maximizes its minimum distance to the
    already-activated set (ties: centrality, then original row index).
    Returns a permutation of row indices (design-time numpy, a verbatim copy
    of the reference).
    """
    from repro_torch.core import topology

    pos = np.asarray(positions, np.int64).reshape(-1, 2)
    n = len(pos)
    if cfg.coords is None:
        center = np.array([(cfg.mesh_x - 1) / 2.0, (cfg.mesh_y - 1) / 2.0])
        centrality = np.abs(pos - center).sum(axis=1)
        pair = np.abs(pos[:, None, :] - pos[None, :, :]).sum(axis=-1)
    else:
        centrality = topology.centrality_lut(cfg)[pos[:, 0], pos[:, 1]]
        pair = topology.pair_hops(cfg, pos[:, None, :], pos[None, :, :])
    order = [int(np.lexsort((np.arange(n), centrality))[0])]
    remaining = [i for i in range(n) if i != order[0]]
    while remaining:
        dmin = [min(pair[i, j] for j in order) for i in remaining]
        best = np.lexsort((remaining, [centrality[i] for i in remaining],
                           [-d for d in dmin]))[0]
        order.append(remaining.pop(int(best)))
    return np.asarray(order, np.int64)


def activation_order_torch(positions: torch.Tensor,
                           cfg: NetworkConfig = NETWORK) -> torch.Tensor:
    """Tensor twin of `activation_order` for placements [..., G, 2] (the
    reference's `activation_order_jnp`), batched over leading axes: the
    same greedy spread rule as an argmin over integer composite keys
    (-min distance to the activated set, then centrality, then row index),
    so it never leaves the device. `argmin` takes the first minimum, as
    jax's does. Returns int64 [..., G] row permutations, equal to the
    numpy rule's."""
    from repro_torch.core import topology

    pos = positions.long()
    n = int(pos.shape[-2])
    x, y = pos[..., 0], pos[..., 1]
    idx = torch.arange(n, device=pos.device)
    if cfg.coords is None:
        # 2x the numpy rule's float centrality: integer, identical order.
        cent2 = (torch.abs(2 * x - (cfg.mesh_x - 1))
                 + torch.abs(2 * y - (cfg.mesh_y - 1)))
        pair = torch.sum(torch.abs(pos[..., :, None, :]
                                   - pos[..., None, :, :]), dim=-1)
        big = 4 * (cfg.mesh_x + cfg.mesh_y)
    else:
        # Explicit layout: medoid centrality and BFS pair hops, gathered.
        lut = topology.lut_tensors(cfg, pos.device)
        cent2 = lut["centrality"][x, y]
        rid = lut["router_index"][x, y]
        pair = lut["hop"][rid[..., :, None], x[..., None, :],
                          y[..., None, :]]
        big = topology.max_hops(cfg) + 1
    # Composite keys: b bounds the row index, a bounds (centrality, index).
    b = n
    a = topology.centrality_bound(cfg) * b
    taken = int(np.iinfo(np.int32).max)
    first = torch.argmin(cent2 * b + idx, dim=-1)
    order = [first]
    selected = idx == first[..., None]
    for _ in range(1, n):
        dmin = torch.amin(torch.where(selected[..., None, :], pair, big),
                          dim=-1)
        key = torch.where(selected, taken, -dmin * a + cent2 * b + idx)
        nxt = torch.argmin(key, dim=-1)
        order.append(nxt)
        selected = selected | (idx == nxt[..., None])
    return torch.stack(order, dim=-1)


def t_p(cfg: ControllerConfig) -> torch.Tensor:
    """Eq. 6: activation threshold — constant L_m for every g."""
    return torch.as_tensor(cfg.l_m, dtype=torch.float32)


def t_n(g: torch.Tensor, cfg: ControllerConfig) -> torch.Tensor:
    """Eq. 7: deactivation threshold L_m * (1 - 1/g)."""
    g = torch.clamp_min(g.to(torch.float32), 1.0)
    return cfg.l_m * (1.0 - 1.0 / g)


def average_gateway_load(packets: torch.Tensor, interval_cycles,
                         g: torch.Tensor) -> torch.Tensor:
    """Eq. 5: L_c^i = (1/g_c) * sum_j P_j / T_i."""
    g = torch.clamp_min(g.to(torch.float32), 1.0)
    return packets / (interval_cycles * g)


def update_gateways(g: torch.Tensor, load: torch.Tensor,
                    cfg: ControllerConfig) -> torch.Tensor:
    """One controller decision (Fig. 6): g -> g+1, g-1 or g."""
    g = g.to(torch.int32)
    inc = (load > t_p(cfg).to(load.device)) & (g < cfg.max_gateways)
    dec = (load < t_n(g, cfg)) & (g > cfg.min_gateways)
    return torch.where(inc, g + 1, torch.where(dec, g - 1, g))


@dataclasses.dataclass(frozen=True)
class ControllerState:
    """Carried across reconfiguration intervals (one per chiplet).

    Batched states carry leading lane axes: g [..., C], packets_seen
    [..., C], epoch [...].
    """
    g: torch.Tensor               # int32 — active gateways
    packets_seen: torch.Tensor    # float32 — accumulator
    epoch: torch.Tensor           # int32

    @staticmethod
    def init(n_chiplets: int, cfg: ControllerConfig,
             device=None) -> "ControllerState":
        # §3.3: "initially set to the maximum allowed". `device=None`
        # means the card (see `backend.resolve_device`).
        device = resolve_device(device)
        return ControllerState(
            g=torch.full((n_chiplets,), int(cfg.max_gateways),
                         dtype=torch.int32, device=device),
            packets_seen=torch.zeros((n_chiplets,), dtype=torch.float32,
                                     device=device),
            epoch=torch.zeros((), dtype=torch.int32, device=device))


def epoch_step(state: ControllerState, packets_this_interval: torch.Tensor,
               interval_cycles: float, cfg: ControllerConfig
               ) -> Tuple[ControllerState, dict]:
    """Run one reconfiguration-interval update (Fig. 7 flow).

    Returns the new state plus a record dict: per-chiplet g before/after,
    the measured loads, and the gateway total GT (summed over the last axis).
    """
    load = average_gateway_load(packets_this_interval,
                                float(np.float32(interval_cycles)), state.g)
    g_new = update_gateways(state.g, load, cfg)
    record = {
        "g_before": state.g,
        "g_after": g_new,
        "load": load,
        "gt": torch.sum(g_new, dim=-1, dtype=torch.int32),
        "changed": torch.sum(torch.abs(g_new - state.g), dim=-1,
                             dtype=torch.int32),
    }
    new_state = ControllerState(g=g_new,
                                packets_seen=torch.zeros_like(
                                    state.packets_seen),
                                epoch=state.epoch + 1)
    return new_state, record


def scan_controller(loads_per_interval, cfg: ControllerConfig,
                    interval_cycles: float, *, device=None) -> dict:
    """Replay the controller over a [T, C] load trace, one `epoch_step` per
    interval; returns its records stacked over T.

    `loads_per_interval` is the would-be load per single gateway if exactly
    one gateway were active (total packets / interval); Eq. 5 rescales by
    the live g each epoch. A tensor stays on its device; anything else goes
    to `device` (None means the card).
    """
    if isinstance(loads_per_interval, torch.Tensor):
        loads = loads_per_interval.to(torch.float32)
    else:
        loads = torch.as_tensor(np.asarray(loads_per_interval, np.float32),
                                device=resolve_device(device))
    state = ControllerState.init(int(loads.shape[1]), cfg, loads.device)
    cycles = float(np.float32(interval_cycles))
    recs = []
    for total_load in loads:
        state, rec = epoch_step(state, total_load * cycles, interval_cycles,
                                cfg)
        recs.append(rec)
    return {k: torch.stack([r[k] for r in recs]) for k in recs[0]}
