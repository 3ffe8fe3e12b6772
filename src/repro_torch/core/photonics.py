"""Photonic device models for the ReSiPI interposer, on tensors.

Port of `repro.core.photonics` (§3.2): the PCM-based directional coupler
(PCMC, Eqs. 1-3), the equal-power-share coupling-ratio schedule of the PCMC
chain (Eq. 4) and the laser power it divides, the microring-group device
count of Fig. 4, interposer power in the three modes of the compared
architectures, PCM reconfiguration energy, and the placement-derived
access-waveguide loss (design-time numpy, and its tensor twin for
placements that stay on the device).

Every tensor function takes the gateway chain on the LAST axis, so leading
axes are independent lanes. Eq. 4 note (as in the reference): kappa_i counts
*active* writers upstream of PCMC i, which gives exactly P_laser/GT at every
active writer for any activity pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.constants import (PHOTONIC_POWER, NETWORK,
                                        NetworkConfig, PhotonicPower)


def pcmc_coupling_ratio(cl_amorphous, cl_crystalline) -> torch.Tensor:
    """Eq. 1: kappa = CL_am / CL_cr, clipped to the physical [0, 1]
    range."""
    am = torch.as_tensor(cl_amorphous, dtype=torch.float32)
    cr = torch.as_tensor(cl_crystalline, dtype=torch.float32,
                         device=am.device)
    return torch.clamp(am / torch.clamp_min(cr, 1e-12), 0.0, 1.0)


def pcmc_split(p_in, kappa, insertion_loss_db: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eqs. 2-3: split input power into (cross, bar) outputs,
    P_C = kappa * P_I and P_B = (1 - kappa) * P_I, both arms times the
    insertion loss (0 dB, lossless, as the paper assumes)."""
    p = torch.as_tensor(p_in, dtype=torch.float32)
    k = torch.as_tensor(kappa, dtype=torch.float32, device=p.device)
    loss = 10.0 ** (-insertion_loss_db / 10.0)
    return k * p * loss, (1.0 - k) * p * loss


def kappa_schedule(active: torch.Tensor) -> torch.Tensor:
    """Eq. 4: coupling ratios for the N-1 PCMC chain given activity [..., N].

    kappa[i] = 1/(GT - a_i) if gateway i is active (a_i = active gateways
    upstream of i), else 0. Returns [..., N-1].
    """
    active = active.to(torch.float32)
    gt = torch.sum(active, dim=-1, keepdim=True)
    upstream = torch.cumsum(active, dim=-1) - active
    denom = torch.clamp_min(gt - upstream, 1.0)
    return torch.where(active[..., :-1] > 0, 1.0 / denom[..., :-1],
                       torch.zeros_like(denom[..., :-1]))


def power_division(active: torch.Tensor, laser_power_mw) -> torch.Tensor:
    """Laser power down the PCMC chain (Fig. 4 wiring), per gateway
    [..., N]: each PCMC taps its cross arm and passes its bar arm on; the
    last gateway takes what remains. With Eq. 4's ratios every active
    gateway receives laser_power_mw / GT and idle ones 0 (the PCM power
    gating of §3.2)."""
    kappa = kappa_schedule(active)
    p_bar = torch.as_tensor(laser_power_mw, dtype=torch.float32,
                            device=kappa.device)
    p_bar = torch.broadcast_to(p_bar, kappa.shape[:-1])
    taps = []
    for i in range(kappa.shape[-1]):
        p_cross, p_bar = pcmc_split(p_bar, kappa[..., i])
        taps.append(p_cross)
    received = torch.stack(taps + [p_bar], dim=-1)
    # With Eq. 4 the upstream taps exhaust the laser when the last gateway
    # is idle; guard numerically, as the reference does.
    return torch.where(active > 0, received, torch.zeros_like(received))


def gateway_access_loss_db(gw_pos: np.ndarray,
                           cfg: NetworkConfig = NETWORK,
                           power: PhotonicPower = PHOTONIC_POWER
                           ) -> np.ndarray:
    """Per-gateway optical access loss implied by where the gateway sits.

    Distance (hops) from the gateway's router to the nearest chiplet edge x
    router pitch x waveguide dB/mm. Edge-placed gateways pay 0 dB. Returns
    [G] float32 dB values (design-time numpy, a verbatim copy).
    """
    from repro_torch.core import topology

    pos = np.asarray(gw_pos, np.int32).reshape(-1, 2)
    if cfg.coords is None:
        edge_hops = np.minimum.reduce([
            pos[:, 0], cfg.mesh_x - 1 - pos[:, 0],
            pos[:, 1], cfg.mesh_y - 1 - pos[:, 1]])
    else:
        edge_hops = topology.edge_lut(cfg)[pos[:, 0], pos[:, 1]]
    return (edge_hops * cfg.router_pitch_mm
            * power.waveguide_db_per_mm).astype(np.float32)


def gateway_access_loss_db_torch(gw_pos: torch.Tensor,
                                 cfg: NetworkConfig = NETWORK,
                                 power: PhotonicPower = PHOTONIC_POWER
                                 ) -> torch.Tensor:
    """Tensor twin of `gateway_access_loss_db` for placements [..., G, 2]
    (the reference's `gateway_access_loss_db_jnp`): the same distance to
    the nearest edge (the closed form on a derived mesh, the `edge` gather
    table on an explicit layout) times the float32 constant router pitch x
    waveguide dB/mm. Returns float32 [..., G] on the placements' device."""
    from repro_torch.core import topology

    pos = gw_pos.long()
    x, y = pos[..., 0], pos[..., 1]
    if cfg.coords is None:
        edge_hops = torch.minimum(
            torch.minimum(x, cfg.mesh_x - 1 - x),
            torch.minimum(y, cfg.mesh_y - 1 - y))
    else:
        edge_hops = topology.lut_tensors(cfg, pos.device)["edge"][x, y]
    return edge_hops.to(torch.float32) * float(
        np.float32(cfg.router_pitch_mm * power.waveguide_db_per_mm))


# MRG accounting (Fig. 4), N gateways and W wavelengths: each MRG holds one
# modulator row (W MRs) and N - 1 filter rows (W MRs each); the system has
# N - 1 PCMCs.

@dataclasses.dataclass(frozen=True)
class InterposerGeometry:
    n_gateways: int
    wavelengths: int

    @property
    def mrgs(self) -> int:
        return self.n_gateways

    @property
    def pcmcs(self) -> int:
        return self.n_gateways - 1

    @property
    def modulators_per_mrg(self) -> int:
        return self.wavelengths

    @property
    def filters_per_mrg(self) -> int:
        return (self.n_gateways - 1) * self.wavelengths

    @property
    def total_mrs(self) -> int:
        return self.mrgs * (self.modulators_per_mrg + self.filters_per_mrg)


def interposer_power_mw(active: torch.Tensor, wavelengths, *,
                        n_gateways: int,
                        power: PhotonicPower = PHOTONIC_POWER,
                        loss_db=0.0, mode: str = "pcm",
                        gateway_count=None, n_chiplets=None) -> dict:
    """Total photonic interposer power for a given activity state.

    Args:
      active: [..., N] bool — active gateways (writers+readers co-gated).
      wavelengths: scalar, [...] per lane, or [..., N] per gateway.
      n_gateways: static N (chain length).
      loss_db: optical path loss ([...] per lane or scalar); laser power is
        scaled by 10^(loss/10).
      mode: "pcm" (ReSiPI: everything follows the PCM activity mask),
        "wdm" (PROWAVES: every provisioned gateway stays lit, per-gateway
        wavelength counts) or "static" (AWGR: everything always on).
      gateway_count: the actual gateway count ([...] per lane) when the
        chain is padded for a topology sweep: it replaces `n_gateways` in
        the count-dependent "static" terms, so padded slots add nothing.
      n_chiplets: chiplet count for the Table 2 controller term, an int or
        a [...] per-lane tensor (default: the Table 1 system).

    Returns a dict of [...] tensors: laser/tia/tuning/driver/controller/
    total mW.
    """
    active_f = active.to(torch.float32)
    w = torch.as_tensor(wavelengths, dtype=torch.float32,
                        device=active.device)
    if w.dim() < active_f.dim():
        w = w.unsqueeze(-1)
    w = torch.broadcast_to(w, active_f.shape)
    # x * 0.1 for x / 10: the reference's compiled arithmetic.
    loss_scale = 10.0 ** (torch.as_tensor(loss_db, dtype=torch.float32,
                                          device=active.device) * 0.1)
    gw_n = float(n_gateways) if gateway_count is None else \
        torch.as_tensor(gateway_count, dtype=torch.float32,
                        device=active.device)

    if mode == "pcm":
        lit_w = torch.sum(active_f * w, dim=-1)
        laser = lit_w * power.laser_mw_per_wavelength
        mods = lit_w
        filters = lit_w
    elif mode == "wdm":
        lit_w = torch.sum(w, dim=-1)
        laser = lit_w * power.laser_mw_per_wavelength
        mods = lit_w
        filters = lit_w
    elif mode == "static":
        lit_w = torch.sum(w, dim=-1)
        laser = lit_w * power.laser_mw_per_wavelength
        mods = lit_w
        filters = torch.full_like(lit_w, np.float32(gw_n * gw_n)) \
            if gateway_count is None else gw_n * gw_n
    else:
        raise ValueError(f"unknown power mode: {mode}")

    if mode != "static":
        tia = filters
    else:
        tia = torch.full_like(lit_w, gw_n) if gateway_count is None \
            else gw_n
    tia = tia * power.tia_mw
    tuning = (mods + filters) * power.tuning_mw_per_mr
    driver = mods * power.driver_mw

    laser = laser * loss_scale
    controller = controller_mw(
        NETWORK.n_chiplets if n_chiplets is None else n_chiplets, power)
    total = laser + tia + tuning + driver + controller
    return {"laser_mw": laser, "tia_mw": tia, "tuning_mw": tuning,
            "driver_mw": driver,
            "controller_mw": torch.broadcast_to(
                torch.as_tensor(controller, dtype=torch.float32,
                                device=total.device), total.shape),
            "total_mw": total}


def controller_mw(n_chiplets, power: PhotonicPower = PHOTONIC_POWER):
    """The Table 2 controller term (172 uW per chiplet plus the interposer
    controller) in mW: a Python float for an int chiplet count, float32
    per lane for a tensor of counts (padded topology sweeps)."""
    if isinstance(n_chiplets, torch.Tensor):
        n_chiplets = n_chiplets.to(torch.float32)
    return (power.controller_lgc_uw * n_chiplets
            + power.controller_inc_uw) / 1000.0


def reconfig_energy_nj(prev_active: torch.Tensor, new_active: torch.Tensor,
                       power: PhotonicPower = PHOTONIC_POWER
                       ) -> torch.Tensor:
    """PCM reconfiguration energy for one epoch boundary ([...] per lane).

    Every PCMC whose kappa changes pays one ~2 nJ PCM state transition;
    the non-volatile steady state costs nothing.
    """
    k_prev = kappa_schedule(prev_active)
    k_new = kappa_schedule(new_active)
    switched = torch.sum((torch.abs(k_new - k_prev) > 1e-6)
                         .to(torch.float32), dim=-1)
    return switched * power.pcmc_reconfig_nj
