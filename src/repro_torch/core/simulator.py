"""Epoch-level 2.5D network simulator (Level 1), batched over lanes.

Port of `repro.core.simulator`. It simulates the four
compared interposer architectures (§4.1) over a traffic trace, one step per
reconfiguration interval:

  * RESIPI      — dynamic gateways (Eqs. 5-7), 4 wavelengths, PCM gating
  * RESIPI_ALL  — ReSiPI datapath with all gateways always active (Fig. 11)
  * PROWAVES    — 1 gateway/chiplet, dynamic wavelength count [16]
  * AWGR        — 4 gateways/chiplet static, 1 wavelength/port, 1.8 dB loss

Each step: traffic -> per-gateway load (selection tables) -> latency
(`noc.NocModel`) -> power (`photonics.interposer_power_mw`) -> controller.
Energy is power x mean packet latency (the reference's energy proxy).

Batching replaces `vmap` with one explicit lane axis B. Traces stack as
[N, T, C]; `lane_trace[B]` says which trace each lane reads; the runtime
knobs of `SWEEPABLE_FIELDS` become per-lane [B] tensors. `simulate` is one
lane, `simulate_batch` N lanes, `sweep` K lanes over one trace and
`sweep_batch` N*K lanes (reshaped to [N, K, ...] on return).

The interval loop runs in `_scan_trace`: RESIPI / RESIPI_ALL runs with at
least one memory gateway go to `kernels.epoch_step.ops.epoch_run` — the hand-written CUDA kernel on
CUDA tensors, its plain PyTorch version on CPU tensors. PROWAVES and AWGR run
the plain loop `_loop` on either device, as the reference's gate sends them
to its scan body. Entry points run on the card unless `device="cpu"`.

Like the reference, `sweep` and `sweep_batch` read no fault frames; fault
frames ride `simulate` and `simulate_batch`, and `sweep_faults` runs K
frames over one trace as K lanes.

Padded sweeps: `sweep_topology` / `sweep_topology_batch` / `shard_sweep`
(one device), `sweep_workload` and `sweep_placement` run K topologies
(chiplet counts, gateway slots, mesh radix, placements) as lanes padded to
the grid maxima, each lane carrying its own topology (`lane_topology`); one
`epoch_step` launch on the card for RESIPI / RESIPI_ALL, where the
reference runs its scan body. `search_placement(engine="host")` scores one
generation per `sweep_placement` call; the default `engine="device"`
(`core/search.py`) builds and scores every generation on the device,
through `placement_scoring` / `score_placement_tables` (one launch a
generation, every chain's candidates as its lanes).

Streaming: `SimSession` steps a carried `SimState` through trace chunks
(`step_chunk`, `swap_placement`, `summary`) and `session_tick` advances B
packed sessions one chunk as B lanes of one interval loop (one kernel
launch on the card), with one fault frame shared by every lane. A chunked
run gives the records of a one-shot `simulate` of the concatenated trace
bit for bit, and lane k of a tick those of a standalone session: every
per-lane total is summed in a fixed pairwise order over the intervals,
whatever the lane count or the device. The carry is never updated in
place, so a caller may keep an old one to roll back to.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch.core import photonics, topology, traffic
from repro_torch.core.traffic.transform import (pad_checked,
                                                renormalize_rows,
                                                stack_checked)
from repro_torch.core.constants import (NETWORK, PHOTONIC_POWER,
                                        PROWAVES_MAX_WAVELENGTHS,
                                        PROWAVES_MIN_WAVELENGTHS,
                                        RESIPI_WAVELENGTHS, NetworkConfig)
from repro_torch.core.gateway_controller import (ControllerConfig,
                                                 ControllerState, epoch_step)
from repro_torch.core.noc import NocModel, uniform_mesh_mean_hops
from repro_torch.core.selection import (N_DEFAULT_EDGE_SLOTS, TABLE_STATS,
                                        build_selection_tables,
                                        mean_access_hops, normalize_placement,
                                        padded_selection_tables_torch,
                                        resolve_gateway_positions,
                                        selection_tables_torch)

_F32 = torch.float32
_I32 = torch.int32

# The fault-frame keys a trace may carry (the reference's
# `repro.core.faults.FAULT_KEYS`): gw_ok [T, C, G], stuck_on [T, C, G],
# drift_db [T].
FAULT_KEYS = ("gw_ok", "stuck_on", "drift_db")


class Arch(enum.Enum):
    RESIPI = "resipi"
    RESIPI_ALL = "resipi_all"
    PROWAVES = "prowaves"
    AWGR = "awgr"


KERNEL_ARCHS = (Arch.RESIPI, Arch.RESIPI_ALL)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    arch: Arch = Arch.RESIPI
    cfg: NetworkConfig = NETWORK
    ctl: ControllerConfig = ControllerConfig()
    noc: NocModel = NocModel()
    wavelengths: int = RESIPI_WAVELENGTHS
    # PROWAVES wavelength controller: multiplicative increase/decrease with
    # utilization hysteresis (reactive approximation of [16]'s policy).
    prowaves_rho_hi: float = 0.5
    prowaves_rho_lo: float = 0.30

    def with_arch(self, arch: Arch) -> "SimConfig":
        w = {Arch.RESIPI: RESIPI_WAVELENGTHS,
             Arch.RESIPI_ALL: RESIPI_WAVELENGTHS,
             Arch.PROWAVES: PROWAVES_MAX_WAVELENGTHS,
             Arch.AWGR: 1}[arch]
        # PROWAVES ships 32-flit gateway buffers (4x ReSiPI, Table 1).
        noc = dataclasses.replace(self.noc,
                                  buffer_sat=0.65 if arch == Arch.PROWAVES
                                  else self.noc.buffer_sat)
        return dataclasses.replace(self, arch=arch, wavelengths=w, noc=noc)


@dataclasses.dataclass(frozen=True)
class SimState:
    """Simulation carry of B lanes."""
    ctl: ControllerState          # g [B, C], packets_seen [B, C], epoch [B]
    wavelengths: torch.Tensor     # [B, C] int32 PROWAVES per-chiplet lambdas
    prev_active: torch.Tensor     # [B, N_total] bool previous activity


# Config fields that `sweep` may set per lane (runtime knobs: nothing here
# changes an array shape).
SWEEPABLE_FIELDS = ("l_m", "buffer_sat", "wavelengths",
                    "prowaves_rho_hi", "prowaves_rho_lo",
                    "max_gateways", "min_gateways")
_INT_FIELDS = ("max_gateways", "min_gateways")


# ---------------------------------------------------------------------------
# Per-lane knobs
# ---------------------------------------------------------------------------

def _default_knob(sim: SimConfig, name: str):
    return {"l_m": sim.ctl.l_m, "max_gateways": sim.ctl.max_gateways,
            "min_gateways": sim.ctl.min_gateways,
            "buffer_sat": sim.noc.buffer_sat,
            "wavelengths": sim.wavelengths,
            "prowaves_rho_hi": sim.prowaves_rho_hi,
            "prowaves_rho_lo": sim.prowaves_rho_lo}[name]


def default_knobs(sim: SimConfig, n_lanes: int, device,
                  overrides: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Per-lane [B] knob tensors: `overrides[name]` where given, else the
    config's value. Floats are float32, gateway clamps int32 (the dtypes
    the reference's x64-off JAX gives them); `wavelengths` is float32, as
    the reference's step reads it."""
    overrides = overrides or {}
    out = {}
    for name in SWEEPABLE_FIELDS:
        v = overrides.get(name)
        if v is None:
            dtype = _I32 if name in _INT_FIELDS else _F32
            v = torch.full((n_lanes,), _default_knob(sim, name), dtype=dtype,
                           device=device)
        elif name == "wavelengths":
            v = v.to(_F32)
        out[name] = v
    return out


def _lane_sim(sim: SimConfig, knobs: Dict[str, torch.Tensor]) -> SimConfig:
    """A config copy whose knob fields hold per-lane tensors shaped to
    broadcast against [B, C] (`wavelengths` stays [B]). Never hashed: it
    only flows through the step (the reference's `_apply_overrides`)."""
    col = {k: v[:, None] for k, v in knobs.items()}
    return dataclasses.replace(
        sim,
        ctl=dataclasses.replace(sim.ctl, l_m=col["l_m"],
                                max_gateways=col["max_gateways"],
                                min_gateways=col["min_gateways"]),
        noc=dataclasses.replace(sim.noc, buffer_sat=col["buffer_sat"]),
        wavelengths=knobs["wavelengths"],
        prowaves_rho_hi=col["prowaves_rho_hi"],
        prowaves_rho_lo=col["prowaves_rho_lo"])


# ---------------------------------------------------------------------------
# The interval step
# ---------------------------------------------------------------------------

def _activity_mask(g: torch.Tensor, sim: SimConfig) -> torch.Tensor:
    """Per-chiplet g [..., C] -> gateway-chain activity [..., C*G + M].

    Chain layout: C chiplets x G slots (activation order), then the memory
    gateways, which are always active (Table 1).
    """
    gmax = sim.cfg.max_gateways_per_chiplet
    slots = torch.arange(gmax, device=g.device) < g[..., None]
    mem = torch.ones(g.shape[:-1] + (sim.cfg.memory_gateways,),
                     dtype=torch.bool, device=g.device)
    return torch.cat([slots.flatten(-2), mem], dim=-1)


def _interval_metrics(g: torch.Tensor, lam: torch.Tensor,
                      ext: torch.Tensor, mem: torch.Tensor,
                      intra: torch.Tensor, sim: SimConfig, tables: dict,
                      t_valid: torch.Tensor,
                      extra_db: Optional[torch.Tensor] = None,
                      dest: Optional[torch.Tensor] = None,
                      topo: Optional[dict] = None) -> dict:
    """Latency/load metrics for one interval of B lanes.

    g [B, C] int; lam [B, 1] (one wavelength count per lane) or [B, C]
    (PROWAVES, per chiplet); ext/intra [B, C]; mem, t_valid [B]; extra_db
    [B] (fault-path loss drift); dest [B, C, C]. Every returned metric is
    multiplied by `t_valid`, so a padded interval contributes exactly zero
    to every reduction. `sim` is a lane config (`_lane_sim`).

    `topo` (the padded topology path, `lane_topology`) holds each lane's
    topology: the chiplet axis is padded to the grid maximum, means run
    over the lane's real chiplets (`chip_mask`), padded chiplets' latencies
    are 0, and the hop tables and mesh scalars are the lane's own.
    """
    noc = sim.noc
    gw_load = ext / torch.clamp_min(g.to(_F32), 1.0)                 # [B, C]
    mem_gw_load = mem / sim.cfg.memory_gateways                      # [B]

    chip_mask = None if topo is None else topo["chip_mask"]          # [B, C]
    if topo is None:
        src_hops = mean_access_hops(tables, g)                       # [B, C]
        mean_src_hops = torch.mean(src_hops, dim=-1)                 # [B]
        gw_db = tables["gw_loss_db"]
        access_db = torch.mean(
            gw_db[torch.clamp(g.long(), 1, gw_db.shape[0]) - 1], dim=-1)
        lam_mem = lam[:, 0] if lam.shape[-1] == 1 \
            else torch.mean(lam, dim=-1)                             # [B]
        mesh_hops = torch.tensor(
            np.float32(uniform_mesh_mean_hops(sim.cfg)), device=ext.device)
        mesh_feed = 2.0 * topology.feed_width(sim.cfg)
    else:
        lev = torch.clamp(g.long(), 1, topo["src_hops"].shape[1]) - 1
        nreal = topo["nreal"]                                        # [B]
        src_hops = torch.gather(topo["src_hops"], 1, lev)
        mean_src_hops = torch.sum(src_hops * chip_mask, dim=-1) / nreal
        access_db = torch.sum(torch.gather(topo["gw_loss_db"], 1, lev)
                              * chip_mask, dim=-1) / nreal
        if lam.shape[-1] == 1:
            lam_mem = lam[:, 0]
        else:
            # Padded chiplets carry lambda = 0: 1.0 inside the latency
            # math only (their latencies are masked to 0 below).
            lam_mem = torch.sum(lam * chip_mask, dim=-1) / nreal
            lam = torch.where(chip_mask > 0, lam, torch.ones_like(lam))
        mesh_hops = topo["mesh_hops"][:, None]
        mesh_feed = 2.0 * topo["mesh_x"][:, None]
    if extra_db is not None:
        access_db = access_db + extra_db

    if dest is None:
        # Packets land on a uniformly random other chiplet.
        dst_hops = mean_src_hops[:, None] * torch.ones_like(src_hops)
        inter_lat = noc.inter_chiplet_latency(gw_load, lam, src_hops,
                                              dst_hops)              # [B, C]
        recv = None
    else:
        # Destination-aware: recv_j is the load received by chiplet j and
        # phi_j the fan-in concentration of its arrival mix. Summed over
        # sources in index order, the order the CUDA kernel uses, so the
        # controller's pressure term is the same float on both paths.
        w = ext[:, :, None] * dest                                   # [B,C,C]
        recv = w[:, 0]
        sq = w[:, 0] * w[:, 0]
        for i in range(1, w.shape[1]):
            recv = recv + w[:, i]
            sq = sq + w[:, i] * w[:, i]
        phi = sq / torch.clamp_min(recv * recv, 1e-12)
        # Times the reciprocal, as the reference's compiled code has it.
        burst_scale = ((1.0 + (noc.burstiness - 1.0) * phi)
                       * (1.0 / noc.burstiness))
        dst_gw_load = recv / torch.clamp_min(g.to(_F32), 1.0)
        dst_leg = noc.access_latency(src_hops, dst_gw_load, burst_scale)
        if chip_mask is not None:
            dst_leg = torch.where(chip_mask > 0, dst_leg,
                                  torch.zeros_like(dst_leg))
        inter_lat = (noc.access_latency(src_hops, gw_load)
                     + noc.gateway_latency(gw_load, lam)
                     + torch.matmul(dest, dst_leg[:, :, None])[..., 0])
    if chip_mask is not None:
        inter_lat = torch.where(chip_mask > 0, inter_lat,
                                torch.zeros_like(inter_lat))
    mem_lat = noc.inter_chiplet_latency(mem_gw_load[:, None],
                                        lam_mem[:, None],
                                        mean_src_hops[:, None], 1.0)[:, 0]
    link_load = intra * sim.cfg.packet_flits / mesh_feed
    intra_lat = noc.mesh_latency(mesh_hops, link_load)               # [B, C]

    # Traffic-weighted average packet latency across chiplets + memory.
    tot_ext = torch.sum(ext, dim=-1) + 1e-9
    tot_int = torch.sum(intra, dim=-1) + 1e-9
    tot_mem = mem + 1e-9
    inter_w = torch.sum(inter_lat * ext, dim=-1)
    lat = (inter_w + torch.sum(intra_lat * intra, dim=-1)
           + mem_lat * tot_mem) / (tot_ext + tot_int + tot_mem)
    tv = t_valid[:, None]
    out = {"latency": lat * t_valid, "gw_load": gw_load * tv,
           "inter_latency": inter_lat * tv,
           "mean_inter_latency": inter_w / tot_ext * t_valid,
           "access_db": access_db,
           "saturated": torch.any(noc.saturated(gw_load, lam), dim=-1)
                        & (t_valid > 0)}
    if recv is not None:
        out["recv_load"] = recv
    return out


def _prowaves_update(lam: torch.Tensor, inter_latency: torch.Tensor,
                     gw_load: torch.Tensor, sim: SimConfig) -> torch.Tensor:
    """PROWAVES wavelength adaptation, latency-target driven [16]:
    multiplicative up when the experienced delay exceeds 1.5x the
    zero-load target, down when it is below 1.3x and the optics idle."""
    dev = inter_latency.device
    f = lambda v: torch.tensor(v, dtype=_F32, device=dev)  # noqa: E731
    base = sim.noc.inter_chiplet_latency(
        f(1e-4), f(PROWAVES_MAX_WAVELENGTHS), f(2.5), f(2.5))
    s = sim.noc.serialization_cycles(lam).to(dev)
    rho_opt = gw_load * s
    lam_up = torch.clamp_max(lam * 2, PROWAVES_MAX_WAVELENGTHS)
    lam_dn = torch.clamp_min(torch.div(lam, 2, rounding_mode="floor"),
                             PROWAVES_MIN_WAVELENGTHS)
    hot = inter_latency > 1.5 * base
    cold = (inter_latency < 1.3 * base) & (rho_opt < sim.prowaves_rho_lo)
    return torch.where(hot, lam_up, torch.where(cold, lam_dn, lam))


def _where_lanes(keep_new: torch.Tensor, new: torch.Tensor,
                 old: torch.Tensor) -> torch.Tensor:
    """`where(keep_new, new, old)` with a [B] condition broadcast over the
    trailing axes."""
    return torch.where(keep_new.reshape((-1,) + (1,) * (new.dim() - 1)),
                       new, old)


def _freeze(t_valid: torch.Tensor, new: SimState, old: SimState) -> SimState:
    keep = t_valid > 0
    return SimState(
        ctl=ControllerState(
            g=_where_lanes(keep, new.ctl.g, old.ctl.g),
            packets_seen=_where_lanes(keep, new.ctl.packets_seen,
                                      old.ctl.packets_seen),
            epoch=_where_lanes(keep, new.ctl.epoch, old.ctl.epoch)),
        wavelengths=_where_lanes(keep, new.wavelengths, old.wavelengths),
        prev_active=_where_lanes(keep, new.prev_active, old.prev_active))


def make_step(sim: SimConfig, tables: dict, knobs: Dict[str, torch.Tensor],
              faulted: bool = False, dest: Optional[torch.Tensor] = None,
              topo: Optional[dict] = None):
    """Build the per-interval step of B lanes for the chosen architecture.

    `knobs` holds the per-lane runtime knobs ([B] tensors, `default_knobs`).
    `faulted` appends the fault-frame inputs (gw_ok [B, C, G], stuck_on
    [B, C, G], drift_db [B]): a failed slot carries no traffic, draws no
    power and charges no reconfiguration energy; a stuck-on cell burns power
    the controller cannot gate; drift erodes the optical budget. `dest` is
    the lanes' [B, C, C] destination matrices (per trace, constant in time).
    The step's input is the tuple (ext [B, C], mem [B], intra [B, C],
    ext_frac [B], t_valid [B]) plus the fault frames.

    `topo` switches on the padded topology path (`lane_topology`): `sim.cfg`
    is the padded shape (grid maxima) and each lane carries its own
    topology. A padded chiplet injects nothing, holds g = 0 and lambda = 0
    throughout, and so stays dark in every activity mask and power sum;
    the controller power and AWGR's port count are the lane's own.
    """
    lane = _lane_sim(sim, knobs)
    cfg = sim.cfg
    interval = float(cfg.reconfig_interval_cycles)
    n_total = cfg.total_gateways
    gmax = cfg.max_gateways_per_chiplet
    n_c = cfg.n_chiplets
    chip_mask = None if topo is None else topo["chip_mask"]
    n_chips = n_c if topo is None else topo["n_chiplets"]
    gw_count = None if topo is None else topo["total_gateways"]

    def _lit_mask(g_des, gw_ok, stuck_on):
        """(usable [B, C, G], powered chain [B, N_total] bool) under faults."""
        desired = (torch.arange(gmax, device=g_des.device)
                   < g_des[..., None]).to(_F32)
        usable = desired * gw_ok
        lit = torch.maximum(usable, stuck_on * gw_ok)
        mem_on = torch.ones(g_des.shape[:-1] + (cfg.memory_gateways,),
                            dtype=_F32, device=g_des.device)
        return usable, torch.cat([lit.flatten(-2), mem_on], dim=-1) > 0.5

    def step(state: SimState, tr) -> Tuple[SimState, dict]:
        ext, mem, intra, _ext_frac, t_valid = tr[:5]
        gw_ok, stuck_on, drift_db = tr[5:] if faulted else (None,) * 3
        b = ext.shape[0]
        dev = ext.device
        if chip_mask is not None:
            # A lane's padded chiplets inject nothing.
            ext = ext * chip_mask
            intra = intra * chip_mask
        if sim.arch in KERNEL_ARCHS:
            g = state.ctl.g
            lam = lane.wavelengths[:, None]
        elif sim.arch == Arch.PROWAVES:
            g = torch.ones((b, n_c), dtype=_I32, device=dev) \
                if topo is None else (chip_mask > 0).to(_I32)
            lam = state.wavelengths.to(_F32)
        else:  # AWGR: all gateways, 1 lambda per port
            g = torch.full((b, n_c), gmax, dtype=_I32, device=dev) \
                if topo is None else torch.where(
                    chip_mask > 0, topo["g_max"][:, None].to(_I32),
                    torch.zeros((), dtype=_I32, device=dev))
            lam = torch.ones((b, 1), dtype=_F32, device=dev)

        if faulted:
            usable, active_eff = _lit_mask(g, gw_ok, stuck_on)
            g_eff = torch.sum(usable, dim=-1).to(_I32)
        else:
            g_eff = g

        m = _interval_metrics(g_eff, lam, ext, mem, intra, lane, tables,
                              t_valid, extra_db=drift_db, dest=dest,
                              topo=topo)

        # --- power ---------------------------------------------------------
        active = active_eff if faulted else _activity_mask(g, sim)
        if sim.arch == Arch.PROWAVES:
            n_pw = n_c + cfg.memory_gateways
            w = state.wavelengths.to(_F32)
            if faulted:
                # A failed PROWAVES gateway takes its lasers down with it.
                w = w * gw_ok[..., 0]
            lam_mem = torch.mean(w, dim=-1, keepdim=True) if topo is None \
                else (torch.sum(w, dim=-1) / topo["nreal"])[:, None]
            pw = photonics.interposer_power_mw(
                torch.ones((b, n_pw), dtype=torch.bool, device=dev),
                torch.cat([w, lam_mem.expand(b, cfg.memory_gateways)],
                          dim=-1), n_gateways=n_pw,
                mode="wdm", loss_db=m["access_db"], n_chiplets=n_chips)
        elif sim.arch == Arch.AWGR:
            pw = photonics.interposer_power_mw(
                active, active.to(_F32), n_gateways=n_total,
                loss_db=PHOTONIC_POWER.awgr_loss_db + m["access_db"],
                mode="static", gateway_count=gw_count, n_chiplets=n_chips)
        else:
            pw = photonics.interposer_power_mw(
                active, lane.wavelengths, n_gateways=n_total, mode="pcm",
                loss_db=m["access_db"], n_chiplets=n_chips)

        # --- controller update ---------------------------------------------
        reconf_nj = torch.zeros((b,), dtype=_F32, device=dev)
        if sim.arch == Arch.RESIPI:
            # Destination-aware deployment meters the hotter of injected
            # and received load.
            pressure = ext if dest is None \
                else torch.maximum(ext, m["recv_load"])
            packets = pressure * interval
            if faulted:
                # Failures concentrate the same packets on fewer usable
                # lanes (exactly 1.0 when healthy).
                packets = packets * (g.to(_F32) / torch.clamp_min(
                    g_eff.to(_F32), 1.0))
            new_ctl, _ = epoch_step(state.ctl, packets, interval, lane.ctl)
            new_active = _lit_mask(new_ctl.g, gw_ok, stuck_on)[1] \
                if faulted else _activity_mask(new_ctl.g, sim)
            reconf_nj = photonics.reconfig_energy_nj(active, new_active)
            new_state = SimState(ctl=new_ctl, wavelengths=state.wavelengths,
                                 prev_active=new_active)
        elif sim.arch == Arch.PROWAVES:
            lam_new = _prowaves_update(state.wavelengths,
                                       m["inter_latency"], m["gw_load"],
                                       lane)
            if chip_mask is not None:
                # Padded chiplets stay at lambda = 0 (the cold branch
                # would raise a dead lane to the wavelength floor).
                lam_new = torch.where(chip_mask > 0, lam_new,
                                      torch.zeros_like(lam_new))
            new_state = SimState(ctl=state.ctl, wavelengths=lam_new,
                                 prev_active=active)
        else:
            new_state = SimState(ctl=state.ctl, wavelengths=state.wavelengths,
                                 prev_active=active)

        energy = pw["total_mw"] * m["latency"]
        lam_rec = lam * (torch.ones((b, n_c), dtype=_F32, device=dev)
                         if chip_mask is None else chip_mask)
        tv_i = t_valid.to(_I32)[:, None]
        rec = {"latency": m["latency"], "power_mw": pw["total_mw"] * t_valid,
               "laser_mw": pw["laser_mw"] * t_valid, "energy": energy,
               "reconfig_nj": reconf_nj * t_valid,
               # The EFFECTIVE gateway count: failed slots count zero.
               "g": g_eff * tv_i,
               "wavelengths": lam_rec * t_valid[:, None],
               "gw_load": m["gw_load"],
               "mean_inter_latency": m["mean_inter_latency"],
               "saturated": m["saturated"]}
        if faulted:
            rec["g_desired"] = g * tv_i
            dead = (torch.arange(gmax, device=dev) < g[..., None]) \
                & (gw_ok < 0.5)
            rec["failed_slots"] = torch.sum(dead, dim=(-2, -1)).to(_F32) \
                * t_valid
        # Masked intervals FREEZE the carry: the controller never reacts to
        # the fake idle epochs of a padded gap.
        return _freeze(t_valid, new_state, state), rec

    return step


# ---------------------------------------------------------------------------
# Engine core
# ---------------------------------------------------------------------------

# Device placement and co-design searches run (`core/search.py`,
# `core/pareto.py`): one per search, counted once its last generation is
# launched, whatever the island count; and the co-design searches captured
# as a CUDA graph and replayed (`pareto._SearchGraph`).
_STATS = {"search_dispatches": 0, "codesign_graph_captures": 0,
          "codesign_graph_replays": 0}


def engine_stats() -> dict:
    """Kernel launches and builds, plain-loop runs, table (unpadded and
    padded device views) and co-design topology builds, device searches,
    co-design graph captures and replays, and copies of the host spans'
    and device-to-host reads' totals (`backend.span`,
    `backend.count_host_read`) and of the trace value checks' counts
    (`trace_checks`: `n` checks run, `fallbacks` sent to the host path,
    `traffic.validate_trace`): a snapshot keeps its values as later spans
    run."""
    from repro_torch.core.pareto import _codesign_topology

    launches = dict(backend.COUNTERS["launches"])
    return {"epoch_step_launches": launches.get("epoch_step", 0),
            "kernel_launches": launches,
            "kernel_builds": dict(backend.COUNTERS["builds"]),
            "loop_runs": backend.COUNTERS["loop_runs"],
            "selection_table_builds":
                build_selection_tables.cache_info().misses,
            "padded_table_builds": TABLE_STATS["padded_table_builds"],
            "codesign_topology_builds":
                _codesign_topology.cache_info().misses,
            "search_dispatches": _STATS["search_dispatches"],
            "codesign_graph_captures": _STATS["codesign_graph_captures"],
            "codesign_graph_replays": _STATS["codesign_graph_replays"],
            "spans": {k: dict(v)
                      for k, v in backend.COUNTERS["spans"].items()},
            "host_reads": {k: dict(v) for k, v in
                           backend.COUNTERS["host_reads"].items()},
            "trace_checks": dict(backend.COUNTERS["trace_checks"])}


def reset_engine_stats() -> None:
    backend.reset_counters()
    for k in _STATS:
        _STATS[k] = 0
    TABLE_STATS["padded_table_builds"] = 0


def _initial_state(sim: SimConfig, knobs: Dict[str, torch.Tensor],
                   topo: Optional[dict] = None) -> SimState:
    """Fresh state of B lanes; each lane's initial g is its own
    `max_gateways` knob (§3.3: "initially set to the maximum allowed").
    With `topo` (padded lanes) a lane's padded chiplets start, and stay,
    at g = 0 and lambda = 0, and nothing was active before."""
    cfg = sim.cfg
    c = cfg.n_chiplets
    g0 = knobs["max_gateways"].to(_I32)
    b, dev = g0.shape[0], g0.device
    if topo is not None:
        valid = topo["chip_mask"] > 0
        zero = torch.zeros((), dtype=_I32, device=dev)
        w0 = torch.full((b,), PROWAVES_MAX_WAVELENGTHS, dtype=_I32,
                        device=dev) if sim.arch == Arch.PROWAVES \
            else knobs["wavelengths"].to(_I32)
        return SimState(
            ctl=ControllerState(
                g=torch.where(valid, g0[:, None], zero),
                packets_seen=torch.zeros((b, c), dtype=_F32, device=dev),
                epoch=torch.zeros((b,), dtype=_I32, device=dev)),
            wavelengths=torch.where(valid, w0[:, None], zero),
            prev_active=torch.zeros((b, cfg.total_gateways),
                                    dtype=torch.bool, device=dev))
    if sim.arch == Arch.PROWAVES:
        lam0 = torch.full((b, c), PROWAVES_MAX_WAVELENGTHS, dtype=_I32,
                          device=dev)
    else:
        lam0 = knobs["wavelengths"].to(_I32)[:, None].expand(b, c).clone()
    return SimState(
        ctl=ControllerState(
            g=g0[:, None].expand(b, c).clone(),
            packets_seen=torch.zeros((b, c), dtype=_F32, device=dev),
            epoch=torch.zeros((b,), dtype=_I32, device=dev)),
        wavelengths=lam0,
        prev_active=_activity_mask(
            torch.full((b, c), cfg.max_gateways_per_chiplet, dtype=_I32,
                       device=dev), sim))


def _loop(state: SimState, xs: tuple, sim: SimConfig, tables: dict, *,
          dest: Optional[torch.Tensor] = None, faulted: bool = False,
          lane_trace: Optional[torch.Tensor] = None,
          knobs: Optional[Dict[str, torch.Tensor]] = None,
          topo: Optional[dict] = None,
          dest_index: Optional[torch.Tensor] = None,
          pair_trace: Optional[torch.Tensor] = None
          ) -> Tuple[SimState, dict]:
    """The plain interval loop: `make_step` stepped over T.

    `xs` = (ext [N, T, C], mem [N, T], intra [N, T, C], ext_frac [N, T],
    t_mask [N, T]) plus (gw_ok [N, T, C, G], stuck_on [N, T, C, G],
    drift_db [N, T]) when `faulted`, loads already t_mask-multiplied; `dest`
    is [N, C, C], or [P, C, C] with `dest_index` [B] naming each lane's
    matrix (the padded path's per-(trace, chiplet count) matrices) and
    `pair_trace` [P] each matrix's trace (read by the kernel only). Lane b
    reads trace `lane_trace[b]` (default: lane n reads trace n). `topo` is
    the lanes' padded topology (`lane_topology`). Returns the final state
    and records [B, T, ...].
    """
    backend.count_loop_run()
    n = xs[0].shape[0]
    dev = xs[0].device
    if lane_trace is None:
        lane_trace = torch.arange(n, device=dev)
    lane_trace = lane_trace.long()
    if knobs is None:
        knobs = default_knobs(sim, int(lane_trace.shape[0]), dev)
    lanes = [a[lane_trace] for a in xs]
    if dest is not None:
        dest = dest[lane_trace if dest_index is None else dest_index.long()]
    step = make_step(sim, tables, knobs, faulted=faulted, dest=dest,
                     topo=topo)
    recs = []
    for t in range(lanes[0].shape[1]):
        state, rec = step(state, tuple(a[:, t] for a in lanes))
        recs.append(rec)
    return state, {k: torch.stack([r[k] for r in recs], dim=1)
                   for k in recs[0]}


def _scan_trace(state: SimState, xs: tuple, sim: SimConfig, tables: dict,
                *, dest: Optional[torch.Tensor] = None, faulted: bool = False,
                lane_trace: Optional[torch.Tensor] = None,
                knobs: Optional[Dict[str, torch.Tensor]] = None,
                topo: Optional[dict] = None,
                dest_index: Optional[torch.Tensor] = None,
                pair_trace: Optional[torch.Tensor] = None,
                kernel: Optional[str] = None) -> Tuple[SimState, dict]:
    """Run the interval loop: the `epoch_step` kernel wrapper for the
    configurations it supports (the reference's gate, plus its >= 1
    memory gateway precondition; padded lanes included, where the
    reference runs its scan body), the plain loop for everything else.
    `kernel` names the wrapper's design on the card (default: its own
    choice for these lanes; `_launch_design`)."""
    kw = dict(dest=dest, faulted=faulted, lane_trace=lane_trace, knobs=knobs,
              topo=topo, dest_index=dest_index, pair_trace=pair_trace)
    if _kernel_runs(sim):
        from repro_torch.kernels.epoch_step.ops import epoch_run
        if kernel is not None:
            kw["kernel"] = kernel
        return epoch_run(state, xs, sim, tables, **kw)
    return _loop(state, xs, sim, tables, **kw)


def _kernel_runs(sim: SimConfig) -> bool:
    """Whether `_scan_trace` runs the `epoch_step` wrapper for `sim`."""
    return sim.arch in KERNEL_ARCHS and sim.cfg.memory_gateways >= 1


def _launch_design(sim: SimConfig, xs: tuple, kw: dict,
                   lanes: int) -> Optional[str]:
    """The `epoch_step` design one launch of `lanes` lanes of these inputs
    runs (`ops.variant`), None where the plain loop runs or the wrapper
    refuses the width."""
    from repro_torch.kernels.epoch_step import ops

    c = int(xs[0].shape[-1])
    if not _kernel_runs(sim) or c > ops.MAX_CHIPLETS:
        return None
    return ops.variant(c, bool(kw.get("faulted")),
                       kw.get("dest") is not None, lanes,
                       kw.get("topo") is not None)


def _pin_design(sim: SimConfig, xs: tuple, kw: dict, lanes: int, *,
                topo: Optional[dict] = None) -> Optional[str]:
    """Return the `epoch_step` design of a run of `lanes` lanes, and pin a
    smaller block of it to that design (`kw["kernel"]`, `kw` the block's
    loop kwargs; `topo` where `kw` holds none), so each block of a split
    run launches what the one-device call would, bit for bit."""
    design = _launch_design(sim, xs, {"topo": topo, **kw}, lanes)
    if int(kw["lane_trace"].shape[0]) < lanes:
        kw["kernel"] = design
    return design


def _lane_total(x: torch.Tensor) -> torch.Tensor:
    """Per-lane sums of [B, T, ...] over T in a fixed pairwise order (the
    interval axis padded with 0.0 to a power of two, then halved; the same
    tree as halving with one 0.0 appended at each odd length): lane b's
    total is the same float whatever B is and on either device."""
    t = x.shape[1]
    width = 1 << max(t - 1, 0).bit_length()
    if width != t:
        x = torch.cat([x, x.new_zeros((x.shape[0], width - t)
                                      + x.shape[2:])], dim=1)
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


_FLOAT_SUMS = ("latency", "power_mw", "energy", "reconfig_nj")


def _record_sums(recs: dict, t_mask: torch.Tensor) -> dict:
    """Mask-correct per-lane record totals ([B] each); records are already
    t_valid-masked, so plain sums ignore padded intervals. Counts and
    integer-valued records sum exactly in any order; the float records go
    through `_lane_total`, all four in one pass."""
    def tot(k):
        r = recs[k]
        return torch.sum(r, dim=tuple(range(1, r.dim())))
    floats = _lane_total(torch.stack([recs[k] for k in _FLOAT_SUMS], dim=2))
    out = dict(zip(_FLOAT_SUMS, floats.unbind(dim=1)))
    out.update(gateways=tot("g").to(_F32), wavelengths=tot("wavelengths"),
               saturated=torch.sum(recs["saturated"].to(_F32), dim=1),
               valid_intervals=torch.sum(t_mask, dim=1))
    return out


def _summary_from_sums(sums: dict, n_chiplets_for_lambda) -> dict:
    t = torch.clamp_min(sums["valid_intervals"], 1.0)
    return {
        "mean_latency": sums["latency"] / t,
        "mean_power_mw": sums["power_mw"] / t,
        "mean_energy": sums["energy"] / t,
        "mean_gateways": sums["gateways"] / t,
        "mean_wavelengths": sums["wavelengths"]
                            / (t * n_chiplets_for_lambda),
        "saturated_frac": sums["saturated"] / t,
        "total_reconfig_nj": sums["reconfig_nj"],
        "valid_intervals": sums["valid_intervals"],
    }


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=_F32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class _Checked(dict):
    """A trace dict or stacked batch whose checks have passed in this call:
    `_trace_arrays` and `stack_traces` do not check it again. Made inside
    an entry point's call and never handed back, so nothing is taken as
    checked across calls."""


def _checked(trace: dict) -> _Checked:
    return _Checked(traffic.validate_trace(trace))


def _trace_arrays(trace: dict, device) -> tuple:
    """(ext, mem, intra, ext_frac, t_mask, dest) as float32 tensors on
    `device` — the one place trace dtypes are fixed (numpy float64 would
    otherwise ride through as float64). dest is None unless present. The
    trace is checked here unless this call has checked it (`_Checked`)."""
    if not isinstance(trace, _Checked):
        traffic.validate_trace(trace)
    mem = _as_f32(trace["mem_load"], device)
    t_mask = trace.get("t_mask")
    t_mask = torch.ones_like(mem) if t_mask is None \
        else _as_f32(t_mask, device)
    dest = trace.get("dest")
    dest = None if dest is None else _as_f32(dest, device)
    return (_as_f32(trace["ext_load"], device), mem,
            _as_f32(trace["int_load"], device),
            _as_f32(trace["ext_frac"], device), t_mask, dest)


def _has_faults(trace: dict) -> bool:
    """Whether the trace carries a fault frame; a partial frame raises
    instead of silently simulating fault-free."""
    present = [k for k in FAULT_KEYS if k in trace]
    missing = [k for k in FAULT_KEYS if k not in trace]
    if present and missing:
        raise ValueError(
            f"trace carries fault keys {present} but is missing {missing} "
            f"— attach a complete frame (gw_ok, stuck_on, drift_db)")
    return bool(present)


def _trace_faults(trace: dict, device
                  ) -> Optional[Tuple[torch.Tensor, ...]]:
    """The trace's fault frame in FAULT_KEYS order, or None."""
    if not _has_faults(trace):
        return None
    return tuple(_as_f32(trace[k], device) for k in FAULT_KEYS)


def _numeric_grid(name: str, values) -> np.ndarray:
    """A swept numeric grid as numpy, rejecting non-numeric values."""
    if isinstance(values, torch.Tensor) and values.is_cuda:
        backend.count_host_read("simulator._numeric_grid", values.nbytes)
    try:
        a = values.detach().cpu().numpy() if isinstance(values, torch.Tensor) \
            else np.asarray(values)
    except (TypeError, ValueError) as e:
        raise ValueError(f"swept field {name!r} must be a numeric grid "
                         f"({e})") from None
    if not (np.issubdtype(a.dtype, np.number) or a.dtype == np.bool_):
        raise ValueError(f"swept field {name!r} must be a numeric grid, "
                         f"got dtype {a.dtype}")
    return a


def _runtime_grid(name: str, values) -> np.ndarray:
    """A runtime knob grid in the dtype the reference gives it (x64 off):
    floats as float32, integers as int32 (a float64 grid would change
    controller decisions)."""
    a = _numeric_grid(name, values)
    return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) \
        else a.astype(np.int32)


def _check_sweep_fields(fields, device) -> Dict[str, torch.Tensor]:
    """Sweep grids as [K] tensors (`_runtime_grid`'s dtypes)."""
    if not fields:
        raise ValueError("sweep() needs at least one field=values pair")
    unknown = set(fields) - set(SWEEPABLE_FIELDS)
    if unknown:
        raise ValueError(f"non-sweepable fields: {sorted(unknown)} "
                         f"(sweepable: {SWEEPABLE_FIELDS})")
    ov = {k: _runtime_grid(k, v) for k, v in fields.items()}
    shapes = {k: a.shape for k, a in ov.items()}
    if any(len(s) != 1 for s in shapes.values()) \
            or len({s[0] for s in shapes.values()}) != 1:
        raise ValueError(f"swept fields must be 1-D of equal length, "
                         f"got {shapes}")
    return {k: torch.as_tensor(a, device=device) for k, a in ov.items()}


def stack_traces(traces: List[dict], *, pad: bool = False) -> dict:
    """Stack N traces along a new leading batch axis.

    Mixed-length traces need `pad=True`: shorter ones zero-pad to the
    longest T under a `t_mask` [N, T]. A batch must be uniformly faulted or
    clean, and uniformly destination-aware or not.

    The traces are checked as `traffic.transform.stack_checked` checks a
    batch: each trace's keys, dtypes and shapes first; the values of all
    of them at once, on the stacked arrays (one read from the card). A
    fault in either is raised as `validate_trace(traces[i])` raises it,
    for the first trace at fault, before any other error of the batch.
    """
    with backend.span("stack_traces", backend.LAYER_TABLES):
        if not traces:
            raise ValueError("stack_traces() needs at least one trace")
        if all(isinstance(tr, _Checked) for tr in traces):
            return _stack(traces, pad)
        return stack_checked(traces, lambda trs: _stack(trs, pad))


def _stack(traces: List[dict], pad: bool) -> dict:
    chips = sorted({int(np.shape(tr["ext_load"])[-1]) for tr in traces})
    if len(chips) != 1:
        raise ValueError(
            f"traces cover different chiplet counts {chips}; narrow them "
            f"to one width first (traffic.slice_trace)")
    lengths = [int(np.shape(tr["ext_load"])[0]) for tr in traces]
    ragged = len(set(lengths)) > 1
    if ragged and not pad:
        raise ValueError(
            f"traces have mixed lengths T={lengths}; pass pad=True to "
            f"zero-pad them to T={max(lengths)} under a t_mask")
    masked = pad or ragged or any("t_mask" in tr for tr in traces)
    if masked:
        traces = [pad_checked(tr, max(lengths)) for tr in traces]
    n_faulted = sum(_has_faults(tr) for tr in traces)
    if n_faulted not in (0, len(traces)):
        raise ValueError(
            f"{n_faulted}/{len(traces)} traces carry fault frames; a "
            f"batch must be uniformly faulted or uniformly clean")
    n_dest = sum(tr.get("dest") is not None for tr in traces)
    if n_dest not in (0, len(traces)):
        raise ValueError(
            f"{n_dest}/{len(traces)} traces carry destination matrices; a "
            f"batch must be uniformly destination-aware or not")
    keys = ("ext_load", "mem_load", "int_load", "ext_frac") \
        + (("t_mask",) if masked else ()) \
        + (("dest",) if n_dest else ()) \
        + (FAULT_KEYS if n_faulted else ())
    dev = torch.as_tensor(traces[0]["ext_load"]).device
    out = {k: torch.stack([_as_f32(tr[k], dev) for tr in traces])
           for k in keys}
    out["app"] = [tr.get("app", "?") for tr in traces]
    return out


def epoch_inputs(traces, sim: SimConfig, *, device=None, faults=True,
                 zipped=False, **fields):
    """What the entry points hand the interval loop, for N traces x K grid
    points (K = 1 without `fields`): `(state0, xs, tables, kwargs)` such
    that ``_scan_trace(state0, xs, sim, tables, **kwargs)`` — or the kernel
    wrapper `ops.epoch_run` and its plain version with the same arguments —
    runs lane n*K + k on trace n with grid point k.

    `traces` is one trace dict, a list of traces (ragged lengths pad under
    a `t_mask`) or a `stack_traces` dict. `faults=False` drops any fault
    frame (the sweeps, like the reference's, read none). `zipped=True`
    pairs instead of crossing: N lanes, lane n on trace n with grid point
    n (K must be N, or no grid).
    """
    with backend.span("epoch_inputs", backend.LAYER_TABLES):
        dev = backend.resolve_device(device)
        if isinstance(traces, (list, tuple)):
            batch = _stacked(traces)
        elif np.ndim(traces["ext_load"]) == 2:
            batch = _Checked(stack_traces([traces]))
        else:
            batch = traces
        ext, mem, intra, ext_frac, t_mask, dest = _trace_arrays(batch, dev)
        flt = _trace_faults(batch, dev) if faults else None
        ov = _check_sweep_fields(fields, dev) if fields else {}
        n = ext.shape[0]
        k = int(next(iter(ov.values())).shape[0]) if ov else 1
        if zipped:
            if ov and k != n:
                raise ValueError(f"zipped grids have length {k} but there "
                                 f"are {n} traces")
            lane_trace = torch.arange(n, device=dev)
            knobs = default_knobs(sim, n, dev, ov)
        else:
            lane_trace = torch.arange(n, device=dev).repeat_interleave(k)
            knobs = default_knobs(sim, n * k, dev,
                                  {f: v.repeat(n) for f, v in ov.items()})
        # Masked intervals inject zero traffic (and record zeros downstream).
        ext = ext * t_mask[..., None]
        mem = mem * t_mask
        intra = intra * t_mask[..., None]
        xs = (ext, mem, intra, ext_frac.reshape(n, 1).expand_as(mem),
              t_mask)
        if flt is not None:
            xs = xs + flt
        kwargs = dict(dest=dest, faulted=flt is not None,
                      lane_trace=lane_trace, knobs=knobs)
        return (_initial_state(sim, knobs), xs,
                selection_tables_torch(sim.cfg, dev), kwargs)


def _run(traces, sim: SimConfig, shape, *, device, faults=True,
         zipped=False, **fields) -> dict:
    """Shared body of the unpadded entry points: N x K lanes (N zipped
    lanes) through `_run_lanes`; the lane axis of every result is reshaped
    to `shape`."""
    state0, xs, tables, kw = epoch_inputs(traces, sim, device=device,
                                          faults=faults, zipped=zipped,
                                          **fields)
    return _run_lanes(sim, state0, xs, tables, kw, sim.cfg.n_chiplets,
                      shape)


def _run_lanes(sim: SimConfig, state0: SimState, xs: tuple, tables,
               kw: dict, nreal, shape) -> dict:
    """The body of every run of a set of lanes on one device: the interval
    loop, then the mask-correct summaries (means over `nreal` chiplets),
    every result's lane axis reshaped to `shape`. A split run
    (`_run_blocks`) runs it once for each of its blocks."""
    _, recs = _scan_trace(state0, xs, sim, tables, **kw)
    with backend.span("summaries", backend.LAYER_ENTRY):
        summary = _summary_from_sums(
            _record_sums(recs, xs[4][kw["lane_trace"]]), nreal)
    return _shaped(recs, summary, shape)


def _shaped(recs: dict, summary: dict, shape) -> dict:
    """{"records", "summary"} with every lane axis reshaped to `shape`."""
    return {name: {k: v.reshape(shape + tuple(v.shape[1:]))
                   for k, v in part.items()}
            for name, part in (("records", recs), ("summary", summary))}


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def simulate(trace: dict, sim: SimConfig, *, device=None) -> dict:
    """Run one trace; returns per-interval records ([T] / [T, C]) and
    summary scalars. A trace carrying a complete fault frame (FAULT_KEYS)
    runs the fault path. Runs on the card unless `device="cpu"`."""
    with backend.span("simulate", backend.LAYER_ENTRY):
        return _run(_checked(trace), sim, (), device=device)


def _stacked(traces) -> dict:
    """A list of traces stacked (ragged lengths padded) and checked in this
    call; anything else as it is."""
    return _Checked(stack_traces(list(traces), pad=True)) \
        if isinstance(traces, (list, tuple)) else traces


def simulate_batch(traces, sim: SimConfig, *, device=None) -> dict:
    """N traces (a list, ragged lengths allowed, or a `stack_traces` dict)
    as N lanes of one run; results gain a leading [N] axis."""
    with backend.span("simulate_batch", backend.LAYER_ENTRY):
        batch = _stacked(traces)
        return _run(batch, sim, (int(np.shape(batch["ext_load"])[0]),),
                    device=device)


def _grid_len(fields) -> int:
    if not fields:
        raise ValueError("sweep() needs at least one field=values pair")
    return int(np.size(next(iter(fields.values()))))


def sweep(trace: dict, sim: SimConfig, *, device=None, **fields) -> dict:
    """K lanes over one trace, one lane per grid point, e.g.
    ``sweep(tr, sim, l_m=np.linspace(0.005, 0.03, 64))``. Every swept field
    (SWEEPABLE_FIELDS) is a 1-D grid of one common length K; results carry
    a leading [K] axis."""
    with backend.span("sweep", backend.LAYER_ENTRY):
        return _run(trace, sim, (_grid_len(fields),), device=device,
                    faults=False, **fields)


def sweep_batch(traces, sim: SimConfig, *, device=None, **fields) -> dict:
    """The full DSE grid as N*K lanes: N traces x K grid points, results
    reshaped to leading [N, K] axes (trace-major)."""
    with backend.span("sweep_batch", backend.LAYER_ENTRY):
        batch = _stacked(traces)
        return _run(batch, sim, (int(np.shape(batch["ext_load"])[0]),
                                 _grid_len(fields)),
                    device=device, faults=False, **fields)


def simulate_all_archs(trace: dict, base: SimConfig = SimConfig(), *,
                       device=None) -> dict:
    """Summaries of one trace under every architecture, keyed by name."""
    return {arch.value: simulate(trace, base.with_arch(arch),
                                 device=device)["summary"]
            for arch in Arch}


def sweep_faults(trace: dict, sim: SimConfig, frames, *, device=None,
                 **fields) -> dict:
    """K fault scenarios over one trace as K lanes of one interval loop
    (one `epoch_step` launch for RESIPI / RESIPI_ALL on the card).

    `frames` is a list of fault frames (each from `faults.compile_faults`
    on the trace's horizon) or a stacked frame dict with a leading [K] axis
    (`faults.stack_fault_frames`). Optional `**fields` grids
    (SWEEPABLE_FIELDS, each of length K) zip lane for lane with the frames.
    Results carry a leading [K] axis.
    """
    if _has_faults(trace):
        raise ValueError(
            "sweep_faults() takes the fault grid via `frames`; pass a clean "
            "trace (faults.strip_faults) instead of an attached one")
    from repro_torch.core.faults import stack_fault_frames

    dev = backend.resolve_device(device)
    stacked = stack_fault_frames(frames) \
        if isinstance(frames, (list, tuple)) else frames
    missing = [k for k in FAULT_KEYS if k not in stacked]
    if missing:
        raise ValueError(f"fault frames are missing keys {missing}")
    flt = tuple(_as_f32(stacked[k], dev) for k in FAULT_KEYS)
    ext, mem, intra, ext_frac, t_mask, dest = _trace_arrays(trace, dev)
    if ext.dim() != 2:
        raise ValueError(f"sweep_faults takes one unbatched trace "
                         f"(ext_load [T, C]), got {tuple(ext.shape)}")
    k = int(flt[0].shape[0])
    t = int(mem.shape[0])
    if int(flt[0].shape[1]) != t:
        raise ValueError(
            f"fault frames cover {int(flt[0].shape[1])} intervals but the "
            f"trace has {t} — compile them with n_intervals={t}")
    ov = _check_sweep_fields(fields, dev) if fields else {}
    if ov and int(next(iter(ov.values())).shape[0]) != k:
        raise ValueError(
            f"swept fields have length "
            f"{int(next(iter(ov.values())).shape[0])} but there are {k} "
            f"fault frames — the axes zip lane-for-lane")
    knobs = default_knobs(sim, k, dev, ov)
    xs = ((ext * t_mask[:, None]).expand(k, *ext.shape),
          (mem * t_mask).expand(k, t), (intra * t_mask[:, None])
          .expand(k, *intra.shape), ext_frac.expand(k, t),
          t_mask.expand(k, t)) + flt
    kw = dict(dest=None if dest is None else dest.expand(k, *dest.shape),
              faulted=True, lane_trace=torch.arange(k, device=dev),
              knobs=knobs)
    return _run_lanes(sim, _initial_state(sim, knobs), xs,
                      selection_tables_torch(sim.cfg, dev), kw,
                      sim.cfg.n_chiplets, (k,))


# ---------------------------------------------------------------------------
# Streaming sessions and continuous-batching ticks
# ---------------------------------------------------------------------------

def _session_run(states: SimState, ext, mem, intra, ext_frac, t_mask,
                 tables: dict, sim: SimConfig, *, dest=None, frame=None
                 ) -> Tuple[SimState, dict, dict]:
    """B session lanes one chunk each: lane b steps its own chunk (ext [B,
    T, C], mem / t_mask [B, T], intra [B, T, C], ext_frac [B], dest [B, C,
    C]) from its own carry; `frame` (gw_ok / stuck_on [T, C, G], drift_db
    [T]) is one fault frame every lane shares, handed to the loop expanded
    over the lanes (not copied). Returns (new states, records [B, ...],
    sums [B])."""
    b, t = mem.shape
    xs = (ext * t_mask[..., None], mem * t_mask, intra * t_mask[..., None],
          ext_frac.reshape(b, 1).expand(b, t), t_mask)
    if frame is not None:
        xs = xs + tuple(a[None].expand(b, *a.shape) for a in frame)
    lanes = torch.arange(b, device=mem.device)
    new_states, recs = _scan_trace(
        states, xs, sim, tables, dest=dest, faulted=frame is not None,
        lane_trace=lanes, knobs=default_knobs(sim, b, mem.device))
    return new_states, recs, _record_sums(recs, t_mask)


def _frame_arrays(frame: dict, t: int, device, what: str) -> tuple:
    missing = [k for k in FAULT_KEYS if k not in frame]
    if missing:
        raise ValueError(f"fault frame is missing {missing} "
                         f"(build it with faults.compile_faults/no_faults)")
    flt = tuple(_as_f32(frame[k], device) for k in FAULT_KEYS)
    if int(flt[0].shape[0]) != t:
        raise ValueError(
            f"fault frame covers {int(flt[0].shape[0])} intervals but the "
            f"{what} has {t} — compile the frame at that length")
    return flt


class SimSession:
    """Streaming simulation session: unbounded traces at fixed memory.

    ::

        session = SimSession.init(sim, device="cpu")
        for chunk in online_trace_chunks:        # each a trace dict
            out = session.step_chunk(chunk)      # records + chunk summary
        total = session.summary()                # whole-stream summary

    The controller / PROWAVES / activity state persists across chunks, so
    a chunked run equals a one-shot `simulate` of the concatenated trace:
    per-interval records bit for bit, the running summary up to the float
    re-association of the partial sums. A chunk padded with `t_mask` (for
    example the ragged last one, through `traffic.pad_trace`) freezes the
    carry on its masked intervals.
    """

    def __init__(self, sim: SimConfig, state: SimState, tables: dict,
                 device: torch.device):
        self.sim = sim
        self.device = device
        self._state = state
        self._tables = tables
        self._sums = None
        self.placement = normalize_placement(
            resolve_gateway_positions(sim.cfg), sim.cfg)

    @classmethod
    def init(cls, sim: SimConfig, *, device=None) -> "SimSession":
        """Open a session with a fresh state for `sim` on `device` (the
        card unless `device="cpu"`)."""
        dev = backend.resolve_device(device)
        return cls(sim, init_session_states(sim, 1, device=dev),
                   selection_tables_torch(sim.cfg, dev), dev)

    def swap_placement(self, positions) -> None:
        """Live gateway re-placement between chunks: new selection tables,
        the carried state streams on (an in-flight reconfiguration). The
        caller charges the physical cost (faults.placement_reconfig_cost).
        """
        p = normalize_placement(positions, self.sim.cfg)
        self._tables = selection_tables_torch(
            self.sim.cfg.with_placement(p), self.device)
        self.placement = p

    @property
    def intervals_seen(self) -> int:
        """Valid (unmasked) intervals consumed so far."""
        return 0 if self._sums is None \
            else int(self._sums["valid_intervals"])

    def step_chunk(self, chunk: dict) -> dict:
        """Consume one trace chunk; returns its records and its summary.

        `chunk` is an ordinary (unbatched) trace dict, optionally with a
        `t_mask` and a fault frame. Masked intervals freeze the carry.
        """
        ext, mem, intra, ext_frac, t_mask, dest = \
            _trace_arrays(chunk, self.device)
        if ext.dim() != 2:
            raise ValueError(
                f"step_chunk takes one unbatched trace chunk "
                f"(ext_load [T, C]), got ext_load {tuple(ext.shape)}")
        frame = _trace_faults(chunk, self.device)
        self._state, recs, sums = _session_run(
            self._state, ext[None], mem[None], intra[None], ext_frac[None],
            t_mask[None], self._tables, self.sim,
            dest=None if dest is None else dest[None], frame=frame)
        sums = {k: v[0] for k, v in sums.items()}
        self._sums = sums if self._sums is None else \
            {k: self._sums[k] + v for k, v in sums.items()}
        return {"records": {k: v[0] for k, v in recs.items()},
                "summary": _summary_from_sums(sums, self.sim.cfg.n_chiplets)}

    def summary(self) -> dict:
        """Running summary over every interval streamed so far."""
        if self._sums is None:
            raise ValueError("summary() before any step_chunk() — the "
                             "session has consumed no intervals yet")
        return _summary_from_sums(self._sums, self.sim.cfg.n_chiplets)


def simulate_stream(chunks, sim: SimConfig, *, device=None) -> dict:
    """Drive a fresh `SimSession` over an iterable of trace chunks; returns
    the whole-stream summary, the chunk count and the session."""
    session = SimSession.init(sim, device=device)
    n = 0
    for chunk in chunks:
        session.step_chunk(chunk)
        n += 1
    if n == 0:
        raise ValueError("simulate_stream() got an empty chunk iterable")
    return {"summary": session.summary(), "chunks": n, "session": session}


def init_session_states(sim: SimConfig, lanes: int, *,
                        device=None) -> SimState:
    """Batched fresh session carries, a `SimState` with leading [lanes]:
    every lane the state a standalone `SimSession.init` holds."""
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    dev = backend.resolve_device(device)
    return _initial_state(sim, default_knobs(sim, lanes, dev))


def session_tick(states: SimState, batch: dict, tables: dict,
                 sim: SimConfig, frame: Optional[dict] = None):
    """Advance B packed session lanes one chunk: B lanes of one interval
    loop (one `epoch_step` launch on the card for RESIPI / RESIPI_ALL).

    `batch` is a lane-stacked chunk dict: ext_load [B, T, C], mem_load
    [B, T], int_load [B, T, C], ext_frac [B], t_mask [B, T] and optionally
    dest [B, C, C]. Lane k steps exactly as `SimSession.step_chunk` on the
    same chunk; an all-masked lane freezes its carry and adds zero to
    every sum. `frame` (optional) is one fault frame (gw_ok / stuck_on
    [T, C, G], drift_db [T]) shared by every lane: faults live on hardware
    time. Returns (new_states, records, sums), each with a leading [B]
    axis; `states` is left as it was, so a caller may roll lanes back.
    """
    dev = states.ctl.g.device
    ext = _as_f32(batch["ext_load"], dev)
    mem = _as_f32(batch["mem_load"], dev)
    t_mask = _as_f32(batch["t_mask"], dev)
    if ext.dim() != 3 or mem.dim() != 2 or t_mask.dim() != 2:
        raise ValueError(
            f"session_tick takes lane-stacked chunks (ext_load [B, T, C], "
            f"mem_load [B, T], t_mask [B, T]); got ext_load "
            f"{tuple(ext.shape)}, mem_load {tuple(mem.shape)}, t_mask "
            f"{tuple(t_mask.shape)}")
    dest = batch.get("dest")
    flt = None if frame is None else \
        _frame_arrays(frame, int(mem.shape[1]), dev, "tick chunk")
    return _session_run(states, ext, mem, _as_f32(batch["int_load"], dev),
                        _as_f32(batch["ext_frac"], dev), t_mask, tables, sim,
                        dest=None if dest is None else _as_f32(dest, dev),
                        frame=flt)


def session_sums_zero(*, device=None) -> dict:
    """The additive identity of the per-session totals: a never-served
    session's partial summary is well-formed instead of raising."""
    dev = backend.resolve_device(device)
    return {k: torch.zeros((), dtype=_F32, device=dev)
            for k in ("latency", "power_mw", "energy", "gateways",
                      "wavelengths", "saturated", "reconfig_nj",
                      "valid_intervals")}


def summary_from_sums(sums: dict, n_chiplets: int) -> dict:
    """The summary of accumulated totals (a whole session or a partial
    one): valid-interval means."""
    return _summary_from_sums(sums, n_chiplets)


# ---------------------------------------------------------------------------
# Padded topology sweeps
# ---------------------------------------------------------------------------

# Shape-defining topology axes that `sweep_topology` pads to the grid
# maxima: K topologies run as K lanes of one padded interval loop (one
# `epoch_step` launch on the card for RESIPI / RESIPI_ALL). Each value of
# `gateway_positions` is a placement (a tuple of (x, y) router coordinates
# in activation order, or None for the default edge scheme).
TOPOLOGY_SWEEPABLE_FIELDS = ("n_chiplets", "gateways_per_chiplet",
                             "mesh_radix", "gateway_positions")


def topology_point_config(sim: SimConfig, *, n_chiplets: int = None,
                          gateways_per_chiplet: int = None,
                          mesh_radix: int = None,
                          gateway_positions=None) -> SimConfig:
    """The unpadded SimConfig equal to one `sweep_topology` grid point.

    The controller's gateway bounds are clamped to the topology's
    per-chiplet gateway count, as the padded engine clamps them.
    `gateway_positions` pins the point's placement (None keeps the base
    config's, which a `mesh_radix` change resets to the default edge
    scheme).
    """
    cfg = sim.cfg.with_topology(n_chiplets=n_chiplets,
                                gateways_per_chiplet=gateways_per_chiplet,
                                mesh_radix=mesh_radix)
    if gateway_positions is not None:
        cfg = cfg.with_placement(normalize_placement(gateway_positions))
    g = cfg.max_gateways_per_chiplet
    ctl = dataclasses.replace(
        sim.ctl, max_gateways=min(sim.ctl.max_gateways, g),
        min_gateways=min(sim.ctl.min_gateways, g))
    return dataclasses.replace(sim, cfg=cfg, ctl=ctl)


def _ndim(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else int(np.ndim(x))


def _topo_grid_len(name: str, values) -> int:
    """Length of one swept grid, rejecting scalars with a clear message."""
    if name == "gateway_positions":
        if not isinstance(values, (list, tuple)):
            raise ValueError(
                f"swept field {name!r} must be a list of placements "
                f"(each a tuple of (x, y) pairs or None), got "
                f"{type(values).__name__}")
        return len(values)
    a = _numeric_grid(name, values)
    if a.ndim != 1:
        raise ValueError(
            f"swept field {name!r} must be a 1-D grid of values, got "
            f"shape {a.shape} — wrap a single value as [{name}_value]")
    return int(a.shape[0])


@dataclasses.dataclass(frozen=True)
class _TopologyGrid:
    """A prepared topology grid: the padded config and K points."""
    sim: SimConfig          # the padded shape: the grid maxima
    cfgs: tuple             # each point's NetworkConfig
    topo: dict              # per point [K] / [K, G] tensors
    knobs: dict             # per point [K] runtime knob grids (numpy)
    n_chiplets: np.ndarray  # [K] int, on the host
    c_max: int


def _prepare_topology_sweep(sim: SimConfig, grids: dict, device,
                            pad_chiplets: Optional[int] = None
                            ) -> _TopologyGrid:
    """Split grids into topology axes and runtime knobs; build the padded
    config, the per-point topology rows (hop and access-loss tables, mesh
    scalars, gateway totals) and the per-point controller clamps
    (max = min(user max, g_k), min = min(user min, that max)).
    `pad_chiplets` widens the padded chiplet axis past the grid's
    largest point."""
    if not grids:
        raise ValueError("sweep_topology() needs at least one field=values "
                         f"pair from {TOPOLOGY_SWEEPABLE_FIELDS}")
    lengths = {k: _topo_grid_len(k, v) for k, v in grids.items()}
    topo_grids = {k: list(v) for k, v in grids.items()
                  if k in TOPOLOGY_SWEEPABLE_FIELDS}
    other = {k: v for k, v in grids.items()
             if k not in TOPOLOGY_SWEEPABLE_FIELDS}
    unknown = set(other) - set(SWEEPABLE_FIELDS)
    if unknown:
        raise ValueError(
            f"non-sweepable fields: {sorted(unknown)} (topology: "
            f"{TOPOLOGY_SWEEPABLE_FIELDS}, runtime: {SWEEPABLE_FIELDS})")
    if not topo_grids:
        raise ValueError("no topology fields swept — use sweep() for "
                         "runtime-only grids")
    if len(set(lengths.values())) != 1:
        raise ValueError(f"swept fields must share one length, "
                         f"got {lengths}")
    k = next(iter(lengths.values()))

    cfg = sim.cfg
    cs = [int(x) for x in topo_grids.get("n_chiplets",
                                         [cfg.n_chiplets] * k)]
    gs = [int(x) for x in topo_grids.get(
        "gateways_per_chiplet", [cfg.max_gateways_per_chiplet] * k)]
    rs = [int(x) for x in topo_grids.get("mesh_radix", [cfg.mesh_x] * k)]
    if "gateway_positions" in topo_grids:
        ps = [normalize_placement(p)
              for p in topo_grids["gateway_positions"]]
    else:
        # A mesh_radix change drops the base config's explicit placement
        # (its coordinates belong to the old mesh), as with_topology and
        # topology_point_config do.
        ps = [normalize_placement(cfg.gateway_positions)
              if r == cfg.mesh_x and r == cfg.mesh_y else None
              for r in rs]
    if min(cs) < 1 or min(gs) < 1 or min(rs) < 2:
        raise ValueError(f"invalid topology grid: n_chiplets {cs}, "
                         f"gateways {gs}, radix {rs}")
    for i, (g, p) in enumerate(zip(gs, ps)):
        avail = N_DEFAULT_EDGE_SLOTS if p is None else len(p)
        if g > avail:
            raise ValueError(
                f"grid point {i}: gateways_per_chiplet={g} exceeds the "
                f"{avail} placed gateway positions "
                f"({'default edge scheme' if p is None else p})")

    cfgs = tuple(dataclasses.replace(
        cfg.with_topology(n_chiplets=c, gateways_per_chiplet=g,
                          mesh_radix=r), gateway_positions=p)
                 for c, g, r, p in zip(cs, gs, rs, ps))
    c_max, g_max, r_max = max(cs), max(gs), max(rs)
    if pad_chiplets is not None:
        if int(pad_chiplets) < c_max:
            raise ValueError(f"pad_chiplets={pad_chiplets} is smaller than "
                             f"the grid's largest n_chiplets ({c_max})")
        c_max = int(pad_chiplets)
    ptab = padded_selection_tables_torch(cfgs, (g_max, r_max * r_max),
                                         device)
    f32 = dict(dtype=_F32, device=device)
    topo = {
        "n_chiplets": torch.tensor(cs, dtype=_I32, device=device),
        "g_max": torch.tensor(gs, dtype=_I32, device=device),
        "src_hops": ptab["src_hops"],                        # [K, g_max]
        "gw_loss_db": ptab["gw_loss_db"],                    # [K, g_max]
        "mesh_hops": torch.tensor(
            [np.float32(uniform_mesh_mean_hops(c)) for c in cfgs], **f32),
        "mesh_x": torch.tensor(rs, **f32),
        "total_gateways": torch.tensor([c.total_gateways for c in cfgs],
                                       **f32),
    }
    knobs = {f: _runtime_grid(f, v) for f, v in other.items()}
    user_max = knobs.pop("max_gateways", sim.ctl.max_gateways)
    user_min = knobs.pop("min_gateways", sim.ctl.min_gateways)
    maxg = np.minimum(np.broadcast_to(np.asarray(user_max, np.int32), (k,)),
                      np.asarray(gs, np.int32))
    knobs["max_gateways"] = maxg
    knobs["min_gateways"] = np.minimum(
        np.broadcast_to(np.asarray(user_min, np.int32), (k,)), maxg)
    sim_p = dataclasses.replace(sim, cfg=dataclasses.replace(
        cfg, n_chiplets=c_max, max_gateways_per_chiplet=g_max,
        mesh_x=r_max, mesh_y=r_max))
    return _TopologyGrid(sim_p, cfgs, topo, knobs, np.asarray(cs, np.int64),
                         c_max)


def _topo_trace_arrays(trace_or_batch, c_max: int, device) -> tuple:
    """`_trace_arrays` narrowed to the padded chiplet axis; refuses fault
    frames and traces narrower than the grid."""
    if _has_faults(trace_or_batch):
        raise ValueError(
            "fault frames are not supported on the padded-topology paths "
            "(sweep_topology / shard_sweep): fault frames are compiled "
            "against ONE topology's [C, G] slot grid and cannot be "
            "re-padded per grid point. strip_faults(trace) first, or use "
            "simulate / sweep_faults on a fixed topology.")
    ext, mem, intra, ext_frac, t_mask, dest = _trace_arrays(trace_or_batch,
                                                            device)
    if ext.shape[-1] < c_max:
        raise ValueError(
            f"trace covers {ext.shape[-1]} chiplets but the grid needs "
            f"{c_max}; generate it with cfg.with_topology(n_chiplets="
            f"{c_max}) (see traffic.generate_trace)")
    if dest is not None:
        # Narrowed and re-normalized once here; each lane then masks it to
        # its own chiplet count (`_pair_destinations`).
        dest = renormalize_rows(dest[..., :c_max, :c_max])
    return (ext[..., :c_max], mem, intra[..., :c_max], ext_frac, t_mask,
            dest)


def lane_topology(topo: dict, point: torch.Tensor, c_max: int) -> dict:
    """Each lane's topology, the `topo` of the padded interval loop: the
    point's rows (`n_chiplets`, `g_max` [B] int; `src_hops`, `gw_loss_db`
    [B, G]; `mesh_hops`, `mesh_x`, `total_gateways` [B]) picked by
    `point` [B], plus `chip_mask` [B, C] (1.0 on the lane's real chiplets)
    and `nreal` [B] = max(sum(chip_mask), 1), the divisor of every mean
    over chiplets."""
    out = {k: v[point] for k, v in topo.items()}
    mask = (torch.arange(c_max, device=point.device)[None, :]
            < out["n_chiplets"][:, None]).to(_F32)
    out["chip_mask"] = mask
    out["nreal"] = torch.clamp_min(torch.sum(mask, dim=-1), 1.0)
    return out


def _pair_destinations(dest: torch.Tensor, lane_trace: np.ndarray,
                       n_chip: np.ndarray, c_max: int):
    """The destination matrix of each distinct (trace, chiplet count) pair
    of the lanes: the trace's matrix with the padded chiplets' rows and
    columns zeroed and the rows re-normalized. Returns (matrices [P, C, C],
    each lane's pair index [B] int32, each pair's trace [P] int32)."""
    keys = lane_trace.astype(np.int64) * (c_max + 1) + n_chip
    uniq, inv = np.unique(keys, return_inverse=True)
    dev = dest.device
    pn = torch.as_tensor(uniq // (c_max + 1), device=dev)
    pc = torch.as_tensor(uniq % (c_max + 1), device=dev)
    m = (torch.arange(c_max, device=dev)[None, :] < pc[:, None]).to(_F32)
    d = dest[pn] * m[:, None, :] * m[:, :, None]
    row = torch.sum(d, dim=-1, keepdim=True)
    pairs = torch.where(row > 0.0, d / torch.clamp_min(row, 1e-12),
                        torch.zeros_like(d))
    return (pairs,
            torch.as_tensor(inv.reshape(-1).astype(np.int32), device=dev),
            pn.to(_I32))


def topology_inputs(batch, sim: SimConfig, *, device=None, zipped=False,
                    pad_chiplets=None, **grids):
    """What the padded entry points hand the interval loop: `(sim_p,
    state0, xs, kwargs, nreal)` such that ``_scan_trace(state0, xs, sim_p,
    None, **kwargs)`` runs the grid. `batch` is one trace, a list of traces
    or a `stack_traces` dict. N traces x K points run as N*K
    trace-major lanes (lane n*K + k: trace n, point k); `zipped=True` runs
    K lanes, lane k on trace k with point k (N must be K). `nreal` [B] is
    each lane's real chiplet count (the wavelength summary's divisor).
    `pad_chiplets` pads the chiplet axis wider than the grid needs. Each
    stage is a span (`topology.prepare`, `.trace_arrays`, `.lanes`,
    `.dest_pairs`, `.initial_state`)."""
    tables = backend.LAYER_TABLES
    dev = backend.resolve_device(device)
    with backend.span("topology.prepare", tables):
        grid = _prepare_topology_sweep(sim, grids, dev, pad_chiplets)
    with backend.span("topology.trace_arrays", tables):
        ext, mem, intra, ext_frac, t_mask, dest = _topo_trace_arrays(
            _stacked(batch), grid.c_max, dev)
    with backend.span("topology.lanes", tables):
        if ext.dim() == 2:
            ext, mem, intra, t_mask = ext[None], mem[None], intra[None], \
                t_mask[None]
            ext_frac = ext_frac.reshape(1)
            dest = None if dest is None else dest[None]
        n, k = int(ext.shape[0]), int(grid.n_chiplets.shape[0])
        if zipped:
            if n != k:
                raise ValueError(f"{n} traces for {k} grid points: zipped "
                                 f"lanes need one trace per point")
            lane_np, point_np = np.arange(k), np.arange(k)
        else:
            lane_np = np.repeat(np.arange(n), k)
            point_np = np.tile(np.arange(k), n)
        lane_trace = torch.as_tensor(lane_np, device=dev)
        point = torch.as_tensor(point_np, device=dev)
        knobs = default_knobs(grid.sim, len(lane_np), dev,
                              {f: torch.as_tensor(v[point_np], device=dev)
                               for f, v in grid.knobs.items()})
        topo = lane_topology(grid.topo, point, grid.c_max)
        xs = (ext * t_mask[..., None], mem * t_mask,
              intra * t_mask[..., None],
              ext_frac.reshape(n, 1).expand_as(mem), t_mask)
        kwargs = dict(lane_trace=lane_trace, knobs=knobs, topo=topo)
    with backend.span("topology.dest_pairs", tables):
        if dest is not None:
            kwargs["dest"], kwargs["dest_index"], kwargs["pair_trace"] = \
                _pair_destinations(dest, lane_np, grid.n_chiplets[point_np],
                                   grid.c_max)
    with backend.span("topology.initial_state", tables):
        state0 = _initial_state(grid.sim, knobs, topo)
    return grid.sim, state0, xs, kwargs, topo["nreal"]


def _topo_run(batch, sim: SimConfig, shape, *, device, zipped=False,
              pad_chiplets=None, **grids) -> dict:
    """Shared body of the padded entry points: the grid's lanes through
    `_run_lanes` (mean wavelengths over each lane's real chiplets); every
    result's lane axis reshaped to `shape`."""
    sim_p, state0, xs, kw, nreal = topology_inputs(
        batch, sim, device=device, zipped=zipped, pad_chiplets=pad_chiplets,
        **grids)
    return _run_lanes(sim_p, state0, xs, None, kw, nreal, shape)


def _topo_points(grids) -> int:
    return next(_topo_grid_len(k, v) for k, v in grids.items()) \
        if grids else 0


def sweep_topology(trace: dict, sim: SimConfig, *, device=None,
                   **grids) -> dict:
    """Topology DSE over shape-changing axes as one padded run, e.g.
    ``sweep_topology(tr, sim, n_chiplets=[4, 16, 64],
    gateways_per_chiplet=[4, 4, 2])``.

    Every field (TOPOLOGY_SWEEPABLE_FIELDS, and any SWEEPABLE_FIELDS) is a
    1-D grid of one common length K; the grids zip into K points, which run
    as K lanes padded to the grid maxima (one `epoch_step` launch on the
    card for RESIPI / RESIPI_ALL). Padded chiplets and gateway slots hold
    zero load, g = 0 and lambda = 0 throughout, so they add exactly zero to
    every reduction: a point padded to its own size equals unpadded
    `simulate` of `topology_point_config(sim, ...)`. The trace must cover
    max(n_chiplets) chiplets; point k reads its first n_chiplets columns.
    Results carry a leading [K] axis; per-chiplet records are padded to
    the grid maximum. Runs on the card unless `device="cpu"`.
    """
    if _ndim(trace["ext_load"]) != 2:
        raise ValueError("sweep_topology takes one trace (ext_load [T, C]); "
                         "use sweep_topology_batch for a batch")
    with backend.span("sweep_topology", backend.LAYER_ENTRY):
        return _topo_run(trace, sim, (_topo_points(grids),), device=device,
                         **grids)


def sweep_topology_batch(traces, sim: SimConfig, *, devices=None,
                         device=None, **grids) -> dict:
    """N traces x K topologies as N*K trace-major lanes of one padded run
    ([N, K] results). `traces` is a list of same-width trace dicts (ragged
    lengths pad under a `t_mask`) or a `stack_traces` dict. `devices` with
    more than one entry shards the K axis (see `shard_sweep`). Opens the
    entry span `sweep_topology`, as `sweep_topology` and `shard_sweep` do."""
    if devices is not None and len(list(devices)) > 1:
        return shard_sweep(traces, sim, devices=devices, **grids)
    if devices is not None and device is None:
        device = list(devices)[0]
    with backend.span("sweep_topology", backend.LAYER_ENTRY):
        batch = _stacked(traces)
        return _topo_run(batch, sim, (int(np.shape(batch["ext_load"])[0]),
                                      _topo_points(grids)),
                         device=device, **grids)


def _sharding_note(out: dict, describe: dict) -> dict:
    """Attach the sharding description to a sweep result: the pad-lane
    count in the summary, the whole description under "sharding"."""
    out = dict(out)
    if "summary" in out and isinstance(out["summary"], dict):
        out["summary"] = dict(out["summary"],
                              pad_lanes=int(describe["pad_lanes"]))
    out["sharding"] = dict(describe)
    return out


def _grid_sharding(k: int, devices, device, logical_axis: str = "sweep"):
    """The `GridSharding` of a K-point grid: over `devices` (and every
    process of the fleet) when they are more than one or a fleet is up,
    else one block on this process's `device` (default the first of
    `devices`, else the card). Returns (sharding, whether sharded)."""
    from repro_torch.core.distributed import GridSharding, process_count

    if devices is not None and (len(list(devices)) > 1
                                or process_count() > 1):
        return GridSharding(k, devices=devices,
                            logical_axis=logical_axis), True
    if devices is not None and device is None:
        device = list(devices)[0]
    return GridSharding(k, devices=[backend.resolve_device(device)],
                        logical_axis=logical_axis,
                        across_processes=False), False


def _block_inputs(state0: SimState, xs: tuple, tables, kw: dict, nreal,
                  lanes: np.ndarray, device, host: dict) -> tuple:
    """The loop inputs of lanes `lanes` (indices into the run's lane axis)
    on `device`: the carry and every per-lane input picked, the traces
    (and destination matrices) narrowed to those the lanes read and
    renumbered, the rest moved. `host` caches the host copies of the lane
    maps, filled on first use."""
    src = state0.ctl.g.device
    if not host:
        for k in ("lane_trace", "dest_index", "pair_trace"):
            if kw.get(k) is not None:
                if kw[k].is_cuda:
                    backend.count_host_read("simulator._block_inputs",
                                            kw[k].nbytes)
                host[k] = kw[k].cpu().numpy()
    sel = torch.as_tensor(lanes, device=src)

    def take(a):
        return a[sel].to(device)

    def move(a):
        return a.to(device) if isinstance(a, torch.Tensor) else a

    def narrow(a, keep):
        if keep is None:
            return move(a)
        return a[torch.as_tensor(keep, device=a.device)].to(device)

    traces, lane_trace = np.unique(host["lane_trace"][lanes],
                                   return_inverse=True)
    keep = None if np.array_equal(traces, np.arange(int(xs[0].shape[0]))) \
        else traces
    out = {k: move(v) for k, v in kw.items()}
    out["lane_trace"] = torch.as_tensor(lane_trace.astype(np.int64),
                                        device=device)
    out["knobs"] = {k: take(v) for k, v in kw["knobs"].items()}
    if kw.get("topo") is not None:
        out["topo"] = {k: take(v) for k, v in kw["topo"].items()}
    if kw.get("dest_index") is not None:
        pairs, dest_index = np.unique(host["dest_index"][lanes],
                                      return_inverse=True)
        out["dest"] = narrow(kw["dest"], pairs)
        out["dest_index"] = torch.as_tensor(dest_index.astype(np.int32),
                                            device=device)
        out["pair_trace"] = torch.as_tensor(np.searchsorted(
            traces, host["pair_trace"][pairs]).astype(np.int32),
            device=device)
    elif kw.get("dest") is not None:
        out["dest"] = narrow(kw["dest"], keep)
    state = SimState(
        ctl=ControllerState(g=take(state0.ctl.g),
                            packets_seen=take(state0.ctl.packets_seen),
                            epoch=take(state0.ctl.epoch)),
        wavelengths=take(state0.wavelengths),
        prev_active=take(state0.prev_active))
    tables = None if tables is None else {k: move(v)
                                          for k, v in tables.items()}
    return (state, tuple(narrow(a, keep) for a in xs), tables, out,
            take(nreal) if isinstance(nreal, torch.Tensor) else nreal)


def _run_blocks(gs, sim: SimConfig, state0: SimState, xs: tuple, tables,
                kw: dict, nreal, shape) -> dict:
    """A split run of lanes shaped `shape` (trace-major, the grid `gs`, a
    sharded `GridSharding`, on its last axis): this process's blocks of
    the grid each through `_run_lanes`, gathered on every process. Every
    block runs at the whole run's padded shapes and is pinned to its
    `epoch_step` design (`_pin_design`), so the gathered result equals
    the one-device run's bit for bit."""
    *lead, k = shape
    n_lanes = int(kw["lane_trace"].shape[0])
    outs, host = [], {}
    for dev, idx in gs.local_blocks():
        lanes = (np.arange(int(np.prod(lead)))[:, None] * k
                 + idx[None, :]).reshape(-1)
        state_b, xs_b, tables_b, kw_b, nreal_b = _block_inputs(
            state0, xs, tables, kw, nreal, lanes, dev, host)
        _pin_design(sim, xs_b, kw_b, n_lanes)
        outs.append(_run_lanes(sim, state_b, xs_b, tables_b, kw_b, nreal_b,
                               (*lead, len(idx))))
    return gs.gather(outs, axis=len(lead))


def shard_sweep(traces, sim: SimConfig, *, devices=None, device=None,
                **grids) -> dict:
    """The topology sweep of `sweep_topology` / `sweep_topology_batch` (a
    single trace dict, or a list / stacked batch with a leading [N] axis)
    with the K (topology) axis sharded over `devices` (this process's;
    entries may repeat) and, after `distributed.init_distributed`, over
    every process of the fleet: K padded to the device count by repeating
    the last point, block i of the padded grid run on device i (every
    trace's lanes of its points), the blocks gathered on every process.
    Every block runs at the full grid's padded shapes and `epoch_step`
    design, so the result equals the one-device call bit for bit. The
    result carries `summary["pad_lanes"]` and a top-level `"sharding"`
    description. One device in one process runs `device` (default the
    first of `devices`, else the card) as one run of every lane. A failure
    in the sharded path raises; nothing falls back."""
    batched = not (isinstance(traces, dict)
                   and _ndim(traces["ext_load"]) == 2)
    k = _topo_points(grids)
    with backend.span("sweep_topology", backend.LAYER_ENTRY):
        gs, sharded = _grid_sharding(k, devices, device)
        batch = _stacked(traces) if batched else traces
        sim_p, state0, xs, kw, nreal = topology_inputs(
            batch, sim, device=gs.devices[0], **grids)
        shape = (int(np.shape(batch["ext_load"])[0]), k) if batched \
            else (k,)
        if sharded:
            out = _run_blocks(gs, sim_p, state0, xs, None, kw, nreal, shape)
        else:
            out = _run_lanes(sim_p, state0, xs, None, kw, nreal, shape)
        return _sharding_note(out, gs.describe())


# ---------------------------------------------------------------------------
# Workload sweeps
# ---------------------------------------------------------------------------

def _workload_keys(keys, seed: int, k: int, device) -> torch.Tensor:
    """[K, 2] twin keys: `split(prng_key(seed), K)` by default, else the
    given keys (a [K, 2] tensor or array of uint32 pairs)."""
    from repro_torch import random as trandom

    if keys is None:
        return trandom.split(trandom.prng_key(seed, device=device), k)
    if len(keys) != k:
        raise ValueError(f"{len(keys)} keys for {k} specs")
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(keys).astype(np.int64), device=device)


def sweep_workload(specs, sim: SimConfig, *, seed: int = 0, keys=None,
                   dest: bool = False, devices=None, gen_chiplets=None,
                   pad_chiplets=None, device=None, **grids) -> dict:
    """Workload DSE: K traffic specs as K lanes of one run, e.g.
    ``sweep_workload([ParsecSpec("dedup", 64), UniformSpec(n_intervals=32)],
    sim, device="cpu")``.

    Spec k (a `traffic.TrafficSpec` or a PARSEC app name) is generated from
    key k of `split(prng_key(seed), K)` (or of `keys`, [K, 2]), with its
    destination matrix when `dest=True`; the K traces, mixed lengths
    welcome, pad to the longest under a `t_mask`. Every grid zips lane for
    lane with the specs: TOPOLOGY_SWEEPABLE_FIELDS grids make the run a
    padded one (traces generated at the grid's widest `n_chiplets`, or at
    `gen_chiplets`), SWEEPABLE_FIELDS grids alone an unpadded one on
    `sim.cfg`. Results carry a leading [K] axis; lane k equals `simulate`
    of its own trace.

    `devices` with more than one entry (this process's; entries may
    repeat), or one per process after `distributed.init_distributed`,
    shards the K lanes as `shard_sweep` shards points: K padded by
    repeating the last lane, every block at the whole grid's padded shapes
    and `epoch_step` design, the result bitwise the one-device call's, with
    `summary["pad_lanes"]` and a `"sharding"` description. An
    emulated-host worker running a slice of a bigger grid passes the full
    grid's `gen_chiplets` and its slice of the full grid's keys, so its
    lanes are the full run's rows, and the full grid's `pad_chiplets` (the
    padded chiplet axis, at most `gen_chiplets`; default the slice's
    largest point), so they are the full run's bit for bit.
    """
    specs = [traffic.as_spec(s) for s in specs]
    if not specs:
        raise ValueError("sweep_workload() needs at least one traffic spec")
    k = len(specs)
    gs, sharded = _grid_sharding(k, devices, device)
    dev = gs.devices[0]
    keys = _workload_keys(keys, seed, k, dev)
    for name, v in grids.items():
        n = _topo_grid_len(name, v)
        if n != k:
            raise ValueError(
                f"grid {name!r} has length {n} but {k} workload specs "
                f"were given — workload zips element-wise with every grid")
    topo_grids = {g: v for g, v in grids.items()
                  if g in TOPOLOGY_SWEEPABLE_FIELDS}
    if topo_grids:
        c_gen = max(int(c) for c in topo_grids.get(
            "n_chiplets", [sim.cfg.n_chiplets]))
        if gen_chiplets is not None:
            if int(gen_chiplets) < c_gen:
                raise ValueError(
                    f"gen_chiplets={gen_chiplets} is smaller than the "
                    f"grid's largest n_chiplets ({c_gen})")
            c_gen = int(gen_chiplets)
        if pad_chiplets is not None and int(pad_chiplets) > c_gen:
            raise ValueError(f"pad_chiplets={pad_chiplets} is wider than "
                             f"the traces ({c_gen} chiplets)")
        gen_cfg = sim.cfg.with_topology(n_chiplets=c_gen)
    else:
        if pad_chiplets is not None:
            raise ValueError("pad_chiplets pads a topology grid; no "
                             "topology field is swept")
        unknown = set(grids) - set(SWEEPABLE_FIELDS)
        if unknown:
            raise ValueError(
                f"non-sweepable fields: {sorted(unknown)} (topology: "
                f"{TOPOLOGY_SWEEPABLE_FIELDS}, runtime: {SWEEPABLE_FIELDS})")
        gen_cfg = sim.cfg
    batch = _stacked([traffic.generate(s, keys[i], gen_cfg, dest=dest,
                                       device=dev)
                      for i, s in enumerate(specs)])
    if topo_grids:
        sim_p, state0, xs, kw, nreal = topology_inputs(
            batch, sim, device=dev, zipped=True, pad_chiplets=pad_chiplets,
            **grids)
        tables = None
    else:
        sim_p, nreal = sim, sim.cfg.n_chiplets
        state0, xs, tables, kw = epoch_inputs(batch, sim, device=dev,
                                              faults=False, zipped=True,
                                              **grids)
    if not sharded:
        return _run_lanes(sim_p, state0, xs, tables, kw, nreal, (k,))
    return _sharding_note(_run_blocks(gs, sim_p, state0, xs, tables, kw,
                                      nreal, (k,)), gs.describe())


# ---------------------------------------------------------------------------
# Placement sweeps and the host placement search
# ---------------------------------------------------------------------------

# The summary schema of `_summary_from_sums`, in a fixed order.
SUMMARY_KEYS = ("mean_latency", "mean_power_mw", "mean_energy",
                "mean_gateways", "mean_wavelengths", "saturated_frac",
                "total_reconfig_nj", "valid_intervals")

# Short objective names accepted by the placement search.
PLACEMENT_OBJECTIVE_ALIASES = {"latency": "mean_latency",
                               "power": "mean_power_mw",
                               "energy": "mean_energy"}


def check_placement_objective(objective: str) -> None:
    """Validate a placement-search objective name."""
    if objective == "inter_latency":
        return
    if PLACEMENT_OBJECTIVE_ALIASES.get(objective, objective) \
            not in SUMMARY_KEYS:
        raise ValueError(
            f"unknown placement objective {objective!r} (use "
            f"'inter_latency', 'latency', 'power', 'energy' or a summary "
            f"key: {sorted(SUMMARY_KEYS)})")


def simulate_eager(trace: dict, sim: SimConfig, *, device=None) -> dict:
    """`simulate` with the selection tables rebuilt on every call (the
    reference's seed-parity baseline for engine benchmarks; not for
    sweeps). Like the reference's, it reads no fault frame. Runs on the
    card unless `device="cpu"`."""
    trace = _checked(trace)
    dev = backend.resolve_device(device)
    state0, xs, _, kw = epoch_inputs(trace, sim, device=dev, faults=False)
    return _run_lanes(sim, state0, xs, rebuild_selection_tables(sim.cfg, dev),
                      kw, sim.cfg.n_chiplets, ())


def clear_engine_caches() -> None:
    """Drop every cache the port's engine holds: the search's and the
    co-design's memoized device tables, the destination matrices and the
    device views of the selection tables (padded and unpadded), so the
    next call builds and copies them anew, as a first call does. The
    design-time numpy tables stay memoized, as in the reference, so
    `engine_stats()["selection_table_builds"]` keeps counting."""
    from repro_torch.core.pareto import clear_codesign_caches
    from repro_torch.core.search import clear_search_caches
    from repro_torch.core.selection import (_selection_tables_torch_cached,
                                            clear_padded_table_caches)
    from repro_torch.core.traffic.dest import clear_destination_caches

    clear_search_caches()
    clear_codesign_caches()
    clear_destination_caches()
    clear_padded_table_caches()
    _selection_tables_torch_cached.cache_clear()


def rebuild_selection_tables(cfg: NetworkConfig, device=None) -> dict:
    """An uncached table build (bypassing both caches) for baselines."""
    return build_selection_tables.__wrapped__(cfg).as_torch(
        backend.resolve_device(device))


def sweep_placement(trace: dict, sim: SimConfig, placements, *,
                    device=None, **grids) -> dict:
    """K candidate gateway placements as K lanes of one padded run (sugar
    for ``sweep_topology(..., gateway_positions=placements)``): each a tuple
    of (x, y) router coordinates in activation order, or None for the
    default edge scheme. Any other TOPOLOGY_SWEEPABLE_FIELDS /
    SWEEPABLE_FIELDS grid of length K zips in. Lane k equals `simulate`
    with ``cfg.with_placement(placements[k])``."""
    return sweep_topology(trace, sim, device=device,
                          gateway_positions=list(placements), **grids)


def sweep_placement_batch(traces, sim: SimConfig, placements, *,
                          device=None, **grids) -> dict:
    """N traces x K placements ([N, K] results)."""
    return sweep_topology_batch(traces, sim, device=device,
                                gateway_positions=list(placements), **grids)


def _placement_scores(summary: dict, inter_latency: np.ndarray,
                      objective: str) -> np.ndarray:
    """Per-lane scalar objective from host copies of a sweep's results."""
    check_placement_objective(objective)
    if objective == "inter_latency":
        # Per-interval traffic-weighted inter-chiplet latency, [K, T] -> [K].
        return np.mean(inter_latency, axis=-1)
    return np.asarray(
        summary[PLACEMENT_OBJECTIVE_ALIASES.get(objective, objective)])


@dataclasses.dataclass(frozen=True)
class PlacementScoring:
    """What `score_placement_tables` reads, built once per device search
    (before its generation loop, so the loop copies nothing to the card):
    B lanes of one trace on `sim.cfg`'s own topology that differ only in
    their placement's two table columns."""
    sim: SimConfig
    state0: SimState
    xs: tuple               # (ext, mem, intra, ext_frac, t_mask) [1, T, ...]
    kwargs: dict            # lane_trace, knobs, dest, dest_index, pair_trace
    topo: dict              # the lanes' topology rows but the two columns
    t_mask: torch.Tensor    # [B, T]


def placement_scoring(trace: dict, sim: SimConfig, lanes: int, *,
                      device=None,
                      overrides: Optional[Dict[str, torch.Tensor]] = None
                      ) -> PlacementScoring:
    """The inputs of `score_placement_tables` for `lanes` lanes of one
    trace (loads t_mask-multiplied; a destination matrix as the trace
    gives it, as the reference's device engine prices it); `overrides`
    holds per-lane [B] knob tensors (`default_knobs`). The lanes' topology
    is `sim.cfg`'s for every lane, the padded loop's `topo` without
    padding: `n_chiplets`, `g_max`, `mesh_hops`, `mesh_x` (the mesh-feed
    width) and `total_gateways` expanded over the lanes, `chip_mask` all
    ones and `nreal` the chiplet count."""
    dev = backend.resolve_device(device)
    ext, mem, intra, ext_frac, t_mask, dest = _trace_arrays(trace, dev)
    if ext.dim() != 2:
        raise ValueError("a placement search takes one trace (ext_load "
                         "[T, C])")
    cfg = sim.cfg
    c = int(ext.shape[-1])
    if c != cfg.n_chiplets:
        raise ValueError(f"trace covers {c} chiplets but the config has "
                         f"{cfg.n_chiplets}")
    xs = (ext[None] * t_mask[None, :, None], mem[None] * t_mask[None],
          intra[None] * t_mask[None, :, None],
          torch.broadcast_to(ext_frac, mem.shape)[None], t_mask[None])
    knobs = default_knobs(sim, lanes, dev, overrides)
    i32 = dict(dtype=_I32, device=dev)
    f32 = dict(dtype=_F32, device=dev)
    mask = torch.ones((lanes, c), **f32)
    topo = {"n_chiplets": torch.full((lanes,), c, **i32),
            "g_max": torch.full((lanes,), cfg.max_gateways_per_chiplet,
                                **i32),
            "mesh_hops": torch.full(
                (lanes,), float(np.float32(uniform_mesh_mean_hops(cfg))),
                **f32),
            "mesh_x": torch.full((lanes,), topology.feed_width(cfg), **f32),
            "total_gateways": torch.full((lanes,), cfg.total_gateways,
                                         **f32),
            "chip_mask": mask,
            "nreal": torch.clamp_min(torch.sum(mask, dim=-1), 1.0)}
    kwargs = {"lane_trace": torch.zeros((lanes,), dtype=torch.long,
                                        device=dev), "knobs": knobs}
    if dest is not None:
        kwargs.update(dest=dest[None],
                      dest_index=torch.zeros((lanes,), **i32),
                      pair_trace=torch.zeros((1,), **i32))
    return PlacementScoring(sim, _initial_state(sim, knobs, topo), xs,
                            kwargs, topo, xs[4].expand(lanes, -1))


def score_placement_tables(scoring: PlacementScoring,
                           src_hops: torch.Tensor, gw_loss_db: torch.Tensor,
                           objective: str) -> tuple:
    """Score B placements from their table columns (`src_hops`,
    `gw_loss_db` [B, G], e.g. `selection.placement_tables_torch`) as B
    lanes of one interval loop: one `epoch_step` launch on CUDA tensors
    for RESIPI / RESIPI_ALL, the plain loop on CPU tensors. Returns
    (scores [B], summaries [B, len(SUMMARY_KEYS)]) on the device, reading
    nothing back: the objective is the mean over every interval of
    `mean_inter_latency` (its sum times float32(1/T), as XLA compiles
    `jnp.mean`) or a summary key."""
    topo = dict(scoring.topo, src_hops=src_hops, gw_loss_db=gw_loss_db)
    _, recs = _scan_trace(scoring.state0, scoring.xs, scoring.sim, None,
                          topo=topo, **scoring.kwargs)
    summary = _summary_from_sums(_record_sums(recs, scoring.t_mask),
                                 topo["nreal"])
    summaries = torch.stack([summary[k] for k in SUMMARY_KEYS], dim=1)
    if objective == "inter_latency":
        inter = recs["mean_inter_latency"]
        scores = torch.sum(inter, dim=1) \
            * float(np.float32(1.0 / inter.shape[1]))
    else:
        scores = summary[PLACEMENT_OBJECTIVE_ALIASES.get(objective,
                                                         objective)]
    return scores, summaries


@dataclasses.dataclass(frozen=True)
class CodesignScoring:
    """What `score_codesign_tables` reads, built once per co-design search
    (before its generation loop, so the loop copies nothing to the card):
    the lanes of one generation, every topology point x island x candidate
    x workload ([T, K, P, W], workload fastest), on the padded config
    `sim`, that differ only in their placement's two table columns."""
    sim: SimConfig          # the padded shape: the grid maxima
    state0: SimState
    xs: tuple               # (ext, mem, intra, ext_frac, t_mask) [W, T, ...]
    kwargs: dict            # lane_trace, knobs, dest, dest_index, pair_trace
    topo: dict              # the lanes' topology rows but the two columns
    t_mask: torch.Tensor    # [B, T]
    shape: tuple            # (T, K, P, W)


def codesign_scoring(sim: SimConfig, topo: dict, knobs: dict, arrays: tuple,
                     population: int, n_chiplets: np.ndarray
                     ) -> CodesignScoring:
    """The inputs of `score_codesign_tables` on the device of `arrays`.

    `sim` is the padded config, `topo` each point's rows ([T] tensors:
    `n_chiplets`, `g_max`, `mesh_hops`, `mesh_x` the mesh-feed width,
    `total_gateways`), `knobs` the runtime knobs of each (point, island)
    ([T, K] numpy, the gateway bounds already clamped to the point),
    `arrays` `_topo_trace_arrays` of the W workloads and `n_chiplets` [T]
    each point's chiplet count on the host. Lane ((t * K + k) * P + p) * W
    + w runs workload w on point t with island k's knobs; each (workload,
    chiplet count) pair gets its own destination matrix."""
    ext, mem, intra, ext_frac, t_mask, dest = arrays
    if ext.dim() == 2:
        ext, mem, intra, t_mask = ext[None], mem[None], intra[None], \
            t_mask[None]
        ext_frac = ext_frac.reshape(1)
        dest = None if dest is None else dest[None]
    dev = ext.device
    n_w = int(ext.shape[0])
    n_t, n_k = next(iter(knobs.values())).shape
    shape = (n_t, n_k, population, n_w)
    per_point = n_k * population * n_w
    point_np = np.repeat(np.arange(n_t), per_point)
    island_np = np.tile(np.repeat(np.arange(n_k), population * n_w), n_t)
    lane_np = np.tile(np.arange(n_w), n_t * n_k * population)
    point = torch.as_tensor(point_np, device=dev)
    lane_trace = torch.as_tensor(lane_np, device=dev)
    lane_knobs = default_knobs(
        sim, len(lane_np), dev,
        {f: torch.as_tensor(v[point_np, island_np], device=dev)
         for f, v in knobs.items()})
    c_max = sim.cfg.n_chiplets
    lane_topo = lane_topology(topo, point, c_max)
    xs = (ext * t_mask[..., None], mem * t_mask, intra * t_mask[..., None],
          ext_frac.reshape(n_w, 1).expand_as(mem), t_mask)
    kwargs = dict(lane_trace=lane_trace, knobs=lane_knobs)
    if dest is not None:
        kwargs["dest"], kwargs["dest_index"], kwargs["pair_trace"] = \
            _pair_destinations(dest, lane_np,
                               np.asarray(n_chiplets)[point_np], c_max)
    return CodesignScoring(sim, _initial_state(sim, lane_knobs, lane_topo),
                           xs, kwargs, lane_topo, xs[4][lane_trace], shape)


# The co-design's objectives, the columns of its [.., 3] arrays.
CODESIGN_OBJECTIVES = ("mean_latency", "mean_power_mw", "mean_energy")


def score_codesign_tables(scoring: CodesignScoring, src_hops: torch.Tensor,
                          gw_loss_db: torch.Tensor) -> torch.Tensor:
    """Score every candidate of a co-design generation from its table
    columns (`src_hops`, `gw_loss_db` [T, K, P, G]) as the T*K*P*W lanes
    of one interval loop: one `epoch_step` launch on CUDA tensors, the
    plain loop on CPU tensors. Returns the objectives [T, K, P, 3]
    (CODESIGN_OBJECTIVES) averaged over the W workloads as XLA compiles
    the reference's `jnp.mean`: the sum in workload order times
    float32(1 / W). Reads nothing back."""
    n_t, n_k, n_p, n_w = scoring.shape
    g = int(src_hops.shape[-1])

    def lanes(a):
        return a[..., None, :].expand(n_t, n_k, n_p, n_w, g).reshape(-1, g)

    topo = dict(scoring.topo, src_hops=lanes(src_hops),
                gw_loss_db=lanes(gw_loss_db))
    _, recs = _scan_trace(scoring.state0, scoring.xs, scoring.sim, None,
                          topo=topo, **scoring.kwargs)
    summary = _summary_from_sums(_record_sums(recs, scoring.t_mask),
                                 topo["nreal"])
    per_w = torch.stack([summary[k] for k in CODESIGN_OBJECTIVES], dim=-1) \
        .reshape(n_t, n_k, n_p, n_w, len(CODESIGN_OBJECTIVES))
    total = per_w[..., 0, :]
    for w in range(1, n_w):
        total = total + per_w[..., w, :]
    return total * float(np.float32(1.0 / n_w))


def search_placement(trace: dict, sim: SimConfig, *,
                     objective: str = "inter_latency",
                     generations: int = 10, population: int = 12,
                     seed: int = 0, init=None, temperature: float = 0.05,
                     cooling: float = 0.7, restart_frac: float = 0.25,
                     engine: str = "device", blocked_positions=None,
                     device=None) -> dict:
    """Annealed gateway-placement search.

    Per generation: the incumbent, single-gateway moves around it
    (spread-reordered by the controller's activation rule) and random
    restarts are scored; the incumbent moves greedily downhill and uphill
    with annealed probability, and the best placement ever scored is
    kept. The default edge scheme is scored in generation 0. Two engines:

      * `engine="device"` (the default, `search.search_placement_device`):
        proposals, table columns, scoring, acceptance and history stay on
        the device, the draws those of the reference's device engine (the
        threefry twin); one `epoch_step` launch per generation on the card
        (RESIPI / RESIPI_ALL), no host synchronization between
        generations, one device-to-host copy per search. For parallel
        chains see `search_placement_islands`.
      * `engine="host"`: candidates drawn from `np.random.RandomState(seed)`
        in the reference host engine's order, each generation scored by
        one `sweep_placement` call and read back once.

    `blocked_positions` excludes routers from every proposal; an `init`
    on a blocked router raises (repair it with `search.repair_placement`).

    Returns {best_placement, best_score, best_summary, default_placement,
    default_score, improvement_frac, history, ...}, one history entry per
    generation.
    """
    if engine == "device":
        from repro_torch.core.search import search_placement_device

        return search_placement_device(
            trace, sim, objective=objective, generations=generations,
            population=population, seed=seed, init=init,
            temperature=temperature, cooling=cooling,
            restart_frac=restart_frac, blocked_positions=blocked_positions,
            device=device)
    if engine != "host":
        raise ValueError(f"unknown engine {engine!r} (use 'device' or "
                         f"'host')")
    if population < 2:
        raise ValueError("population must be >= 2 (incumbent + candidates)")
    if generations < 1:
        raise ValueError("generations must be >= 1")
    check_placement_objective(objective)
    import math

    from repro_torch.core.search import repair_placement

    cfg = sim.cfg
    gmax = cfg.max_gateways_per_chiplet
    blocked = {(int(x), int(y)) for (x, y) in (blocked_positions or ())}
    coords = [(int(x), int(y)) for x, y in topology.router_coords(cfg)
              if (int(x), int(y)) not in blocked]
    if len(coords) < gmax:
        raise ValueError(
            f"{len(blocked)} blocked routers leave only {len(coords)} "
            f"allowed positions for {gmax} gateways")
    rng = np.random.RandomState(seed)

    default_p = normalize_placement(resolve_gateway_positions(cfg), cfg)
    if set(default_p) & blocked:
        default_p = repair_placement(default_p, blocked, cfg)
    parent = default_p if init is None else normalize_placement(init, cfg)
    if set(parent) & blocked:
        raise ValueError(
            f"init placement occupies blocked routers "
            f"{sorted(set(parent) & blocked)} — repair it first "
            f"(search.repair_placement)")

    def random_placement():
        idx = rng.choice(len(coords), size=gmax, replace=False)
        return normalize_placement([coords[i] for i in idx], cfg,
                                   order="spread")

    def mutate(p, moves):
        pos = list(p)
        occupied = set(pos)
        for _ in range(moves):
            i = int(rng.randint(len(pos)))
            free = [c for c in coords if c not in occupied]
            if not free:
                break
            occupied.remove(pos[i])
            pos[i] = free[int(rng.randint(len(free)))]
            occupied.add(pos[i])
        return normalize_placement(pos, cfg, order="spread")

    best_p, best_s, best_summary = None, np.inf, None
    default_s = None
    temp = temperature
    history = []
    for gen in range(generations):
        moves = 2 if gen < max(1, generations // 3) else 1
        cands = [parent]
        if gen == 0 and parent != default_p:
            cands.append(default_p)
        while len(cands) < population:
            cands.append(random_placement()
                         if rng.rand() < restart_frac else
                         mutate(parent, moves))
        out = sweep_placement(trace, sim, cands, device=device)
        # One device-to-host copy of everything the generation reads.
        packed = torch.cat(
            [torch.stack([out["summary"][k] for k in SUMMARY_KEYS], dim=1),
             out["records"]["mean_inter_latency"]], dim=1).cpu().numpy()
        summary = {k: packed[:, i] for i, k in enumerate(SUMMARY_KEYS)}
        scores = _placement_scores(summary, packed[:, len(SUMMARY_KEYS):],
                                   objective)
        if gen == 0:
            default_s = float(scores[cands.index(default_p)]
                              if default_p in cands else scores[0])
        ibest = int(np.argmin(scores))
        if scores[ibest] < best_s:
            best_p, best_s = cands[ibest], float(scores[ibest])
            best_summary = {k: float(v[ibest]) for k, v in summary.items()}
        # Annealed incumbent move: greedy downhill, probabilistic uphill.
        delta = float(scores[ibest] - scores[0])
        rel = delta / max(abs(float(scores[0])), 1e-12)
        accepted = delta < 0 or (temp > 0
                                 and rng.rand() < math.exp(-rel / temp))
        if accepted:
            parent = cands[ibest]
        history.append({
            "generation": gen,
            "parent_score": float(scores[0]),
            "best_candidate_score": float(scores[ibest]),
            "best_score": float(best_s),
            "accepted": bool(accepted),
            "latency": float(summary["mean_latency"][ibest]),
            "power_mw": float(summary["mean_power_mw"][ibest]),
            "energy": float(summary["mean_energy"][ibest]),
        })
        temp *= cooling

    return {"best_placement": best_p, "best_score": best_s,
            "best_summary": best_summary,
            "default_placement": default_p, "default_score": default_s,
            "improvement_frac": 1.0 - best_s / max(default_s, 1e-12),
            "objective": objective, "generations": generations,
            "population": population, "engine": "host", "history": history}


def __getattr__(name):
    # The device search's and the co-design's entry points, as the
    # reference re-exports them (core/search.py and core/pareto.py import
    # this module, so not at its top).
    if name in ("search_placement_device", "search_placement_islands"):
        from repro_torch.core import search as _search
        return getattr(_search, name)
    if name in ("search_codesign", "rescore_front_host"):
        from repro_torch.core import pareto as _pareto
        return getattr(_pareto, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
