"""Epoch-level 2.5D network simulator (Level 1), batched over lanes.

Port of `repro.core.simulator` (unpadded paths). It simulates the four
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
from repro_torch.core.constants import (NETWORK, PHOTONIC_POWER,
                                        PROWAVES_MAX_WAVELENGTHS,
                                        PROWAVES_MIN_WAVELENGTHS,
                                        RESIPI_WAVELENGTHS, NetworkConfig)
from repro_torch.core.gateway_controller import (ControllerConfig,
                                                 ControllerState, epoch_step)
from repro_torch.core.noc import NocModel, uniform_mesh_mean_hops
from repro_torch.core.selection import (build_selection_tables,
                                        mean_access_hops, normalize_placement,
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
                      dest: Optional[torch.Tensor] = None) -> dict:
    """Latency/load metrics for one interval of B lanes.

    g [B, C] int; lam [B, 1] (one wavelength count per lane) or [B, C]
    (PROWAVES, per chiplet); ext/intra [B, C]; mem, t_valid [B]; extra_db
    [B] (fault-path loss drift); dest [B, C, C]. Every returned metric is
    multiplied by `t_valid`, so a padded interval contributes exactly zero
    to every reduction. `sim` is a lane config (`_lane_sim`).
    """
    noc = sim.noc
    gw_load = ext / torch.clamp_min(g.to(_F32), 1.0)                 # [B, C]
    mem_gw_load = mem / sim.cfg.memory_gateways                      # [B]

    src_hops = mean_access_hops(tables, g)                           # [B, C]
    mean_src_hops = torch.mean(src_hops, dim=-1)                     # [B]
    gw_db = tables["gw_loss_db"]
    access_db = torch.mean(
        gw_db[torch.clamp(g.long(), 1, gw_db.shape[0]) - 1], dim=-1)  # [B]
    lam_mem = lam[:, 0] if lam.shape[-1] == 1 \
        else torch.mean(lam, dim=-1)                                 # [B]
    mesh_hops = torch.tensor(np.float32(uniform_mesh_mean_hops(sim.cfg)),
                             device=ext.device)
    mesh_feed = 2.0 * topology.feed_width(sim.cfg)
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
        inter_lat = (noc.access_latency(src_hops, gw_load)
                     + noc.gateway_latency(gw_load, lam)
                     + torch.matmul(dest, dst_leg[:, :, None])[..., 0])
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
              faulted: bool = False, dest: Optional[torch.Tensor] = None):
    """Build the per-interval step of B lanes for the chosen architecture.

    `knobs` holds the per-lane runtime knobs ([B] tensors, `default_knobs`).
    `faulted` appends the fault-frame inputs (gw_ok [B, C, G], stuck_on
    [B, C, G], drift_db [B]): a failed slot carries no traffic, draws no
    power and charges no reconfiguration energy; a stuck-on cell burns power
    the controller cannot gate; drift erodes the optical budget. `dest` is
    the lanes' [B, C, C] destination matrices (per trace, constant in time).
    The step's input is the tuple (ext [B, C], mem [B], intra [B, C],
    ext_frac [B], t_valid [B]) plus the fault frames.
    """
    lane = _lane_sim(sim, knobs)
    cfg = sim.cfg
    interval = float(cfg.reconfig_interval_cycles)
    n_total = cfg.total_gateways
    gmax = cfg.max_gateways_per_chiplet
    n_c = cfg.n_chiplets

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
        if sim.arch in KERNEL_ARCHS:
            g = state.ctl.g
            lam = lane.wavelengths[:, None]
        elif sim.arch == Arch.PROWAVES:
            g = torch.ones((b, n_c), dtype=_I32, device=dev)
            lam = state.wavelengths.to(_F32)
        else:  # AWGR: all gateways, 1 lambda per port
            g = torch.full((b, n_c), gmax, dtype=_I32, device=dev)
            lam = torch.ones((b, 1), dtype=_F32, device=dev)

        if faulted:
            usable, active_eff = _lit_mask(g, gw_ok, stuck_on)
            g_eff = torch.sum(usable, dim=-1).to(_I32)
        else:
            g_eff = g

        m = _interval_metrics(g_eff, lam, ext, mem, intra, lane, tables,
                              t_valid, extra_db=drift_db, dest=dest)

        # --- power ---------------------------------------------------------
        active = active_eff if faulted else _activity_mask(g, sim)
        if sim.arch == Arch.PROWAVES:
            n_pw = n_c + cfg.memory_gateways
            w = state.wavelengths.to(_F32)
            if faulted:
                # A failed PROWAVES gateway takes its lasers down with it.
                w = w * gw_ok[..., 0]
            lam_mem = torch.mean(w, dim=-1, keepdim=True).expand(
                b, cfg.memory_gateways)
            pw = photonics.interposer_power_mw(
                torch.ones((b, n_pw), dtype=torch.bool, device=dev),
                torch.cat([w, lam_mem], dim=-1), n_gateways=n_pw,
                mode="wdm", loss_db=m["access_db"], n_chiplets=n_c)
        elif sim.arch == Arch.AWGR:
            pw = photonics.interposer_power_mw(
                active, active.to(_F32), n_gateways=n_total,
                loss_db=PHOTONIC_POWER.awgr_loss_db + m["access_db"],
                mode="static", n_chiplets=n_c)
        else:
            pw = photonics.interposer_power_mw(
                active, lane.wavelengths, n_gateways=n_total, mode="pcm",
                loss_db=m["access_db"], n_chiplets=n_c)

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
            new_state = SimState(ctl=state.ctl, wavelengths=lam_new,
                                 prev_active=active)
        else:
            new_state = SimState(ctl=state.ctl, wavelengths=state.wavelengths,
                                 prev_active=active)

        energy = pw["total_mw"] * m["latency"]
        lam_rec = lam * torch.ones((b, n_c), dtype=_F32, device=dev)
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

def engine_stats() -> dict:
    """Kernel launches and builds, plain-loop runs and table builds."""
    launches = dict(backend.COUNTERS["launches"])
    return {"epoch_step_launches": launches.get("epoch_step", 0),
            "kernel_launches": launches,
            "kernel_builds": dict(backend.COUNTERS["builds"]),
            "loop_runs": backend.COUNTERS["loop_runs"],
            "selection_table_builds":
                build_selection_tables.cache_info().misses}


def reset_engine_stats() -> None:
    backend.reset_counters()


def _initial_state(sim: SimConfig, knobs: Dict[str, torch.Tensor]
                   ) -> SimState:
    """Fresh unpadded state of B lanes; each lane's initial g is its own
    `max_gateways` knob (§3.3: "initially set to the maximum allowed")."""
    cfg = sim.cfg
    c = cfg.n_chiplets
    g0 = knobs["max_gateways"].to(_I32)
    b, dev = g0.shape[0], g0.device
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
          knobs: Optional[Dict[str, torch.Tensor]] = None
          ) -> Tuple[SimState, dict]:
    """The plain interval loop: `make_step` stepped over T.

    `xs` = (ext [N, T, C], mem [N, T], intra [N, T, C], ext_frac [N, T],
    t_mask [N, T]) plus (gw_ok [N, T, C, G], stuck_on [N, T, C, G],
    drift_db [N, T]) when `faulted`, loads already t_mask-multiplied; `dest`
    is [N, C, C]. Lane b reads trace `lane_trace[b]` (default: lane n reads
    trace n). Returns the final state and records [B, T, ...].
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
    step = make_step(sim, tables, knobs, faulted=faulted,
                     dest=None if dest is None else dest[lane_trace])
    recs = []
    for t in range(lanes[0].shape[1]):
        state, rec = step(state, tuple(a[:, t] for a in lanes))
        recs.append(rec)
    return state, {k: torch.stack([r[k] for r in recs], dim=1)
                   for k in recs[0]}


def _scan_trace(state: SimState, xs: tuple, sim: SimConfig, tables: dict,
                *, dest: Optional[torch.Tensor] = None, faulted: bool = False,
                lane_trace: Optional[torch.Tensor] = None,
                knobs: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[SimState, dict]:
    """Run the interval loop: the `epoch_step` kernel wrapper for the
    configurations it supports (the reference's gate, plus its >= 1
    memory gateway precondition), the plain loop for everything else."""
    if sim.arch in KERNEL_ARCHS and sim.cfg.memory_gateways >= 1:
        from repro_torch.kernels.epoch_step.ops import epoch_run
        return epoch_run(state, xs, sim, tables, dest=dest, faulted=faulted,
                         lane_trace=lane_trace, knobs=knobs)
    return _loop(state, xs, sim, tables, dest=dest, faulted=faulted,
                 lane_trace=lane_trace, knobs=knobs)


def _lane_total(x: torch.Tensor) -> torch.Tensor:
    """Per-lane sum of [B, T] over T in a fixed pairwise order (halving the
    interval axis, odd lengths padded with 0.0): lane b's total is the same
    float whatever B is and on either device."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def _record_sums(recs: dict, t_mask: torch.Tensor) -> dict:
    """Mask-correct per-lane record totals ([B] each); records are already
    t_valid-masked, so plain sums ignore padded intervals. Counts and
    integer-valued records sum exactly in any order; the float records go
    through `_lane_total`."""
    def tot(k):
        r = recs[k]
        return torch.sum(r, dim=tuple(range(1, r.dim())))
    return {
        "latency": _lane_total(recs["latency"]),
        "power_mw": _lane_total(recs["power_mw"]),
        "energy": _lane_total(recs["energy"]),
        "gateways": tot("g").to(_F32),
        "wavelengths": tot("wavelengths"),
        "saturated": torch.sum(recs["saturated"].to(_F32), dim=1),
        "reconfig_nj": _lane_total(recs["reconfig_nj"]),
        "valid_intervals": torch.sum(t_mask, dim=1),
    }


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


def _trace_arrays(trace: dict, device) -> tuple:
    """(ext, mem, intra, ext_frac, t_mask, dest) as float32 tensors on
    `device` — the one place trace dtypes are fixed (numpy float64 would
    otherwise ride through as float64). dest is None unless present."""
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


def _check_sweep_fields(fields, device) -> Dict[str, torch.Tensor]:
    """Sweep grids as [K] tensors: float grids as float32 and integer
    grids as int32 (a float64 grid would change controller decisions)."""
    if not fields:
        raise ValueError("sweep() needs at least one field=values pair")
    unknown = set(fields) - set(SWEEPABLE_FIELDS)
    if unknown:
        raise ValueError(f"non-sweepable fields: {sorted(unknown)} "
                         f"(sweepable: {SWEEPABLE_FIELDS})")
    ov = {}
    for k, v in fields.items():
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        elif np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
            a = a.astype(np.int32)
        else:
            raise ValueError(f"swept field {k!r} must be a numeric grid, "
                             f"got dtype {a.dtype}")
        ov[k] = a
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
    """
    if not traces:
        raise ValueError("stack_traces() needs at least one trace")
    for i, tr in enumerate(traces):
        traffic.validate_trace(tr, who=f"traces[{i}]")
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
        traces = [traffic.pad_trace(tr, max(lengths)) for tr in traces]
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
                 **fields):
    """What the entry points hand the interval loop, for N traces x K grid
    points (K = 1 without `fields`): `(state0, xs, tables, kwargs)` such
    that ``_scan_trace(state0, xs, sim, tables, **kwargs)`` — or the kernel
    wrapper `ops.epoch_run` and its plain version with the same arguments —
    runs lane n*K + k on trace n with grid point k.

    `traces` is one trace dict, a list of traces (ragged lengths pad under
    a `t_mask`) or a `stack_traces` dict. `faults=False` drops any fault
    frame (the sweeps, like the reference's, read none).
    """
    dev = backend.resolve_device(device)
    if isinstance(traces, (list, tuple)):
        batch = stack_traces(list(traces), pad=True)
    elif np.ndim(traces["ext_load"]) == 2:
        batch = stack_traces([traces])
    else:
        batch = traces
    ext, mem, intra, ext_frac, t_mask, dest = _trace_arrays(batch, dev)
    flt = _trace_faults(batch, dev) if faults else None
    ov = _check_sweep_fields(fields, dev) if fields else {}
    n = ext.shape[0]
    k = int(next(iter(ov.values())).shape[0]) if ov else 1
    lane_trace = torch.arange(n, device=dev).repeat_interleave(k)
    knobs = default_knobs(sim, n * k, dev,
                          {f: v.repeat(n) for f, v in ov.items()})
    # Masked intervals inject zero traffic (and record zeros downstream).
    ext = ext * t_mask[..., None]
    mem = mem * t_mask
    intra = intra * t_mask[..., None]
    xs = (ext, mem, intra, ext_frac.reshape(n, 1).expand_as(mem), t_mask)
    if flt is not None:
        xs = xs + flt
    kwargs = dict(dest=dest, faulted=flt is not None, lane_trace=lane_trace,
                  knobs=knobs)
    return (_initial_state(sim, knobs), xs,
            selection_tables_torch(sim.cfg, dev), kwargs)


def _run(traces, sim: SimConfig, shape, *, device, faults=True,
         **fields) -> dict:
    """Shared body of every entry point: N x K lanes through the interval
    loop, then the mask-correct summaries; the lane axis of every result
    is reshaped to `shape`."""
    state0, xs, tables, kw = epoch_inputs(traces, sim, device=device,
                                          faults=faults, **fields)
    _, recs = _scan_trace(state0, xs, sim, tables, **kw)
    lane_mask = xs[4][kw["lane_trace"]]
    summary = _summary_from_sums(_record_sums(recs, lane_mask),
                                 sim.cfg.n_chiplets)
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
    traffic.validate_trace(trace)
    return _run(trace, sim, (), device=device)


def _stacked(traces) -> dict:
    return stack_traces(list(traces), pad=True) \
        if isinstance(traces, (list, tuple)) else traces


def simulate_batch(traces, sim: SimConfig, *, device=None) -> dict:
    """N traces (a list, ragged lengths allowed, or a `stack_traces` dict)
    as N lanes of one run; results gain a leading [N] axis."""
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
    return _run(trace, sim, (_grid_len(fields),), device=device,
                faults=False, **fields)


def sweep_batch(traces, sim: SimConfig, *, device=None, **fields) -> dict:
    """The full DSE grid as N*K lanes: N traces x K grid points, results
    reshaped to leading [N, K] axes (trace-major)."""
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
    tm = t_mask.expand(k, t)
    xs = ((ext * t_mask[:, None]).expand(k, *ext.shape),
          (mem * t_mask).expand(k, t), (intra * t_mask[:, None])
          .expand(k, *intra.shape), ext_frac.expand(k, t), tm) + flt
    _, recs = _scan_trace(
        _initial_state(sim, knobs), xs, sim,
        selection_tables_torch(sim.cfg, dev),
        dest=None if dest is None else dest.expand(k, *dest.shape),
        faulted=True, lane_trace=torch.arange(k, device=dev), knobs=knobs)
    return {"records": recs,
            "summary": _summary_from_sums(_record_sums(recs, tm),
                                          sim.cfg.n_chiplets)}


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
