"""Wrapper for the fused epoch-loop kernel: the plain loop's contract in
and out.

`epoch_run(state, xs, sim, tables, ...)` stands in for the plain interval
loop (`ref.epoch_run_reference`, i.e. `simulator._loop`) on the
configurations the kernel supports — RESIPI / RESIPI_ALL, unpadded
topology, at least one memory gateway, optional destination matrices and
fault frames. Given CUDA tensors it runs `csrc/epoch_step.cu` once for all
B lanes and T intervals and rebuilds the exact record dict and final
`SimState` the loop produces; given CPU tensors it runs the plain version.
There is no fallback: an unsupported configuration on CUDA tensors raises.

`variant(c, faulted, dest)` picks the kernel from the chiplet count alone:
"split" (C <= 16: the controller recurrence, one thread per lane and
chiplet, then the interval metrics, one thread per lane and interval) or
"warp" (the first design, one warp per lane, C <= 128). Each call counts one `epoch_step`
launch, and one under `epoch_step:<variant>`
(`backend.COUNTERS["variants"]`), whether the variant takes one kernel
launch or two.

Port of `repro.kernels.epoch_step.ops.epoch_run_pallas`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch.core import topology
from repro_torch.core.constants import PHOTONIC_POWER
from repro_torch.core.noc import uniform_mesh_mean_hops
from repro_torch.kernels.epoch_step.ref import epoch_run_reference

NAME = "epoch_step"
SOURCE = Path(__file__).resolve().parent / "csrc" / "epoch_step.cu"
MAX_CHIPLETS = 128            # "warp": kMaxChipletsPerThread * 32
SPLIT_MAX_CHIPLETS = 16       # "split": kMaxSplitChiplets in the source
KERNELS = {"split": 0, "warp": 1}
(COL_LATENCY, COL_POWER, COL_LASER, COL_RECONFIG, COL_MEAN_INTER,
 COL_SATURATED, COL_FAILED) = range(7)

# params row layout per lane (the kernel reads these five knobs).
PARAM_KNOBS = ("l_m", "max_gateways", "min_gateways", "buffer_sat",
               "wavelengths")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def n_cols(faulted: bool) -> int:
    """Columns of the kernel's `scal` output: six scalars per interval, plus
    the failed-slot count when fault frames ride along."""
    return 7 if faulted else 6


def build() -> ctypes.CDLL:
    """Build (or load the cached build of) the kernel library."""
    lib = backend.build_library(NAME, SOURCE)
    fn = lib.epoch_step_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 19 + [_I] * 9 + [_F] * 16 + [_P]
        fn.restype = _I
    return lib


def variant(c: int, faulted: bool, dest: bool) -> str:
    """The kernel that runs C chiplets (with or without fault frames and
    destination matrices, which every variant takes): "split" for
    C <= 16, "warp" up to 128. Raises beyond."""
    del faulted, dest                  # both variants take both
    if not 1 <= c <= MAX_CHIPLETS:
        raise ValueError(f"epoch_step kernel supports 1 to {MAX_CHIPLETS} "
                         f"chiplets, got {c}")
    return "split" if c <= SPLIT_MAX_CHIPLETS else "warp"


def _check_supported(sim, xs, faulted: bool) -> None:
    from repro_torch.core.simulator import KERNEL_ARCHS

    if sim.arch not in KERNEL_ARCHS:
        raise ValueError(f"epoch_step kernel supports RESIPI/RESIPI_ALL, "
                         f"got {sim.arch}")
    if sim.cfg.memory_gateways < 1:
        raise ValueError("epoch_step kernel needs >= 1 memory gateway "
                         "(the kappa chain's constant tail)")
    n, t, c = xs[0].shape
    if t < 1:
        raise ValueError("epoch_step kernel needs at least one interval")
    if c > MAX_CHIPLETS:
        raise ValueError(f"epoch_step kernel supports up to {MAX_CHIPLETS} "
                         f"chiplets, got {c}")
    if len(xs) != (8 if faulted else 5):
        raise ValueError("xs must be (ext, mem, intra, ext_frac, t_mask) "
                         "plus (gw_ok, stuck_on, drift_db) when faulted")


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def epoch_run(state, xs: tuple, sim, tables: dict, *,
              dest: Optional[torch.Tensor] = None, faulted: bool = False,
              lane_trace: Optional[torch.Tensor] = None,
              knobs: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[object, dict]:
    """Run T intervals of B lanes fused; returns (final SimState, records).

    Args:
      state: SimState of B lanes (g [B, C] is the kernel's carry).
      xs: (ext [N, T, C], mem [N, T], intra [N, T, C], ext_frac [N, T],
        t_mask [N, T]) plus (gw_ok [N, T, C, G], stuck_on [N, T, C, G],
        drift_db [N, T]) when `faulted`, loads already t_mask-multiplied.
      sim: SimConfig (static fields; the runtime knobs come from `knobs`).
      tables: selection tables (src_hops / gw_loss_db per level).
      dest: optional [N, C, C] destination matrices.
      lane_trace: [B] trace index per lane (default: lane n reads trace n).
      knobs: per-lane [B] knob tensors (default: the config's values).
    """
    if xs[0].device.type == "cpu":
        return epoch_run_reference(state, xs, sim, tables, dest=dest,
                                   faulted=faulted, lane_trace=lane_trace,
                                   knobs=knobs)
    out = launch(state.ctl.g, xs, sim, tables, dest=dest, faulted=faulted,
                 lane_trace=lane_trace, knobs=knobs)
    return _reassemble(state, out, xs, sim, faulted)


def launch(g0: torch.Tensor, xs: tuple, sim, tables: dict, *,
           dest: Optional[torch.Tensor] = None, faulted: bool = False,
           lane_trace: Optional[torch.Tensor] = None,
           knobs: Optional[Dict[str, torch.Tensor]] = None,
           kernel: Optional[str] = None) -> dict:
    """Run the kernel once on CUDA tensors (arguments as `epoch_run`,
    `g0` [B, C] the initial gateway counts) and return its raw outputs:
    scal [B, T, n_cols(faulted)], g_eff / g_des / gw_load [B, T, C] (g_des
    only when faulted), g_final [B, C], plus the int32 lane_trace and the
    knobs used. `kernel` names the variant (default `variant(...)`; tests
    and timing force the other on the same inputs). Runs on the current
    stream; never synchronizes."""
    from repro_torch.core.simulator import Arch, default_knobs

    dev = xs[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"epoch_step kernel needs CUDA tensors, got "
                           f"{dev}")
    _check_supported(sim, xs, faulted)
    c_count = xs[0].shape[2]
    chosen = variant(c_count, faulted, dest is not None)
    kernel = chosen if kernel is None else kernel
    if kernel not in KERNELS or (kernel == "split"
                                 and c_count > SPLIT_MAX_CHIPLETS):
        raise ValueError(f"epoch_step: the {kernel} kernel does not take "
                         f"{c_count} chiplets")
    lib = build()

    ext, mem, intra, _ext_frac, t_mask = (_f32(a) for a in xs[:5])
    n, t, c = ext.shape
    if lane_trace is None:
        lane_trace = torch.arange(n, device=dev)
    lane_trace = lane_trace.to(device=dev, dtype=torch.int32).contiguous()
    b = int(lane_trace.shape[0])
    if knobs is None:
        knobs = default_knobs(sim, b, dev)
    params = torch.stack([knobs[k].to(torch.float32) for k in PARAM_KNOBS],
                         dim=1).contiguous()
    g0 = _f32(g0)
    cfg = sim.cfg
    g_slots = cfg.max_gateways_per_chiplet
    srch = _f32(tables["src_hops"])
    gwdb = _f32(tables["gw_loss_db"])
    dmat = None if dest is None else _f32(dest)
    if faulted:
        gw_ok, stuck_on, drift = (_f32(a) for a in xs[5:8])
    else:
        gw_ok = stuck_on = drift = None
    for name, a, shape in (("g0", g0, (b, c)), ("src_hops", srch, (g_slots,)),
                           ("gw_loss_db", gwdb, (g_slots,)),
                           ("mem", mem, (n, t)), ("t_mask", t_mask, (n, t)),
                           ("intra", intra, (n, t, c)),
                           ("params", params, (b, len(PARAM_KNOBS))),
                           ("dest", dmat, (n, c, c)),
                           ("gw_ok", gw_ok, (n, t, c, g_slots)),
                           ("stuck_on", stuck_on, (n, t, c, g_slots)),
                           ("drift_db", drift, (n, t))):
        if a is not None and (tuple(a.shape) != shape or a.device != dev):
            raise ValueError(f"epoch_step: {name} must be {shape} on {dev}, "
                             f"got {tuple(a.shape)} on {a.device}")

    f32 = dict(dtype=torch.float32, device=dev)
    out = {"scal": torch.empty((b, t, n_cols(faulted)), **f32),
           "g_eff": torch.empty((b, t, c), **f32),
           "g_des": torch.empty((b, t, c), **f32) if faulted else None,
           "gw_load": torch.empty((b, t, c), **f32),
           "g_final": torch.empty((b, c), **f32),
           "lane_trace": lane_trace, "knobs": knobs}
    use_controller = sim.arch == Arch.RESIPI
    # The split's controller recurrence hands g after each interval to the
    # metrics launch through this scratch.
    g_step = torch.empty((b, t, c), **f32) \
        if kernel == "split" and use_controller else None
    noc = sim.noc
    pwr = PHOTONIC_POWER
    consts = (
        float(cfg.reconfig_interval_cycles), float(noc.burstiness),
        float(noc.router_pipeline_cycles), float(noc.photonic_flight_cycles),
        float(noc.feed_links), float(cfg.packet_flits),
        float(cfg.packet_bits),
        float(cfg.link_gbps_per_wavelength / cfg.noc_freq_ghz),
        float(np.float32(uniform_mesh_mean_hops(cfg))),
        2.0 * topology.feed_width(cfg),
        float(pwr.laser_mw_per_wavelength), float(pwr.tia_mw),
        float(pwr.tuning_mw_per_mr), float(pwr.driver_mw),
        float((pwr.controller_lgc_uw * cfg.n_chiplets
               + pwr.controller_inc_uw) / 1000.0),
        float(pwr.pcmc_reconfig_nj))
    err = lib.epoch_step_launch(
        _ptr(ext), _ptr(intra), _ptr(mem), _ptr(t_mask), _ptr(drift),
        _ptr(lane_trace), _ptr(params), _ptr(g0), _ptr(srch), _ptr(gwdb),
        _ptr(dmat), _ptr(gw_ok), _ptr(stuck_on), _ptr(out["scal"]),
        _ptr(out["g_eff"]), _ptr(out["g_des"]), _ptr(out["gw_load"]),
        _ptr(out["g_final"]), _ptr(g_step), b, t, c, g_slots,
        cfg.memory_gateways, int(dmat is not None), int(faulted),
        int(use_controller), KERNELS[kernel], *consts,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"epoch_step {kernel} kernel launch failed: CUDA "
                           f"error {err}")
    backend.count_launch(NAME, kernel)
    return out


def _reassemble(state, out: dict, xs: tuple, sim, faulted: bool):
    """The loop's record dict and final SimState from the kernel outputs
    (energy = power x latency; integer g; bool saturated; packets_seen
    zeroed and epoch advanced by the valid count only where some interval
    was valid; prev_active from the last valid fault frame)."""
    from repro_torch.core.simulator import (Arch, SimState, _activity_mask)
    from repro_torch.core.gateway_controller import ControllerState

    scal, out_g, out_gwl = out["scal"], out["g_eff"], out["gw_load"]
    lane_trace = out["lane_trace"].long()
    b, t, c = out_g.shape
    lane_mask = xs[4].to(torch.float32)[lane_trace]                  # [B, T]
    lam = out["knobs"]["wavelengths"].to(torch.float32)
    latency = scal[..., COL_LATENCY]
    power = scal[..., COL_POWER]
    recs = {
        "latency": latency,
        "power_mw": power,
        "laser_mw": scal[..., COL_LASER],
        "energy": power * latency,
        "reconfig_nj": scal[..., COL_RECONFIG],
        "g": out_g.to(torch.int32),
        "wavelengths": lam[:, None, None] * torch.ones_like(out_g)
                       * lane_mask[..., None],
        "gw_load": out_gwl,
        "mean_inter_latency": scal[..., COL_MEAN_INTER],
        "saturated": scal[..., COL_SATURATED] > 0.5,
    }
    if faulted:
        recs["g_desired"] = out["g_des"].to(torch.int32)
        recs["failed_slots"] = scal[..., COL_FAILED]

    n_valid = torch.sum(lane_mask, dim=1)
    any_valid = n_valid > 0
    g_fin = out["g_final"].to(torch.int32)
    if faulted:
        # Activity under the LAST VALID interval's fault frame.
        valid = (lane_mask > 0).to(torch.int32)
        last = (t - 1) - torch.argmax(torch.flip(valid, dims=[1]), dim=1)
        ok_l = xs[5].to(torch.float32)[lane_trace, last]             # [B,C,G]
        st_l = xs[6].to(torch.float32)[lane_trace, last]
        g_slots = sim.cfg.max_gateways_per_chiplet
        desired = (torch.arange(g_slots, device=g_fin.device)
                   < g_fin[..., None]).to(torch.float32)
        lit = torch.maximum(desired * ok_l, st_l * ok_l)
        mem_on = torch.ones((b, sim.cfg.memory_gateways),
                            dtype=torch.float32, device=g_fin.device)
        new_prev = torch.cat([lit.flatten(-2), mem_on], dim=-1) > 0.5
    else:
        new_prev = _activity_mask(g_fin, sim)
    keep = any_valid[:, None]
    if sim.arch == Arch.RESIPI:
        ctl = ControllerState(
            g=torch.where(keep, g_fin, state.ctl.g),
            packets_seen=torch.where(
                keep, torch.zeros_like(state.ctl.packets_seen),
                state.ctl.packets_seen),
            epoch=state.ctl.epoch + n_valid.to(torch.int32))
    else:
        ctl = state.ctl
    new_state = SimState(ctl=ctl, wavelengths=state.wavelengths,
                         prev_active=torch.where(keep, new_prev,
                                                 state.prev_active))
    return new_state, recs
