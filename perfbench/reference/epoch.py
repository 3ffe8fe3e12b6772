"""Plain reference of the epoch-level ReSiPI model (RESIPI architecture).

A standalone restatement of the interval loop that `sweep_batch` and
`search_codesign` run: per-gateway loads through the selection tables,
the M/D/1 latency segments with the destination-aware fan-in term, the
PCM-gated interposer power, the Eq. 5-7 gateway controller and the
per-lane summaries. It imports nothing of the program: the selection
tables, mesh constants and destination sub-matrices are worked out here
from the configuration, in plain torch and numpy.

Every function takes a `dtype`: float32 is the reference, bfloat16 the
control (the same arithmetic one precision lower).
"""
from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Table 1 and the model constants the configuration file does not vary.
ROUTER_PIPELINE_CYCLES = 2.0
PHOTONIC_FLIGHT_CYCLES = 2.0
BURSTINESS = 3.0
FEED_LINKS = 2.0
RHO_CLIP = 0.995
LASER_MW_PER_WAVELENGTH = 30.0
TIA_MW = 2.0
TUNING_MW_PER_MR = 3.0
DRIVER_MW = 3.0
PCMC_RECONFIG_NJ = 2.0
CONTROLLER_LGC_UW = 172.0
CONTROLLER_INC_UW = 787.0
WAVEGUIDE_DB_PER_MM = 0.3

RECORD_FLOATS = ("latency", "power_mw", "laser_mw", "energy", "reconfig_nj",
                 "wavelengths", "gw_load", "mean_inter_latency")
RECORD_INTS = ("g", "saturated")


# ---------------------------------------------------------------------------
# Design-time tables
# ---------------------------------------------------------------------------

def mesh_coords(mx: int, my: int) -> np.ndarray:
    """[R, 2] router coordinates, row r = (r // my, r % my)."""
    xs, ys = np.meshgrid(np.arange(mx), np.arange(my), indexing="ij")
    return np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.int64)


def default_positions(mx: int, my: int, g: int) -> np.ndarray:
    """The edge-distributed default placement (south, north, west, east
    edges in activation order), first `g` rows."""
    pos = np.array([[1, 0], [mx - 2, my - 1], [0, my - 2], [mx - 1, 1]],
                   np.int64)
    if g > len(pos):
        raise ValueError(f"the default placement has {len(pos)} slots, "
                         f"{g} asked")
    return pos[:g]


def balanced_assignment(dist: np.ndarray, capacity: int) -> np.ndarray:
    """Greedy nearest-gateway partition of routers [R, G] distances under a
    per-gateway capacity: (distance, router, gateway) order, leftovers to
    the least-loaded gateway."""
    n_r, n_g = dist.shape
    rr, gg = np.divmod(np.arange(n_r * n_g), n_g)
    order = np.lexsort((gg, rr, dist.ravel()))
    assign = np.full((n_r,), -1, np.int64)
    load = np.zeros((n_g,), np.int64)
    for idx in order:
        r, g = rr[idx], gg[idx]
        if assign[r] == -1 and load[g] < capacity:
            assign[r] = g
            load[g] += 1
    for r in np.flatnonzero(assign == -1):
        g = int(np.argmin(load))
        assign[r] = g
        load[g] += 1
    return assign


def level_assignments(mx: int, my: int, positions) -> list:
    """Per activation level g = 1..G the router -> gateway assignment [R]
    under the capacity ceil(R / g), with the [R, G] hop matrix."""
    pos = np.asarray(positions, np.int64).reshape(-1, 2)
    routers = mesh_coords(mx, my)
    dist = np.abs(routers[:, None, :] - pos[None, :, :]).sum(-1)
    n_r = len(routers)
    out = []
    for g in range(1, len(pos) + 1):
        out.append(balanced_assignment(dist[:, :g], -(-n_r // g)))
    return out, dist


def selection_columns(mx: int, my: int, positions,
                      pitch_mm: float = 1.0) -> tuple:
    """(src_hops [G], gw_loss_db [G]) float32 of a placement: the mean
    router-to-gateway hops at each activation level, and the running mean
    of the active gateways' access-waveguide loss (distance to the nearest
    chiplet edge x pitch x dB/mm)."""
    pos = np.asarray(positions, np.int64).reshape(-1, 2)
    assigns, dist = level_assignments(mx, my, pos)
    src = np.array([dist[np.arange(len(a)), a].mean() for a in assigns],
                   np.float32)
    edge = np.minimum.reduce([pos[:, 0], mx - 1 - pos[:, 0], pos[:, 1],
                              my - 1 - pos[:, 1]])
    per_gw = (edge * pitch_mm * WAVEGUIDE_DB_PER_MM).astype(np.float32)
    levels = np.arange(1, len(pos) + 1)
    return src, (np.cumsum(per_gw) / levels).astype(np.float32)


def mesh_mean_hops(mx: int, my: int) -> float:
    """Mean hops between two uniformly random routers of an mx x my mesh."""
    return (mx * mx - 1) / (3.0 * mx) + (my * my - 1) / (3.0 * my)


def parsec_destinations(ext_frac: float, c: int) -> np.ndarray:
    """[C, C] row-stochastic destinations: ring-distance exponential decay
    with the scale 1 + 4 ext_frac, zero diagonal."""
    if c <= 1:
        return np.ones((c, c), np.float32)
    i = np.arange(c)
    hops = np.abs(i[:, None] - i[None, :])
    hops = np.minimum(hops, c - hops)
    d = np.exp(-hops / (1.0 + 4.0 * ext_frac)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return d / d.sum(axis=1, keepdims=True)


def narrowed_destinations(dest: torch.Tensor, c: int) -> torch.Tensor:
    """The destinations among the first `c` chiplets of a wider matrix
    [..., C, C], rows re-normalized (a row with no mass left stays 0)."""
    d = dest[..., :c, :c].to(torch.float32)
    row = torch.sum(d, dim=-1, keepdim=True)
    return torch.where(row > 0.0, d / torch.clamp_min(row, 1e-12),
                       torch.zeros_like(d))


# ---------------------------------------------------------------------------
# Queueing and power
# ---------------------------------------------------------------------------

def _md1_wait(rho, service, inv_sat):
    rho_eff = torch.clamp(rho * inv_sat, 0.0, RHO_CLIP)
    return BURSTINESS * rho_eff * service / (2.0 * (1.0 - rho_eff))


def _access_latency(hops, load, packet_flits, inv_sat, burst_scale=None):
    walk = hops * ROUTER_PIPELINE_CYCLES
    rho = torch.clamp(load * packet_flits / FEED_LINKS, 0.0, 1.0)
    wait = _md1_wait(rho, float(packet_flits), inv_sat)
    if burst_scale is not None:
        wait = wait * burst_scale
    return walk + wait


def _serialization(lam, packet_bits, gbps, ghz):
    return packet_bits / (lam * (gbps / ghz))


def _gateway_latency(load, s_eff, inv_sat):
    rho = torch.clamp(load * s_eff, 0.0, 1.0)
    return s_eff + _md1_wait(rho, s_eff, inv_sat) + PHOTONIC_FLIGHT_CYCLES


def _kappa(active):
    gt = torch.sum(active, dim=-1, keepdim=True)
    up = torch.cumsum(active, dim=-1) - active
    denom = torch.clamp_min(gt - up, 1.0)
    return torch.where(active[..., :-1] > 0, 1.0 / denom[..., :-1],
                       torch.zeros_like(denom[..., :-1]))


def _activity(g, gmax, mem_gw, dtype):
    slots = (torch.arange(gmax, device=g.device) < g[..., None]).to(dtype)
    mem = torch.ones(g.shape[:-1] + (mem_gw,), dtype=dtype, device=g.device)
    return torch.cat([slots.flatten(-2), mem], dim=-1)


def _pairwise_total(x: torch.Tensor) -> torch.Tensor:
    """Per-lane sums of [B, T, ...] over T, halving a zero-padded
    power-of-two interval axis (a fixed summation tree)."""
    t = x.shape[1]
    width = 1 << max(t - 1, 0).bit_length()
    if width != t:
        x = torch.cat([x, x.new_zeros((x.shape[0], width - t)
                                      + x.shape[2:])], dim=1)
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


# ---------------------------------------------------------------------------
# The interval loop
# ---------------------------------------------------------------------------

def run_lanes(lanes: dict, cfg: dict, *, dtype=torch.float32) -> dict:
    """Simulate B independent lanes of the RESIPI interposer.

    `lanes` holds per-lane tensors on one device: ext, intra [B, T, C],
    mem, t_mask [B, T], dest [B, C, C] (or None), the knobs l_m,
    buffer_sat, wavelengths [B] float and max_gateways, min_gateways [B]
    int, and the lane's tables src_hops, gw_loss_db [B, G] and
    n_chiplets [B] (the controller-power chiplet count). `cfg` holds the
    network constants (the configuration file's keys). Returns
    {"records": [B, T, ...] (floats as float32), "summary": [B]}.
    """
    ext0, intra0 = lanes["ext"], lanes["intra"]
    dev = ext0.device
    b, t_len, c = ext0.shape
    gmax = int(lanes["src_hops"].shape[1])
    mem_gw = int(cfg["memory_gateways"])
    flits = float(cfg["packet_flits"])
    packet_bits = float(cfg["packet_flits"] * cfg["flit_bits"])
    interval = float(np.float32(cfg["reconfig_interval_cycles"]))
    f = lambda x: x.to(device=dev, dtype=dtype)  # noqa: E731
    t_mask = f(lanes["t_mask"])
    ext_all = f(ext0) * t_mask[..., None]
    intra_all = f(intra0) * t_mask[..., None]
    mem_all = f(lanes["mem"]) * t_mask
    dest = None if lanes.get("dest") is None else f(lanes["dest"])
    l_m = f(lanes["l_m"])[:, None]
    sat = f(lanes["buffer_sat"])[:, None]
    inv_sat = 1.0 / sat
    lam = f(lanes["wavelengths"])[:, None]
    gmax_knob = lanes["max_gateways"].to(device=dev, dtype=torch.int32)
    gmin_knob = lanes["min_gateways"].to(device=dev, dtype=torch.int32)
    src_tab = f(lanes["src_hops"])
    loss_tab = f(lanes["gw_loss_db"])
    mesh_hops = torch.tensor(mesh_mean_hops(cfg["mesh_x"], cfg["mesh_y"]),
                             dtype=torch.float32).to(device=dev, dtype=dtype)
    mesh_feed = 2.0 * float(cfg["mesh_x"])
    controller = ((CONTROLLER_LGC_UW * f(lanes["n_chiplets"])
                   + CONTROLLER_INC_UW) / 1000.0)
    s_opt = _serialization(lam, packet_bits, cfg["link_gbps_per_wavelength"],
                           cfg["noc_freq_ghz"])
    s_eff = torch.clamp_min(s_opt, flits)

    g = gmax_knob[:, None].expand(b, c).clone()
    recs = {k: [] for k in RECORD_FLOATS + RECORD_INTS}
    for i in range(t_len):
        ext, intra, mem, tv = (ext_all[:, i], intra_all[:, i], mem_all[:, i],
                               t_mask[:, i])
        gf = torch.clamp_min(g.to(dtype), 1.0)
        lev = torch.clamp(g.long(), 1, gmax) - 1
        gw_load = ext / gf
        mem_load = mem / mem_gw
        src_hops = torch.gather(src_tab, 1, lev)
        mean_src = torch.mean(src_hops, dim=-1)
        access_db = torch.mean(torch.gather(loss_tab, 1, lev), dim=-1)
        if dest is None:
            dst_hops = mean_src[:, None] * torch.ones_like(src_hops)
            inter = (_access_latency(src_hops, gw_load, flits, inv_sat)
                     + _gateway_latency(gw_load, s_eff, inv_sat)
                     + _access_latency(dst_hops, gw_load, flits, inv_sat))
            pressure = ext
        else:
            w = ext[:, :, None] * dest
            recv = w[:, 0]
            sq = w[:, 0] * w[:, 0]
            for j in range(1, c):
                recv = recv + w[:, j]
                sq = sq + w[:, j] * w[:, j]
            phi = sq / torch.clamp_min(recv * recv, 1e-12)
            burst = (1.0 + (BURSTINESS - 1.0) * phi) * (1.0 / BURSTINESS)
            dst_leg = _access_latency(src_hops, recv / gf, flits, inv_sat,
                                      burst)
            inter = (_access_latency(src_hops, gw_load, flits, inv_sat)
                     + _gateway_latency(gw_load, s_eff, inv_sat)
                     + torch.matmul(dest, dst_leg[:, :, None])[..., 0])
            pressure = torch.maximum(ext, recv)
        mem_lat = (_access_latency(mean_src[:, None], mem_load[:, None],
                                   flits, inv_sat)
                   + _gateway_latency(mem_load[:, None], s_eff, inv_sat)
                   + _access_latency(1.0, mem_load[:, None], flits,
                                     inv_sat))[:, 0]
        link = intra * flits / mesh_feed
        intra_lat = (mesh_hops * ROUTER_PIPELINE_CYCLES + flits
                     + _md1_wait(torch.clamp(link, 0.0, 1.0), flits,
                                 inv_sat))
        tot_ext = torch.sum(ext, dim=-1) + 1e-9
        tot_int = torch.sum(intra, dim=-1) + 1e-9
        tot_mem = mem + 1e-9
        inter_w = torch.sum(inter * ext, dim=-1)
        lat = (inter_w + torch.sum(intra_lat * intra, dim=-1)
               + mem_lat * tot_mem) / (tot_ext + tot_int + tot_mem)

        # Power: the PCM-gated chain lights the active gateways' lambdas.
        active = _activity(g, gmax, mem_gw, dtype)
        lit = torch.sum(active * lam, dim=-1)
        laser = lit * LASER_MW_PER_WAVELENGTH
        laser = laser * 10.0 ** (access_db * 0.1)
        total = (laser + lit * TIA_MW + (lit + lit) * TUNING_MW_PER_MR
                 + lit * DRIVER_MW + controller)

        # Controller (Eqs. 5-7): meter the hotter of sent and received.
        load = pressure * interval / (interval * gf)
        inc = (load > l_m) & (g < gmax_knob[:, None])
        dec = (load < l_m * (1.0 - 1.0 / gf)) & (g > gmin_knob[:, None])
        g_new = torch.where(inc, g + 1, torch.where(dec, g - 1, g))
        new_active = _activity(g_new, gmax, mem_gw, dtype)
        switched = torch.sum((torch.abs(_kappa(new_active) - _kappa(active))
                              > 1e-6).to(dtype), dim=-1)
        reconf = switched * PCMC_RECONFIG_NJ

        tvc = tv[:, None]
        recs["latency"].append(lat * tv)
        recs["power_mw"].append(total * tv)
        recs["laser_mw"].append(laser * tv)
        recs["energy"].append(total * (lat * tv))
        recs["reconfig_nj"].append(reconf * tv)
        recs["wavelengths"].append(lam.expand(b, c) * tvc)
        recs["gw_load"].append(gw_load * tvc)
        recs["mean_inter_latency"].append(inter_w / tot_ext * tv)
        recs["g"].append(g * tv.to(torch.int32)[:, None])
        recs["saturated"].append(torch.any(gw_load * s_eff > sat, dim=-1)
                                 & (tv > 0))
        g = torch.where(tv[:, None] > 0, g_new, g)

    out = {k: torch.stack(v, dim=1) for k, v in recs.items()}
    for k in RECORD_FLOATS:
        out[k] = out[k].to(torch.float32)
    return {"records": out, "summary": summarize(out, lanes["t_mask"],
                                                 lanes["n_chiplets"])}


def summarize(recs: dict, t_mask: torch.Tensor,
              n_chiplets: torch.Tensor) -> dict:
    """Per-lane summaries of float32 records: pairwise-tree totals of the
    float records over the intervals, means per valid interval."""
    floats = ("latency", "power_mw", "energy", "reconfig_nj")
    tot = _pairwise_total(torch.stack([recs[k] for k in floats], dim=2))
    sums = dict(zip(floats, tot.unbind(dim=1)))
    valid = torch.sum(t_mask.to(torch.float32), dim=1)
    t = torch.clamp_min(valid, 1.0)
    gw = torch.sum(recs["g"], dim=(1, 2)).to(torch.float32)
    lam = torch.sum(recs["wavelengths"], dim=(1, 2))
    sat = torch.sum(recs["saturated"].to(torch.float32), dim=1)
    return {"mean_latency": sums["latency"] / t,
            "mean_power_mw": sums["power_mw"] / t,
            "mean_energy": sums["energy"] / t,
            "mean_gateways": gw / t,
            "mean_wavelengths": lam / (t * n_chiplets.to(torch.float32)),
            "saturated_frac": sat / t,
            "total_reconfig_nj": sums["reconfig_nj"],
            "valid_intervals": valid}


def network_constants(config: dict) -> dict:
    """The interval loop's constants from a configuration file."""
    keys = ("mesh_x", "mesh_y", "memory_gateways", "packet_flits",
            "flit_bits", "reconfig_interval_cycles",
            "link_gbps_per_wavelength", "noc_freq_ghz")
    return {k: config[k] for k in keys}
