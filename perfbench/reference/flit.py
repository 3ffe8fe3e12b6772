"""Plain reference of the flit-level model of one chiplet's mesh (Fig. 13).

Topology: an r x r mesh whose routers send, by XY routing (x first), to
the gateway the balanced partition assigns them at activation level g;
one sink node per active gateway drains min(W x link rate / flit bits,
1 flit/cycle). Buffers hold `router_buffer_flits` at a router and
`gateway_buffer_flits` at a sink; runs padded past their nodes have dead
lanes (mask 0). Worked out here from the configuration, independent of
the program.

The cycle loop: inject, send at most one flit a cycle per router, scale
each destination's inflow by its free space, move, land and drain, and
accumulate residency, as plain tensor products with the one-hot routing
matrix. `dtype` is the arithmetic's precision (float32 the reference,
bfloat16 the control).
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.epoch import (default_positions, level_assignments,
                                       mesh_coords)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def topology(radix: int, g: int, wavelengths: int, cfg: dict,
             pad_to: int) -> tuple:
    """(next_mat [P, P], drain [P], buf [P], mask [P]) float32 numpy of
    one (mesh radix, active gateways, wavelengths) run padded to
    `pad_to` nodes."""
    mx = my = radix
    routers = mesh_coords(mx, my)
    gmax = int(cfg["max_gateways_per_chiplet"])
    pos = default_positions(mx, my, gmax)
    assign = level_assignments(mx, my, pos)[0][g - 1]
    r = len(routers)
    n = r + g
    if pad_to < n:
        raise ValueError(f"pad_to {pad_to} < {n} nodes")
    nxt = np.zeros((pad_to, pad_to), np.float32)
    for i, (x, y) in enumerate(routers):
        gx, gy = pos[assign[i]]
        if x == gx and y == gy:
            nxt[i, r + assign[i]] = 1.0
        elif x != gx:
            nxt[i, (x + np.sign(gx - x)) * my + y] = 1.0
        else:
            nxt[i, x * my + y + np.sign(gy - y)] = 1.0
    optical = wavelengths * cfg["link_gbps_per_wavelength"] / (
        cfg["flit_bits"] * cfg["noc_freq_ghz"])
    drain = np.zeros((pad_to,), np.float32)
    drain[r:n] = min(optical, 1.0)
    buf = np.zeros((pad_to,), np.float32)
    buf[:r] = float(cfg["router_buffer_flits"])
    buf[r:n] = float(cfg["gateway_buffer_flits"])
    mask = np.zeros((pad_to,), np.float32)
    mask[:n] = 1.0
    return nxt, drain, buf, mask


def run(arrivals: torch.Tensor, next_mat: torch.Tensor, drain: torch.Tensor,
        buf: torch.Tensor, mask: torch.Tensor, *, link_rate: float = 1.0,
        dtype=torch.float32) -> tuple:
    """Run T cycles of B runs: arrivals [B, T, R], next_mat [B, R, R],
    drain, buf, mask [B, R]. Returns (residency, final occupancy,
    drained) [B, R] float32."""
    f = lambda x: x.to(dtype)  # noqa: E731
    nmat, drain, buf, mask = f(next_mat), f(drain), f(buf), f(mask)
    is_router = torch.sign(torch.sum(nmat, dim=-1))
    occ0 = torch.zeros(mask.shape, dtype=dtype, device=mask.device)
    resid, drained = occ0, occ0
    for i in range(arrivals.shape[1]):
        occ = (occ0 + f(arrivals[:, i])) * mask
        send = torch.clamp(occ, max=link_rate) * is_router
        want = (send.unsqueeze(-2) @ nmat).squeeze(-2)
        space = torch.clamp(buf - occ, min=0.0)
        scale_dst = torch.where(
            want > 0.0, torch.clamp(space / torch.clamp(want, min=1e-9),
                                    max=1.0), 0.0)
        scale_src = (nmat @ scale_dst.unsqueeze(-1)).squeeze(-1)
        moved = send * scale_src
        inflow = (moved.unsqueeze(-2) @ nmat).squeeze(-2)
        occ = occ - moved + inflow * mask
        sunk = torch.minimum(occ, drain)
        occ = occ - sunk
        occ0, resid, drained = occ, resid + occ, drained + sunk
    return tuple(x.to(torch.float32) for x in (resid, occ0, drained))
