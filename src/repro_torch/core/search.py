"""Placement search helpers (port of `repro.core.search`, in part).

Only the host-side `repair_placement` is ported so far; the device engine
of the placement search (`search_placement(engine="device")` and the
island search) is ROADMAP queue 1 item 5's next slice.
"""
from __future__ import annotations

from repro_torch.core import topology
from repro_torch.core.selection import normalize_placement


def repair_placement(placement, blocked_positions, cfg) -> tuple:
    """Move gateways off blocked routers to the nearest allowed free ones.

    Every gateway sitting on a blocked router relocates to the
    hop-nearest unoccupied allowed router (ties break by router index).
    Returns a spread-normalized placement valid under
    `blocked_positions`.
    """
    p = list(normalize_placement(placement, cfg))
    blocked = {(int(x), int(y)) for (x, y) in blocked_positions}
    occupied = set(p)
    free = [(int(x), int(y)) for x, y in topology.router_coords(cfg)
            if (x, y) not in blocked and (x, y) not in occupied]
    for i, pos in enumerate(p):
        if pos not in blocked:
            continue
        if not free:
            raise ValueError(
                f"cannot repair placement: {len(blocked)} blocked routers "
                f"leave no free position for the gateway at {pos}")
        j = min(range(len(free)),
                key=lambda k: (int(topology.pair_hops(cfg, free[k], pos)),
                               k))
        p[i] = free.pop(j)
    return normalize_placement(p, cfg, order="spread")
