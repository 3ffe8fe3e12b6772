"""Least work of one `noc_run` call of the flit model: bytes read once and
written once, and float operations, counted from its shapes (a frozen copy
of the counts the port's kernel bounds were taken with).

Operations per live node-cycle, counted from the kernel's arithmetic:
arrivals add, mask, link-rate min, router mask (4); the in-edge sum of
send (one add per node on average: every node has one out-edge); space sub
and max, want > 0, max with 1e-9, division, min with 1 (6); moved (1); the
in-edge sum of moved (1); land: sub, mask mul, add, drain min, sub (5);
the t_mask freeze of occupancy, residency and drained (8).
"""
from __future__ import annotations

OPS_PER_NODE_CYCLE = 26
# In-edges per node in the kernel's routing lists (six on hex layouts).
MAX_IN_DEGREE = 6
F32 = 4


def noc_work(runs: int, cycles: int, nodes: int, live: int, *,
             mask_t: bool = False, t_mask_passed: bool = False,
             max_in: int = MAX_IN_DEGREE) -> tuple:
    """(bytes, float ops) of one call of `runs` runs x `cycles` cycles over
    `nodes` padded nodes, `live` of them live in the static mask (summed
    over the runs). Read: arrivals (and the time-varying mask) in live
    lanes only, t_mask [B, T] only when the caller passes one, and the
    mask, drain, buffer and next hop [B, R] and in-edge lists [B, R,
    max_in] of every lane; written: residency, final occupancy and drained
    [B, R]. Operations: OPS_PER_NODE_CYCLE per live node-cycle."""
    f = F32
    planes = 1 + bool(mask_t)
    read = (planes * live * cycles + (runs * cycles if t_mask_passed else 0)
            + runs * nodes * (4 + max_in)) * f
    written = 3 * runs * nodes * f
    return read + written, live * cycles * OPS_PER_NODE_CYCLE
