"""Least work of one `epoch_step` call: bytes read once and written once,
and float operations, counted from the call's shapes (a frozen copy of
the counts the port's kernel bounds were taken with).

Operations per lane-interval (memory-gateway latency, reductions, power),
per chiplet (loads, M/D/1 terms, controller), per chiplet pair when
destination matrices are on, and per gateway slot (old and new Eq. 4
kappas and the switch test). Of a pair's six operations, four (w = ext *
dest, the recv sum, w * w, the fan-in sum) depend on the trace and its
matrix alone, so they count once per matrix; two (the destination leg's
product and sum) depend on the lane's g, so they count per lane. Padded
lanes count their real chiplets only, so the count is the same whatever
kernel design implements it.
"""
from __future__ import annotations

import numpy as np

OPS_PER_LANE, OPS_PER_CHIPLET, OPS_PER_SLOT = 90, 80, 12
OPS_PER_PAIR_MATRIX, OPS_PER_PAIR_LANE = 4, 2
F32 = 4


def epoch_work(n, t, c, g, b, dest: bool, frames: int = 0) -> tuple:
    """(bytes, float ops) of one unpadded call: n traces of t intervals
    and c chiplets, g gateway slots, b lanes. Written per lane-interval:
    the six scalars the records need and g_eff, gw_load per chiplet; per
    lane the final g. Read: ext, intra, mem, t_mask, dest per trace;
    lane_trace, the five knobs and g0 per lane; the two selection-table
    rows. `frames` fault frames add gw_ok and stuck_on [T, C, G] and
    drift_db [T] each to the reads, and g_desired per chiplet and the
    failed-slot count per lane-interval to the writes."""
    f = F32
    read = (2 * n * t * c + 2 * n * t + (n * c * c if dest else 0)) * f \
        + b * (4 + 5 * f + c * f) + 2 * g * f \
        + frames * (2 * t * c * g + t) * f
    written = b * t * (6 + 2 * c) * f + b * c * f \
        + (b * t * (1 + c) * f if frames else 0)
    ops = t * (b * (OPS_PER_LANE + c * OPS_PER_CHIPLET
                    + (c * c * OPS_PER_PAIR_LANE if dest else 0)
                    + c * g * OPS_PER_SLOT)
               + (n * c * c * OPS_PER_PAIR_MATRIX if dest else 0))
    return read + written, ops


def padded_epoch_work(n, t, c, g, lane_c, lane_g, pair_c=None) -> tuple:
    """(bytes, float ops) of one padded call (one topology per lane):
    `epoch_work`'s terms plus each lane's topology rows and matrix index,
    one [C, C] matrix per distinct (trace, chiplet count) pair (`pair_c`:
    each matrix's chiplet count; None without destination matrices). The
    operations count each lane's real chiplets (`lane_c`, with `lane_g`
    gateway slots) and each matrix's trace-only pair terms once, over its
    real chiplets."""
    f = F32
    b = len(lane_c)
    dest = pair_c is not None
    mats = len(pair_c) if dest else 0
    read = (2 * n * t * c + 2 * n * t + mats * c * c) * f + mats * 4 \
        + b * (4 + 5 * f + c * f) \
        + b * (4 + 2 * g * f + 3 * f + (4 if dest else 0))
    written = b * t * (6 + 2 * c) * f + b * c * f
    lane_c = np.asarray(lane_c, np.float64)
    lane_g = np.asarray(lane_g, np.float64)
    ops = t * float(np.sum(OPS_PER_LANE + lane_c * OPS_PER_CHIPLET
                           + (lane_c ** 2 * OPS_PER_PAIR_LANE if dest
                              else 0.0)
                           + lane_c * lane_g * OPS_PER_SLOT))
    if dest:
        ops += t * float(np.sum(np.asarray(pair_c, np.float64) ** 2)) \
            * OPS_PER_PAIR_MATRIX
    return read + written, ops
