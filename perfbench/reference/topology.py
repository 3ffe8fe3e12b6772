"""Plain reference of the padded topology DSE (`sweep_topology_batch`).

Each lane is one application trace at one topology point (n_chiplets C,
gateways_per_chiplet g) on the Table-1 chiplet. The lanes are grouped by
point, and each group runs unpadded through `reference.epoch.run_lanes`
at its own C and g: the trace's first C chiplets, the selection columns
of the first g slots of the default edge placement, the controller's
bounds clamped to the point (max = min(user max, g), min = min(user min,
that max)), the destination matrix narrowed to the first C chiplets and
its rows re-normalized, the controller power of C chiplets. The results
are laid out as the program returns them: per-chiplet records padded with
zeros to the program's chiplet width, lanes in the order given. It
imports nothing of the program.

Departures from `sweep_topology`'s docstring:
- only the RESIPI architecture (`run_lanes`), only the `n_chiplets` and
  `gateways_per_chiplet` axes, the configuration's mesh and the default
  edge placement (no `mesh_radix` or `gateway_positions` axis);
- the runtime knobs are the configuration's, one value for every lane;
- the destination matrix is narrowed once, straight from the trace's;
  the program first re-normalizes it at the padded width and then masks
  and re-normalizes it per (trace, chiplet count) pair: the same rows up
  to rounding;
- every sum over chiplets runs over the lane's C chiplets, where the
  program sums over the padded width with zeros past C: the same values
  up to the order of the additions.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import epoch as ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PER_CHIPLET = ("g", "wavelengths", "gw_load")


def point_lanes(arrs: dict, lanes: np.ndarray, c: int, g: int,
                config: dict) -> dict:
    """`run_lanes`' input for `lanes` (trace indices into `arrs`, the
    stacked traces) at point (c, g), unpadded."""
    dev = arrs["ext"].device
    idx = torch.as_tensor(lanes, device=dev)
    mx, my = config["mesh_x"], config["mesh_y"]
    src, loss = ref.selection_columns(
        mx, my, ref.default_positions(mx, my, g), config["router_pitch_mm"])
    gmax = min(int(config["max_gateways_per_chiplet"]), g)
    gmin = min(int(config["min_gateways"]), gmax)
    m = len(lanes)

    def full(v, dtype=torch.float32):
        return torch.full((m,), v, dtype=dtype, device=dev)

    dest = arrs["dest"]
    return dict(
        {k: full(config[k]) for k in ("l_m", "buffer_sat", "wavelengths")},
        ext=arrs["ext"][idx, :, :c], intra=arrs["intra"][idx, :, :c],
        mem=arrs["mem"][idx], t_mask=arrs["t_mask"][idx],
        dest=None if dest is None
        else ref.narrowed_destinations(dest[idx], c),
        max_gateways=full(gmax, torch.int32),
        min_gateways=full(gmin, torch.int32),
        src_hops=torch.as_tensor(src, device=dev).expand(m, -1),
        gw_loss_db=torch.as_tensor(loss, device=dev).expand(m, -1),
        n_chiplets=full(float(c)))


def run_topology(arrs: dict, lane_trace, lane_c, lane_g, config: dict,
                 c_pad: int, *, dtype=torch.float32) -> dict:
    """Simulate B lanes, lane i on trace `lane_trace[i]` of `arrs` (the
    stacked traces, at least max(lane_c) chiplets wide) at point
    (`lane_c[i]`, `lane_g[i]`). Returns {"records": [B, T] per lane or
    [B, T, c_pad] per chiplet (zero past the lane's C), "summary": [B]},
    each group computed in `dtype` (float32 the reference, bfloat16 the
    control)."""
    lane_trace, lane_c, lane_g = (np.asarray(a, np.int64)
                                  for a in (lane_trace, lane_c, lane_g))
    net = ref.network_constants(config)
    b = len(lane_trace)
    recs, summ = {}, {}
    for c, g in sorted(set(zip(lane_c.tolist(), lane_g.tolist()))):
        rows = np.flatnonzero((lane_c == c) & (lane_g == g))
        out = ref.run_lanes(point_lanes(arrs, lane_trace[rows], c, g,
                                        config), net, dtype=dtype)
        at = torch.as_tensor(rows, device=arrs["ext"].device)
        for k, v in out["records"].items():
            if k not in recs:
                shape = (b,) + v.shape[1:2] + (
                    (c_pad,) if k in PER_CHIPLET else ())
                recs[k] = v.new_zeros(shape)
            if k in PER_CHIPLET:
                recs[k][at, :, :c] = v
            else:
                recs[k][at] = v
        for k, v in out["summary"].items():
            if k not in summ:
                summ[k] = v.new_zeros((b,))
            summ[k][at] = v
    return {"records": recs, "summary": summ}
