"""Plain reference of what a Pareto co-design search reports.

For each design a search reports (topology point, gateway placement,
island knobs) the reference simulates it again, unpadded at its own
chiplet count, over every workload (`reference.epoch.run_lanes`, the
traces narrowed to the design's chiplets, with their destination
matrices, where they have them, re-normalized), and averages the
objectives (mean latency, mean power, mean energy) over the workloads.
It also restates the island weights (the Das-Dennis simplex lattice),
the scalarization of an island's score against its point's default
placement, the controller's activation order of a placement, and Pareto
dominance.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import epoch as ref

OBJECTIVES = ("mean_latency", "mean_power_mw", "mean_energy")


def island_weights(islands: int) -> np.ndarray:
    """[K, 3] scalarization weights: the smallest simplex-lattice layer
    with at least K points, enumerated lexicographically, subsampled at
    evenly spaced indices (K = 1: the uniform weight)."""
    if islands == 1:
        return np.full((1, 3), 1.0 / 3.0, np.float32)
    h = 1
    while (h + 1) * (h + 2) // 2 < islands:
        h += 1
    pts = [(i, j, h - i - j) for i in range(h + 1) for j in range(h + 1 - i)]
    idx = np.round(np.linspace(0, len(pts) - 1, islands)).astype(int)
    return np.asarray([pts[i] for i in idx], np.float32) / float(h)


def scalarize(obj: np.ndarray, weights: np.ndarray,
              norm: np.ndarray) -> np.ndarray:
    """Scores [...] of objectives [..., 3] under weights [..., 3] and
    normalizers [..., 3] (float32: (x0 + x1) + x2 of w * obj / |norm|)."""
    x = (weights.astype(np.float32) * obj.astype(np.float32)
         / np.maximum(np.abs(norm.astype(np.float32)), np.float32(1e-12)))
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def activation_order(pos: np.ndarray, mx: int, my: int) -> np.ndarray:
    """The controller's activation order of a placement [G, 2]: first the
    router nearest the mesh centre, then greedily the one farthest (by
    its least hop distance) from those already active; ties by
    centrality, then row."""
    pos = np.asarray(pos, np.int64).reshape(-1, 2)
    n = len(pos)
    center = np.array([(mx - 1) / 2.0, (my - 1) / 2.0])
    cent = np.abs(pos - center).sum(axis=1)
    pair = np.abs(pos[:, None, :] - pos[None, :, :]).sum(-1)
    order = [int(np.lexsort((np.arange(n), cent))[0])]
    rest = [i for i in range(n) if i != order[0]]
    while rest:
        dmin = [min(pair[i, j] for j in order) for i in rest]
        best = np.lexsort((rest, [cent[i] for i in rest],
                           [-d for d in dmin]))[0]
        order.append(rest.pop(int(best)))
    return np.asarray(order, np.int64)


def placement_faults(pos, mx: int, my: int) -> int:
    """1 where a placement has a router off the mesh, two gateways on one
    router, or rows out of activation order; else 0."""
    pos = np.asarray(pos, np.int64).reshape(-1, 2)
    if ((pos < 0) | (pos >= np.array([mx, my]))).any():
        return 1
    if len({tuple(p) for p in pos}) != len(pos):
        return 1
    return int((activation_order(pos, mx, my) != np.arange(len(pos))).any())


def dominated(obj: np.ndarray) -> int:
    """How many of the rows [N, 3] another row dominates (no worse in
    every objective, better in one)."""
    n = 0
    for i in range(len(obj)):
        le = np.all(obj <= obj[i], axis=1)
        lt = np.any(obj < obj[i], axis=1)
        le[i] = False
        n += int(np.any(le & lt))
    return n


def objectives(arrs: dict, designs: list, config: dict, *,
               dtype=torch.float32) -> np.ndarray:
    """[D, 3] objectives (OBJECTIVES), averaged over the W workloads as
    the sum in workload order times float32(1 / W), of designs given as
    (n_chiplets, placement [G, 2], knobs {l_m, max_gateways, ...}).
    `arrs` holds the workloads' arrays at the widest chiplet count:
    ext, intra [W, T, C], mem, t_mask [W, T], dest [W, C, C] or None."""
    net = ref.network_constants(config)
    mx, my = config["mesh_x"], config["mesh_y"]
    dev = arrs["ext"].device
    n_w = int(arrs["ext"].shape[0])
    out = np.zeros((len(designs), 3), np.float32)
    by_c = {}
    for d, (c, _, _) in enumerate(designs):
        by_c.setdefault(int(c), []).append(d)
    for c, idx in by_c.items():
        m = len(idx) * n_w
        w = torch.arange(n_w, device=dev).repeat(len(idx))
        cols = [ref.selection_columns(mx, my, designs[d][1],
                                      config["router_pitch_mm"])
                for d in idx]
        src = torch.as_tensor(np.stack([s for s, _ in cols]), device=dev)
        loss = torch.as_tensor(np.stack([l for _, l in cols]), device=dev)
        rep = torch.arange(len(idx), device=dev).repeat_interleave(n_w)

        def knob(name, default, dt=torch.float32):
            v = [designs[d][2].get(name, default) for d in idx]
            return torch.as_tensor(np.asarray(v), device=dev).to(dt)[rep]

        lanes = {
            "ext": arrs["ext"][w][..., :c], "intra": arrs["intra"][w][..., :c],
            "mem": arrs["mem"][w], "t_mask": arrs["t_mask"][w],
            "dest": None if arrs["dest"] is None
            else ref.narrowed_destinations(arrs["dest"], c)[w],
            "l_m": knob("l_m", config["l_m"]),
            "buffer_sat": knob("buffer_sat", config["buffer_sat"]),
            "wavelengths": knob("wavelengths", config["wavelengths"]),
            "max_gateways": knob("max_gateways",
                                 config["max_gateways_per_chiplet"],
                                 torch.int32),
            "min_gateways": knob("min_gateways", config["min_gateways"],
                                 torch.int32),
            "src_hops": src[rep], "gw_loss_db": loss[rep],
            "n_chiplets": torch.full((m,), float(c), device=dev)}
        summ = ref.run_lanes(lanes, net, dtype=dtype)["summary"]
        per = torch.stack([summ[k] for k in OBJECTIVES], dim=-1) \
            .reshape(len(idx), n_w, 3)
        total = per[:, 0]
        for j in range(1, n_w):
            total = total + per[:, j]
        out[idx] = (total * float(np.float32(1.0 / n_w))).cpu().numpy()
    return out
