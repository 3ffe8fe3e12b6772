"""Pareto co-design on the device (port of `repro.core.pareto`).

ReSiPI's design space has three axes: the interposer *topology* (chiplet
count, per-chiplet gateway budget, intra-chiplet mesh radix), the gateway
*placement* on each chiplet's router mesh, and the controller's runtime
*knobs* (L_m, wavelength budget, gateway bounds). `search_codesign`
searches them together and keeps a Pareto archive over (latency, power,
energy):

  * every topology point runs K annealed island chains (the device
    search's proposals: collision-free moves and Gumbel-top-g restarts,
    spread-ordered), each under a fixed scalarization weight vector
    (`island_weights`) normalized by that point's generation-0 default
    placement, and island k's knobs;
  * every `migrate_every` generations each island adopts its ring
    neighbour's incumbent;
  * every scored (island, candidate) is offered to a fixed-capacity
    archive: a dominance and duplicate mask keeps only non-dominated
    points, and capacity eviction ranks by the sum of the objectives' logs
    (stable, ties by insertion index). Dominance is global over the grid.

A Python loop over generations on device tensors takes the place of the
reference's two nested `lax.scan`s. Every topology point's chains ride
together: one generation is one `epoch_step` launch on the card whose
T x K x P x W lanes are every point's, island's, candidate's and
workload's (`simulator.score_codesign_tables`), so a search makes
`generations` launches. This is exact: in the reference the archive is a
pure sink and each point's chains start from that point's own default
placement, so nothing one point computes reaches another's chains. The
archive is replayed after the loop, in the reference's order (point, then
generation, lanes island-major), on the device; the loop reads nothing
back and the result's copy is the only device-to-host transfer. So on the
card a one-block search from its PRNG key to its packed result is
captured as one CUDA graph, and a search of the same shapes and scalars
replays it with one launch (`_SearchGraph`).

The draws are the reference's, bit for bit (one `split(prng_key(seed), 5)`
and five draws at its full [T, GEN, K, n_prop, ...] shapes). The scores
agree with the reference's at 1e-6, not bit for bit (the port scores
through `epoch_step` and its plain loop, the reference through its scan
body), so a decision on a near-tie could part the trajectories (ROADMAP
queue 3, P9 / P11).

`engine="host"` runs the same searcher with numpy randomness
(`np.random.RandomState(seed)`, the reference host engine's stream) over
the public `sweep_topology_batch`; `rescore_front_host` re-scores a front
through that path. Derived-mesh grids only: explicit-coords layouts fix
the topology (search their placements with `search_placement_islands`).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch import backend
from repro_torch import random as trandom
from repro_torch.core import simulator as S
from repro_torch.core import topology
from repro_torch.core.constants import PHOTONIC_POWER
from repro_torch.core.distributed import process_count
from repro_torch.core.noc import uniform_mesh_mean_hops
from repro_torch.core.search import _hyper, _one_move, _temperatures
from repro_torch.core.selection import (N_DEFAULT_EDGE_SLOTS,
                                        normalize_placement,
                                        placement_tables_from_lut_torch,
                                        resolve_gateway_positions)

# Objective vector order: the columns of every [.., 3] objectives array.
PARETO_OBJECTIVES = S.CODESIGN_OBJECTIVES

# Topology axes the co-design grid accepts (placements are searched, so
# the gateway_positions sweep axis is absent).
CODESIGN_TOPOLOGY_FIELDS = ("n_chiplets", "gateways_per_chiplet",
                            "mesh_radix")

# Per-(topology, generation) history row layout.
CODESIGN_HISTORY_KEYS = ("archive_size", "best_scalar")

_F32 = torch.float32


def island_weights(islands: int) -> np.ndarray:
    """[K, 3] deterministic scalarization weights spread over the simplex.

    Das-Dennis construction: the smallest simplex-lattice layer with at
    least K points, enumerated lexicographically, subsampled at evenly
    spaced indices, so K=3 gives the pure corners and larger K fills the
    interior trade-offs. K=1 uses the uniform weight.
    """
    if islands < 1:
        raise ValueError("islands must be >= 1")
    if islands == 1:
        return np.full((1, 3), 1.0 / 3.0, np.float32)
    h = 1
    while (h + 1) * (h + 2) // 2 < islands:
        h += 1
    pts = [(i, j, h - i - j)
           for i in range(h + 1) for j in range(h + 1 - i)]
    idx = np.round(np.linspace(0, len(pts) - 1, islands)).astype(int)
    return np.asarray([pts[i] for i in idx], np.float32) / float(h)


# ---------------------------------------------------------------------------
# The Pareto archive
# ---------------------------------------------------------------------------

def _empty_archive(capacity: int, g: int, device) -> dict:
    i64 = dict(dtype=torch.int64, device=device)
    return {"obj": torch.full((capacity, 3), float("inf"), dtype=_F32,
                              device=device),
            "pos": torch.zeros((capacity, g, 2), **i64),
            "topo": torch.full((capacity,), -1, **i64),
            "island": torch.full((capacity,), -1, **i64),
            "valid": torch.zeros((capacity,), dtype=torch.bool,
                                 device=device)}


def _archive_key(obj: torch.Tensor) -> torch.Tensor:
    """The eviction key of [N, 3] objectives: the sum of their logs (XLA's
    float32 log, each objective floored at 1e-12), in the reference's
    order over the three objectives."""
    lg = trandom.xla_log(torch.clamp_min(obj, 1e-12))
    return (lg[:, 0] + lg[:, 1]) + lg[:, 2]


def _archive_insert(arch: dict, cobj: torch.Tensor, cpos: torch.Tensor,
                    ctopo: torch.Tensor, cisland: torch.Tensor, *,
                    capacity: int) -> dict:
    """Offer a candidate batch to the archive (fixed shapes, no host
    synchronization).

    Row i eliminates row j when i's objectives are <= everywhere and <
    somewhere, or when the rows are equal and i was offered earlier
    (duplicates keep the first). Survivors are ranked by `_archive_key`
    (a stable sort, ties by index) and the first `capacity` kept, so a
    full archive can evict non-dominated points but never holds a
    dominated one. Candidates with a non-finite objective are never
    valid.
    """
    cobj = cobj.to(_F32)
    obj = torch.cat([arch["obj"], cobj])
    pos = torch.cat([arch["pos"], cpos.long()])
    tix = torch.cat([arch["topo"], ctopo.long()])
    kix = torch.cat([arch["island"], cisland.long()])
    valid = torch.cat([arch["valid"], torch.all(torch.isfinite(cobj),
                                                dim=1)])
    idx = torch.arange(obj.shape[0], device=obj.device)
    both = valid[:, None] & valid[None, :]
    le = torch.all(obj[:, None, :] <= obj[None, :, :], dim=-1)
    lt = torch.any(obj[:, None, :] < obj[None, :, :], dim=-1)
    beaten = torch.any(both & le & (lt | (idx[:, None] < idx[None, :])),
                       dim=0)
    keep = valid & ~beaten
    key = torch.where(keep, _archive_key(obj),
                      torch.full_like(obj[:, 0], float("inf")))
    top = torch.argsort(key, stable=True)[:capacity]
    kt = keep[top]
    return {"obj": torch.where(kt[:, None], obj[top],
                               torch.full_like(obj[top], float("inf"))),
            "pos": pos[top],
            "topo": torch.where(kt, tix[top], torch.full_like(tix[top], -1)),
            "island": torch.where(kt, kix[top],
                                  torch.full_like(kix[top], -1)),
            "valid": kt}


def _archive_insert_np(arch: dict, cobj, cpos, ctopo, cisland,
                       capacity: int) -> dict:
    """Numpy mirror of `_archive_insert` (the host engine's archive)."""
    obj = np.concatenate([arch["obj"], np.asarray(cobj, np.float32)])
    pos = np.concatenate([arch["pos"], np.asarray(cpos, np.int32)])
    tix = np.concatenate([arch["topo"], np.asarray(ctopo, np.int32)])
    kix = np.concatenate([arch["island"], np.asarray(cisland, np.int32)])
    cvalid = np.all(np.isfinite(np.asarray(cobj, np.float32)), axis=1)
    valid = np.concatenate([arch["valid"], cvalid])

    idx = np.arange(obj.shape[0])
    both = valid[:, None] & valid[None, :]
    le = np.all(obj[:, None, :] <= obj[None, :, :], axis=-1)
    lt = np.any(obj[:, None, :] < obj[None, :, :], axis=-1)
    beaten = np.any(both & le & (lt | (idx[:, None] < idx[None, :])),
                    axis=0)
    keep = valid & ~beaten
    key = np.where(keep,
                   np.sum(np.log(np.maximum(obj, 1e-12)), axis=-1),
                   np.inf)
    top = np.argsort(key, kind="stable")[:capacity]
    kt = keep[top]
    return {"obj": np.where(kt[:, None], obj[top], np.inf),
            "pos": pos[top],
            "topo": np.where(kt, tix[top], -1),
            "island": np.where(kt, kix[top], -1),
            "valid": kt}


def _empty_archive_np(capacity: int, g: int) -> dict:
    return {"obj": np.full((capacity, 3), np.inf, np.float32),
            "pos": np.zeros((capacity, g, 2), np.int32),
            "topo": np.full((capacity,), -1, np.int32),
            "island": np.full((capacity,), -1, np.int32),
            "valid": np.zeros((capacity,), bool)}


def hypervolume(points, ref) -> float:
    """Dominated 3-D hypervolume of a minimization front w.r.t. `ref`.

    Host-side numpy: slice the volume along the third objective and
    accumulate 2-D staircase areas, exact for any front size the archive
    can hold. Points outside the reference box contribute nothing.
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    ref = np.asarray(ref, np.float64).reshape(3)
    pts = pts[np.all(np.isfinite(pts), axis=1)]
    pts = pts[np.all(pts < ref, axis=1)]
    if pts.shape[0] == 0:
        return 0.0
    pts = np.unique(pts, axis=0)
    keep = [i for i in range(len(pts))
            if not any(np.all(pts[j] <= pts[i]) and np.any(pts[j] < pts[i])
                       for j in range(len(pts)) if j != i)]
    pts = pts[keep]

    def area2d(xy):
        if xy.shape[0] == 0:
            return 0.0
        xy = xy[np.argsort(xy[:, 0], kind="stable")]
        area, y_best = 0.0, ref[1]
        for x, y in xy:
            if y < y_best:
                area += (ref[0] - x) * (y_best - y)
                y_best = y
        return area

    zs = np.unique(pts[:, 2])
    hv = 0.0
    for i, z in enumerate(zs):
        z_next = zs[i + 1] if i + 1 < len(zs) else ref[2]
        hv += area2d(pts[pts[:, 2] <= z, :2]) * (z_next - z)
    return float(hv)


# ---------------------------------------------------------------------------
# Activation order with the mesh radix as data
# ---------------------------------------------------------------------------

def _activation_order_mesh(pos: torch.Tensor, mx, my, *, a_bound: int,
                           big_bound: int) -> torch.Tensor:
    """`activation_order_torch`'s mesh rule for placements [..., n, 2] whose
    radix `mx`, `my` [...] is data (one per placement: each candidate's
    topology point). `a_bound` / `big_bound` are the grid-maximum bounds;
    the composite integer keys order as the per-point exact ones do (the
    tie-break terms stay below `a`), so each row equals
    `activation_order_torch(pos, cfg_t)` on its point. Returns int64 [...,
    n] row permutations."""
    pos = pos.long()
    n = int(pos.shape[-2])
    x, y = pos[..., 0], pos[..., 1]
    mx = torch.as_tensor(mx, device=pos.device).long()[..., None]
    my = torch.as_tensor(my, device=pos.device).long()[..., None]
    idx = torch.arange(n, device=pos.device)
    cent2 = torch.abs(2 * x - (mx - 1)) + torch.abs(2 * y - (my - 1))
    pair = torch.sum(torch.abs(pos[..., :, None, :] - pos[..., None, :, :]),
                     dim=-1)
    b = n
    a = int(a_bound) * b
    taken = int(np.iinfo(np.int32).max)
    first = torch.argmin(cent2 * b + idx, dim=-1)
    order = [first]
    selected = idx == first[..., None]
    for _ in range(1, n):
        dmin = torch.amin(torch.where(selected[..., None, :], pair,
                                      int(big_bound)), dim=-1)
        key = torch.where(selected, taken, -dmin * a + cent2 * b + idx)
        nxt = torch.argmin(key, dim=-1)
        order.append(nxt)
        selected = selected | (idx == nxt[..., None])
    return torch.stack(order, dim=-1)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

def _check_codesign_params(generations, population, migrate_every,
                           archive) -> None:
    if population < 2:
        raise ValueError("population must be >= 2 (incumbent + candidates)")
    if generations < 1:
        raise ValueError("generations must be >= 1")
    if migrate_every < 0:
        raise ValueError("migrate_every must be >= 0 (0 disables migration)")
    if archive < 1:
        raise ValueError("archive must be >= 1")


def _check_topology_grids(sim, topo_grids: dict):
    """Topology-axis validation. Returns (cs, gs, rs) integer lists of one
    shared length T (T=1 for an empty grid: placement x knob search on the
    base topology)."""
    cfg = sim.cfg
    if cfg.coords is not None:
        raise ValueError(
            "search_codesign sweeps derived-mesh topology grids; explicit-"
            "coords layouts (NetworkConfig.coords) fix the topology — "
            "search placements there with search_placement_islands")
    if "gateway_positions" in topo_grids:
        raise ValueError(
            "gateway_positions is not a co-design axis: placements are "
            "SEARCHED per topology point, not swept (pin one with "
            "sweep_topology instead)")
    unknown = set(topo_grids) - set(CODESIGN_TOPOLOGY_FIELDS)
    runtime = unknown & set(S.SWEEPABLE_FIELDS)
    if runtime:
        raise ValueError(
            f"runtime fields {sorted(runtime)} zip with the island axis — "
            f"pass them via knob_grids={{field: [K values]}}, not as "
            f"topology grids")
    if unknown:
        raise ValueError(
            f"non-sweepable fields: {sorted(unknown)} (co-design topology "
            f"axes: {CODESIGN_TOPOLOGY_FIELDS}; runtime knobs ride "
            f"knob_grids)")
    lengths = {k: S._topo_grid_len(k, v) for k, v in topo_grids.items()}
    if lengths and len(set(lengths.values())) != 1:
        raise ValueError(
            f"topology grids must share one length, got {lengths}")
    t_pts = next(iter(lengths.values())) if lengths else 1
    cs = [int(x) for x in topo_grids.get("n_chiplets",
                                         [cfg.n_chiplets] * t_pts)]
    gs = [int(x) for x in topo_grids.get(
        "gateways_per_chiplet", [cfg.max_gateways_per_chiplet] * t_pts)]
    rs = [int(x) for x in topo_grids.get("mesh_radix",
                                         [cfg.mesh_x] * t_pts)]
    if min(cs) < 1 or min(gs) < 1 or min(rs) < 2:
        raise ValueError(f"invalid topology grid: n_chiplets {cs}, "
                         f"gateways {gs}, radix {rs}")
    if len(set(gs)) != 1:
        raise ValueError(
            f"gateways_per_chiplet must be constant across a co-design "
            f"grid (got {gs}): the placement axis is [g, 2] per candidate "
            f"and cannot change width mid-scan — trade gateway counts at "
            f"runtime with knob_grids={{'max_gateways': [...]}} instead")
    g = gs[0]
    if g > N_DEFAULT_EDGE_SLOTS:
        raise ValueError(
            f"gateways_per_chiplet={g} exceeds the {N_DEFAULT_EDGE_SLOTS} "
            f"default edge slots that seed the search")
    for i, r in enumerate(rs):
        if g > r * r:
            raise ValueError(
                f"grid point {i}: gateways_per_chiplet={g} exceeds the "
                f"{r}x{r} mesh's {r * r} routers")
    return cs, gs, rs


def _check_knob_grids(knob_grids, islands):
    """Knob validation. Returns (knobs dict of lists, islands)."""
    if islands is not None and (isinstance(islands, bool)
                                or not isinstance(islands,
                                                  (int, np.integer))):
        raise ValueError(
            f"islands must be an int, got {type(islands).__name__} "
            f"{islands!r}")
    knobs = dict(knob_grids or {})
    unknown = set(knobs) - set(S.SWEEPABLE_FIELDS)
    if unknown:
        topo = unknown & set(S.TOPOLOGY_SWEEPABLE_FIELDS)
        if topo:
            raise ValueError(
                f"topology fields {sorted(topo)} are grid axes, not island "
                f"knobs — pass them as keyword grids "
                f"(search_codesign(tr, sim, n_chiplets=[...]))")
        raise ValueError(
            f"non-sweepable knob fields: {sorted(unknown)} (runtime knobs: "
            f"{S.SWEEPABLE_FIELDS})")
    lengths = {f: S._topo_grid_len(f, v) for f, v in knobs.items()}
    if islands is None:
        if lengths:
            if len(set(lengths.values())) != 1:
                raise ValueError(
                    f"knob grids must share one length, got {lengths}")
            islands = next(iter(lengths.values()))
        else:
            islands = 8
    bad = {f: n for f, n in lengths.items() if n != islands}
    if bad:
        raise ValueError(
            f"knob grids must have length islands={islands}, got {bad} — "
            f"every knob grid zips element-wise with the island axis")
    if islands < 1:
        raise ValueError("islands must be >= 1")
    return {f: list(np.asarray(v).tolist()) for f, v in knobs.items()}, \
        int(islands)


# ---------------------------------------------------------------------------
# Set-up: padded per-point rows, knobs, draws
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _codesign_topology(cfg, cs: tuple, g: int, rs: tuple,
                       device: str) -> tuple:
    """Each grid point's rows at the reference's padded shapes, on
    `device` (memoized; `clear_codesign_caches` drops them): (cfgs, rows,
    statics). `rows` holds the interval loop's per-point topology
    (`n_chiplets`, `g_max`, `mesh_hops`, `mesh_x` the mesh-feed width,
    `total_gateways`) and the search's: the radix `mx`, `my`, the LUTs
    `hop_lut` [T, R, X, Y] and `edge_lut` [T, X, Y] sized by
    `topology.lut_shape`, `router_mask`, the per-level capacities `caps`,
    `coords` and `blocked` [T, R] (padded routers are blocked, so never
    proposed) and the default placement `default_pos` [T, g, 2]."""
    cfgs = tuple(cfg.with_topology(n_chiplets=c, gateways_per_chiplet=g,
                                   mesh_radix=r) for c, r in zip(cs, rs))
    t_pts = len(cfgs)
    shapes = [topology.lut_shape(c) for c in cfgs]
    x_max = max(s[0] for s in shapes)
    y_max = max(s[1] for s in shapes)
    r_max = max(c.routers_per_chiplet for c in cfgs)
    d_pad = max(topology.max_hops(c) for c in cfgs) + 1
    a_bound = max(topology.centrality_bound(c) for c in cfgs)

    hop = np.full((t_pts, r_max, x_max, y_max), d_pad, np.int64)
    edge = np.zeros((t_pts, x_max, y_max), np.int64)
    rmask = np.zeros((t_pts, r_max), np.float32)
    caps = np.zeros((t_pts, g), np.int64)
    coords = np.zeros((t_pts, r_max, 2), np.int64)
    blocked = np.ones((t_pts, r_max), bool)
    dpos = np.zeros((t_pts, g, 2), np.int64)
    for t, c in enumerate(cfgs):
        r_t = c.routers_per_chiplet
        bx, by = topology.lut_shape(c)
        hop[t, :r_t, :bx, :by] = topology.hop_lut(c)
        edge[t, :bx, :by] = topology.edge_lut(c)
        rmask[t, :r_t] = 1.0
        caps[t] = [-(-r_t // lvl) for lvl in range(1, g + 1)]
        coords[t, :r_t] = topology.router_coords(c)
        blocked[t, :r_t] = False
        dpos[t] = normalize_placement(resolve_gateway_positions(c), c)

    def f32(vals):
        return torch.tensor(np.asarray(vals, np.float32), device=device)

    rows = {
        "n_chiplets": torch.tensor(cs, dtype=torch.int32, device=device),
        "g_max": torch.full((t_pts,), g, dtype=torch.int32, device=device),
        "mesh_hops": f32([uniform_mesh_mean_hops(c) for c in cfgs]),
        "mesh_x": f32([topology.feed_width(c) for c in cfgs]),
        "total_gateways": f32([c.total_gateways for c in cfgs]),
    }
    search = {"mx": [c.mesh_x for c in cfgs], "my": [c.mesh_y for c in cfgs],
              "hop_lut": hop, "edge_lut": edge, "router_mask": rmask,
              "caps": caps, "coords": coords, "blocked": blocked,
              "default_pos": dpos}
    rows.update({k: torch.as_tensor(np.asarray(v), device=device)
                 for k, v in search.items()})
    statics = {"d_pad": int(d_pad), "a_bound": int(a_bound),
               "big_bound": int(4 * (x_max + y_max)),
               "x_max": int(x_max), "y_max": int(y_max)}
    return cfgs, rows, statics


# The rows `simulator.codesign_scoring` reads per lane.
_LANE_ROWS = ("n_chiplets", "g_max", "mesh_hops", "mesh_x",
              "total_gateways")


def _prepare_codesign(sim, cs, gs, rs, device):
    """(sim_padded, rows, cfgs, c_max, statics): the per-point rows of
    `_codesign_topology` and the reference's padded config (the grid's
    chiplet maximum, its LUT extent as the mesh, no explicit
    placement)."""
    cfg = sim.cfg
    g = gs[0]
    cfgs, rows, statics = _codesign_topology(cfg, tuple(cs), g, tuple(rs),
                                             str(device))
    c_max = max(cs)
    sim_padded = dataclasses.replace(sim, cfg=dataclasses.replace(
        cfg, n_chiplets=c_max, max_gateways_per_chiplet=g,
        mesh_x=statics["x_max"], mesh_y=statics["y_max"],
        gateway_positions=None))
    statics = {"d_pad": statics["d_pad"], "a_bound": statics["a_bound"],
               "big_bound": statics["big_bound"],
               "db_per_hop": float(cfg.router_pitch_mm
                                   * PHOTONIC_POWER.waveguide_db_per_mm)}
    return sim_padded, rows, cfgs, c_max, statics


def _codesign_batch(trace):
    """A trace dict, a stacked batch, or a list of W workloads, as one
    stacked batch."""
    if isinstance(trace, dict) and S._ndim(trace["ext_load"]) == 3:
        return trace
    return S._stacked(
        list(trace) if isinstance(trace, (list, tuple)) else [trace])


def _knob_grid(knobs: dict, islands: int, sim, gs) -> dict:
    """[T, K] knob arrays of each (point, island): island k's grid values
    (the reference's dtypes), and the gateway bounds clamped per point as
    the reference's scan and `sweep_topology` clamp them (max = min(user
    max, g_t), min = min(user min, that max))."""
    t_pts = len(gs)
    ov = {f: S._runtime_grid(f, v) for f, v in knobs.items()}
    user_max = ov.pop("max_gateways", np.int32(sim.ctl.max_gateways))
    user_min = ov.pop("min_gateways", np.int32(sim.ctl.min_gateways))
    maxg = np.minimum(
        np.broadcast_to(np.asarray(user_max).astype(np.int32),
                        (islands,))[None, :],
        np.asarray(gs, np.int32)[:, None])
    out = {f: np.broadcast_to(v[None, :], (t_pts, islands))
           for f, v in ov.items()}
    out["max_gateways"] = maxg
    out["min_gateways"] = np.minimum(
        np.broadcast_to(np.asarray(user_min).astype(np.int32),
                        (islands,))[None, :], maxg)
    return out


def _draws(key: torch.Tensor, t_pts: int, generations: int, k_isl: int,
           n_prop: int, r_pad: int, g: int, restart_frac: float) -> dict:
    """Every draw of the search, from one `split(key, 5)`, in the
    reference's order and at its full shapes (threefry bits depend on the
    whole shape)."""
    ks = trandom.split(key, 5)
    shape = (t_pts, generations, k_isl, n_prop)
    return {"restart": trandom.bernoulli(ks[0], restart_frac, shape),
            "rest_gum": trandom.gumbel(ks[1], shape + (r_pad,)),
            "move_i": trandom.randint(ks[2], shape + (2,), 0, g).long(),
            "move_gum": trandom.gumbel(ks[3], shape + (2, r_pad)),
            "acc_u": trandom.uniform(ks[4], (t_pts, generations, k_isl))}


def _restart_positions(draws: dict, rows: dict, g: int) -> torch.Tensor:
    """Restart placements [T, GEN, K, n_prop, g, 2]: Gumbel-top-g over each
    point's real routers (a uniform g-subset without replacement), padded
    routers at -inf."""
    gum = torch.where(rows["blocked"][:, None, None, None, :],
                      float("-inf"), draws["rest_gum"])
    _, ridx = trandom.top_k(gum, g)
    t_idx = torch.arange(ridx.shape[0], device=ridx.device)
    return rows["coords"][t_idx.reshape(-1, 1, 1, 1, 1), ridx]


def _scalarize(objs: torch.Tensor, weights: torch.Tensor,
               denom: torch.Tensor) -> torch.Tensor:
    """Scalarized scores [..., K, P] of objectives [..., K, P, 3] under
    island weights [K, 3] and per-island normalizers [..., K, 3]: the sum
    of weight * objective / normalizer over the three objectives, in the
    reference's order."""
    x = weights[:, None, :] * objs / denom[..., None, :]
    return (x[..., 0] + x[..., 1]) + x[..., 2]


# ---------------------------------------------------------------------------
# The generation loop
# ---------------------------------------------------------------------------

class _Chains:
    """K annealed chains of every topology point (state [T, K, ...]) on one
    device, stepped one generation at a time: the generation loop's body.
    A sharded search holds one per block of islands; migration, which
    crosses blocks, is the caller's (`parent` is set before a migrating
    generation)."""

    def __init__(self, draws: dict, rows: dict, weights: torch.Tensor,
                 scoring: "S.CodesignScoring", *, generations: int,
                 population: int, d_pad: int, db_per_hop: float,
                 a_bound: int, big_bound: int):
        self.draws, self.rows, self.weights = draws, rows, weights
        self.scoring = scoring
        self.d_pad, self.db_per_hop = d_pad, db_per_hop
        self.a_bound, self.big_bound = a_bound, big_bound
        dev = weights.device
        t_pts, k_isl = scoring.shape[:2]
        self.t_pts, self.k_isl, self.population = t_pts, k_isl, population
        self.g = g = int(rows["default_pos"].shape[1])
        self.r_pad = int(rows["coords"].shape[1])
        self.n_prop = population - 1
        self.n = t_pts * k_isl * self.n_prop
        self.moves_hi = max(1, generations // 3)
        # Per-proposal mesh rows (each candidate's point), set up once.
        prop_pt = torch.arange(t_pts, device=dev).repeat_interleave(
            k_isl * self.n_prop)
        self.coords_n = rows["coords"][prop_pt]
        self.blocked_n = rows["blocked"][prop_pt]
        self.mx_n, self.my_n = rows["mx"][prop_pt], rows["my"][prop_pt]
        self.cand_pt = torch.arange(t_pts, device=dev)[:, None, None] \
            .expand(t_pts, k_isl, population)
        self.rpos = _restart_positions(draws, rows, g)
        self.parent = rows["default_pos"][:, None].expand(t_pts, k_isl, g, 2)
        self.inc_pos = self.parent
        self.inc_s = torch.full((t_pts, k_isl), float("inf"), dtype=_F32,
                                device=dev)
        self.norm = torch.ones((t_pts, k_isl, 3), dtype=_F32, device=dev)
        self.trail = {k: [] for k in ("cands", "objs", "s", "ib", "accepted",
                                      "threshold", "u", "inc_s")}

    def generation(self, gen: int, temp: torch.Tensor) -> None:
        """Propose, score (one `epoch_step` launch), accept; appends the
        generation to `trail`. Each stage is a span (`codesign.proposals`,
        `.tables`, `.score`, `.acceptance`)."""
        t_pts, k_isl, g, n = self.t_pts, self.k_isl, self.g, self.n
        n_prop, r_pad, rows, draws = self.n_prop, self.r_pad, self.rows, \
            self.draws
        layer = backend.LAYER_TABLES
        with backend.span("codesign.proposals", layer):
            moves = 2 if gen < self.moves_hi else 1
            mi = draws["move_i"][:, gen].reshape(n, 2)
            mg = draws["move_gum"][:, gen].reshape(n, 2, r_pad)
            pos = _one_move(self.parent[:, :, None].expand(
                t_pts, k_isl, n_prop, g, 2).reshape(n, g, 2), mi[:, 0],
                mg[:, 0], self.coords_n, self.blocked_n)
            if moves > 1:
                pos = _one_move(pos, mi[:, 1], mg[:, 1], self.coords_n,
                                self.blocked_n)
            pos = torch.where(
                draws["restart"][:, gen].reshape(n)[:, None, None],
                self.rpos[:, gen].reshape(n, g, 2), pos)
            order = _activation_order_mesh(pos, self.mx_n, self.my_n,
                                           a_bound=self.a_bound,
                                           big_bound=self.big_bound)
            props = torch.gather(pos, 1, order[..., None].expand_as(pos))
            cands = torch.cat([self.parent[:, :, None],
                               props.reshape(t_pts, k_isl, n_prop, g, 2)],
                              dim=2)
        with backend.span("codesign.tables", layer):
            tables = placement_tables_from_lut_torch(
                cands, rows["hop_lut"], rows["edge_lut"],
                rows["router_mask"], rows["caps"], d_pad=self.d_pad,
                db_per_hop=self.db_per_hop, point=self.cand_pt)
        with backend.span("codesign.score", layer):
            objs = S.score_codesign_tables(
                self.scoring, tables["src_hops"],
                tables["gw_loss_db"])                       # [T, K, P, 3]
        with backend.span("codesign.acceptance", layer):
            # Per-island normalization: the point's generation-0 parent
            # (its default placement) anchors the scalarization scale.
            if gen == 0:
                self.norm = objs[:, :, 0, :]
            s = _scalarize(objs, self.weights,
                           torch.clamp_min(torch.abs(self.norm), 1e-12))
            ib = torch.argmin(s, dim=2)
            sb = torch.gather(s, 2, ib[..., None])[..., 0]
            cb = torch.gather(cands, 2, ib[:, :, None, None, None].expand(
                t_pts, k_isl, 1, g, 2))[:, :, 0]
            improved = sb < self.inc_s
            self.inc_pos = torch.where(improved[..., None, None], cb,
                                       self.inc_pos)
            self.inc_s = torch.minimum(sb, self.inc_s)

            # Annealed Metropolis test per island (the host engine's law).
            s0 = s[..., 0]
            delta = sb - s0
            rel = delta / torch.clamp_min(torch.abs(s0), 1e-12)
            threshold = trandom.xla_exp(-rel / torch.clamp_min(temp, 1e-30))
            u = draws["acc_u"][:, gen]
            accepted = (delta < 0) | ((temp > 0) & (u < threshold))
            self.parent = torch.where(accepted[..., None, None], cb,
                                      self.parent)
            for k, v in (("cands", cands), ("objs", objs), ("s", s),
                         ("ib", ib), ("accepted", accepted),
                         ("threshold", threshold), ("u", u),
                         ("inc_s", self.inc_s)):
                self.trail[k].append(v)


def _migrates(gen: int, migrate_every: int) -> bool:
    """Whether generation `gen` starts with the ring migration."""
    return migrate_every > 0 and gen > 0 and gen % migrate_every == 0


def _archive_replay(trail: dict, inc_pos: torch.Tensor,
                    inc_s: torch.Tensor, *, generations: int,
                    population: int, archive: int) -> torch.Tensor:
    """The archive offered each generation's candidates point-major, then
    generation, lanes island-major, as the reference's scans offer them;
    then the packed result (`_unpack`)."""
    t_pts, k_isl, g = inc_pos.shape[:3]
    dev = inc_pos.device
    arch = _empty_archive(archive, g, dev)
    island = torch.arange(k_isl, device=dev).repeat_interleave(population)
    sizes = []
    for t in range(t_pts):
        point = torch.full((k_isl * population,), t, dtype=torch.int64,
                           device=dev)
        for gen in range(generations):
            arch = _archive_insert(
                arch, trail["objs"][gen, t].reshape(-1, 3),
                trail["cands"][gen, t].reshape(-1, g, 2), point, island,
                capacity=archive)
            sizes.append(torch.sum(arch["valid"].to(_F32)))
    hist = torch.stack([torch.stack(sizes).reshape(t_pts, generations),
                        torch.amin(trail["inc_s"], dim=-1).T], dim=-1)
    return torch.cat([arch["obj"].reshape(-1),
                      arch["pos"].reshape(-1).to(_F32),
                      arch["topo"].to(_F32), arch["island"].to(_F32),
                      arch["valid"].to(_F32), hist.reshape(-1),
                      inc_pos.reshape(-1).to(_F32), inc_s.reshape(-1)])


def _codesign_core(shard, scorings: list, draws: dict, temps: torch.Tensor,
                   rows: dict, weights: torch.Tensor, *, generations: int,
                   population: int, migrate_every: int, archive: int,
                   d_pad: int, db_per_hop: float, a_bound: int,
                   big_bound: int) -> tuple:
    """Every point's K annealed chains, state [T, K, ...], one
    `epoch_step` launch a generation for each block of islands; then the
    archive replayed in the reference's order. `shard` is a
    `GridSharding` over the islands with no pad (one block for a
    one-device search) and `scorings` its local blocks' scorings, in
    `local_blocks` order: each block's chains step on its device, the
    ring migration gathers every block's incumbents (across processes
    too) before a migrating generation, and the archive is replayed over
    every block's trail on the first device, so any split gives the
    one-block search's bits. A one-process search copies nothing to or
    from the host (every input is on its device before it starts).
    Returns (packed, trail): the packed result (`_unpack`) and each
    generation's candidates, objectives, scores and decisions ([GEN, T,
    K, ...] tensors, for diagnosis)."""
    blocks = []
    for (dev, idx), scoring in zip(shard.local_blocks(), scorings):
        start, m = int(idx[0]), len(idx)
        blocks.append((dev, start, m, temps.to(dev), _Chains(
            {k: v.narrow(2, start, m).to(dev) for k, v in draws.items()},
            {k: v.to(dev) for k, v in rows.items()},
            weights.narrow(0, start, m).to(dev), scoring,
            generations=generations, population=population, d_pad=d_pad,
            db_per_hop=db_per_hop, a_bound=a_bound, big_bound=big_bound)))
    for gen in range(generations):
        if _migrates(gen, migrate_every):
            # Ring migration: island k adopts island k-1's incumbent.
            rolled = torch.roll(shard.gather(
                [c.inc_pos for *_, c in blocks], axis=1), 1, dims=1)
            for dev, start, m, _, c in blocks:
                c.parent = rolled.narrow(1, start, m).to(dev)
        for *_, temps_b, c in blocks:
            c.generation(gen, temps_b[gen])
    with backend.span("codesign.archive", backend.LAYER_TABLES):
        trail = shard.gather([{k: torch.stack(v)
                               for k, v in c.trail.items()}
                              for *_, c in blocks], axis=2)
        packed = _archive_replay(
            trail, shard.gather([c.inc_pos for *_, c in blocks], axis=1),
            shard.gather([c.inc_s for *_, c in blocks], axis=1),
            generations=generations, population=population,
            archive=archive)
    return packed, trail


def _unpack(packed: np.ndarray, capacity: int, g: int, t_pts: int,
            generations: int, k_isl: int) -> dict:
    """The host copy of `_codesign_core`'s packed result, split into the
    archive, the history [T, GEN, 2] and the island incumbents and
    scores [T, K]."""
    sizes = [capacity * 3, capacity * g * 2, capacity, capacity, capacity,
             t_pts * generations * 2, t_pts * k_isl * g * 2, t_pts * k_isl]
    obj, pos, tix, kix, valid, hist, inc_pos, inc_s = np.split(
        packed, np.cumsum(sizes)[:-1])
    return {"archive": {"obj": obj.reshape(capacity, 3),
                        "pos": pos.reshape(capacity, g, 2).astype(np.int64),
                        "topo": tix.astype(np.int64),
                        "island": kix.astype(np.int64),
                        "valid": valid > 0.5},
            "history": hist.reshape(t_pts, generations, 2),
            "inc_pos": inc_pos.reshape(t_pts, k_isl, g, 2).astype(np.int64),
            "inc_s": inc_s.reshape(t_pts, k_isl)}


# ---------------------------------------------------------------------------
# The search as one CUDA graph
# ---------------------------------------------------------------------------
#
# From the PRNG key to the packed result a one-block search reads nothing
# back and every shape is fixed by its arguments, so on the card that
# stretch (the draws, every generation, the archive replay) is captured
# once and replayed with one launch. A key's first search runs eager (and
# warms up what loads lazily: the kernel library, its launch attributes);
# its second is captured and replayed, every later one only replayed.

# The most search keys kept, least recently used dropped first (each
# captured one holds its graph's device memory).
_GRAPH_SLOTS = 4
# Search key -> None after its first (eager) search, then its graph.
_GRAPHS: "collections.OrderedDict[tuple, Optional[_SearchGraph]]" = \
    collections.OrderedDict()


def _graph_gate(engine: str, device, blocks: int, processes: int) -> bool:
    """Whether a search may run as a captured graph: the device engine on a
    CUDA device, one block of islands in one process (a sharded search
    gathers across blocks and processes, and stays eager)."""
    return (engine == "device" and torch.device(device).type == "cuda"
            and blocks == 1 and processes == 1)


def _graph_key(device, sim_p, grid: tuple, inputs: list, **scalars) -> tuple:
    """What a capture bakes in: the device; the padded config, whose floats
    reach `epoch_step`'s constants; the grid (`sim.cfg`, `cs`, `g`, `rs`:
    the memoized rows the graph reads in place); every input tensor's
    shape and dtype; and the search's Python scalars (generations,
    population, migrate_every, archive, islands, w_axis, d_pad,
    db_per_hop, a_bound, big_bound, restart_frac, the launch design)."""
    return (str(device), sim_p, grid,
            tuple((tuple(x.shape), x.dtype) for x in inputs),
            tuple(sorted(scalars.items())))


def _graph_slot(key: tuple):
    """The captured search of `key`, or "eager" for the key's first search
    (which leaves a mark), or "capture" for its second."""
    if key in _GRAPHS:
        _GRAPHS.move_to_end(key)
        return _GRAPHS[key] or "capture"
    _GRAPHS[key] = None
    while len(_GRAPHS) > _GRAPH_SLOTS:
        _GRAPHS.popitem(last=False)
    return "eager"


def _tensors(obj) -> list:
    """The tensors inside `obj` (dataclasses, dicts, lists, tuples), in a
    fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj)
                for t in _tensors(getattr(obj, f.name))]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _with_tensors(obj, new):
    """`obj` with its tensors, in `_tensors` order, taken from the
    iterator `new`."""
    if isinstance(obj, torch.Tensor):
        return next(new)
    if not _tensors(obj):
        return obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _with_tensors(getattr(obj, f.name), new)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _with_tensors(v, new) for k, v in obj.items()}
    return type(obj)(_with_tensors(v, new) for v in obj)


class _SearchGraph:
    """One captured search: the graph, the static tensors it reads and the
    packed result it writes (both its own), and the `epoch_step` launches
    and variants its capture recorded."""

    def __init__(self, body, inputs, rows: dict):
        # The rows are the grid's memoized tensors, the same objects for
        # every search of the key: read in place. Every other input is
        # copied into a static tensor of the graph's own.
        keep = {id(t) for t in _tensors(rows)}
        self.statics = [x if id(x) in keep else x.clone()
                        for x in _tensors(inputs)]
        args = _with_tensors(inputs, iter(self.statics))
        counts = {k: dict(backend.COUNTERS[k])
                  for k in ("launches", "variants")}
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.packed = body(*args)
        finally:
            # A capture launches nothing: it records what each replay adds.
            self.counts = {k: {n: v - counts[k].get(n, 0)
                               for n, v in backend.COUNTERS[k].items()
                               if v != counts[k].get(n, 0)}
                           for k in counts}
            for k, v in counts.items():
                backend.COUNTERS[k] = v
        S._STATS["codesign_graph_captures"] += 1

    def replay(self, inputs) -> torch.Tensor:
        """Copy this search's inputs into the static tensors (where one is
        not the static tensor itself), replay, count the recorded launches;
        returns the packed result, which the next replay overwrites."""
        for s, x in zip(self.statics, _tensors(inputs)):
            if x is not s:
                s.copy_(x)
        self.graph.replay()
        for k, added in self.counts.items():
            counter = backend.COUNTERS[k]
            for n, v in added.items():
                counter[n] = counter.get(n, 0) + v
        S._STATS["codesign_graph_replays"] += 1
        return self.packed


def clear_codesign_caches() -> None:
    """Drop the co-design's memoized device rows (each grid's padded LUTs
    and per-point tables) and its captured searches, so the next search
    copies them to the device anew and runs eager, as a first search
    does."""
    _codesign_topology.cache_clear()
    _GRAPHS.clear()


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

def _as_placement(pos) -> tuple:
    return tuple((int(x), int(y)) for x, y in np.asarray(pos))


def _codesign_result(arch: dict, hist, inc_pos, inc_s, weights, cs, gs, rs,
                     knobs, islands, engine, meta) -> dict:
    """Shared device / host result assembly (host-side numpy)."""
    obj = np.asarray(arch["obj"], np.float64)
    pos = np.asarray(arch["pos"])
    tix = np.asarray(arch["topo"])
    kix = np.asarray(arch["island"])
    valid = np.asarray(arch["valid"])
    front = []
    for i in range(obj.shape[0]):
        if not valid[i]:
            continue
        t, k = int(tix[i]), int(kix[i])
        front.append({
            "objectives": dict(zip(("latency", "power_mw", "energy"),
                                   (float(v) for v in obj[i]))),
            "placement": _as_placement(pos[i]),
            "topology": {"n_chiplets": cs[t],
                         "gateways_per_chiplet": gs[t],
                         "mesh_radix": rs[t]},
            "knobs": {f: v[k] for f, v in knobs.items()},
            "topology_index": t,
            "island": k,
        })
    front.sort(key=lambda e: (e["objectives"]["latency"],
                              e["objectives"]["power_mw"],
                              e["objectives"]["energy"]))
    hist = np.asarray(hist, np.float64)
    out = {
        "front": front,
        "objectives": PARETO_OBJECTIVES,
        "archive": {"objectives": obj, "valid": valid,
                    "topology_index": tix, "island": kix,
                    "placements": [_as_placement(p) for p in pos]},
        "history": {k: hist[..., i]
                    for i, k in enumerate(CODESIGN_HISTORY_KEYS)},
        "island_incumbents": [[_as_placement(p) for p in per_t]
                              for per_t in np.asarray(inc_pos)],
        "island_scores": np.asarray(inc_s, np.float64),
        "weights": np.asarray(weights, np.float64),
        "grid": {"n_chiplets": list(cs),
                 "gateways_per_chiplet": list(gs),
                 "mesh_radix": list(rs)},
        "knob_grids": {f: list(v) for f, v in knobs.items()},
        "islands": islands,
        "engine": engine,
    }
    out.update(meta)
    return out


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

def search_codesign(trace, sim, *, islands: int = None,
                    generations: int = 10, population: int = 8,
                    migrate_every: int = 4, archive: int = 32,
                    knob_grids: Optional[dict] = None, seed: int = 0,
                    temperature: float = 0.05, cooling: float = 0.7,
                    restart_frac: float = 0.25, engine: str = "device",
                    devices=None, device=None, **topo_grids) -> dict:
    """Joint topology x placement x knob Pareto search::

        search_codesign(traces, sim,
                        n_chiplets=[64, 144, 256],
                        knob_grids={"l_m": [0.008, 0.012, 0.02, 0.03]},
                        islands=4)

    Topology axes (`n_chiplets` / `gateways_per_chiplet` / `mesh_radix`)
    are zipped length-T grids; within each point, K annealed island chains
    search placements under K scalarization weight vectors, zipped with
    optional length-K `knob_grids` runtime overrides. Every scored
    candidate feeds a Pareto archive over (mean_latency, mean_power_mw,
    mean_energy), and islands exchange incumbents on a ring every
    `migrate_every` generations. `trace` is one trace dict, a list of W
    workload traces or a stacked batch (objectives average over the
    workloads), covering max(n_chiplets) chiplets.

    The device engine makes `generations` `epoch_step` launches on the
    card (every point's chains in each), one device-to-host copy and one
    `engine_stats()["search_dispatches"]`. On the card, as one block in
    one process, a search whose shapes and scalars (`_graph_key`) were
    searched before runs as one CUDA graph from its key to the packed
    result: the second such search captures it
    (`engine_stats()["codesign_graph_captures"]`), every one from there
    replays it (`"codesign_graph_replays"`); the first runs eager, as
    every other search does. `engine="host"` runs the same
    searcher with numpy randomness over `sweep_topology_batch` (one call
    per point and generation). Runs on the card unless `device="cpu"`.

    `devices` with more than one entry (this process's; entries may
    repeat), or one per process after `distributed.init_distributed`,
    shards the device engine's islands when they divide evenly over the
    fleet's devices, as the reference does (otherwise the search runs as
    one block on the first device): each block's chains step on its
    device with the whole search's `epoch_step` design, the ring migration
    gathers every block's incumbents, and the archive is replayed over
    every block's candidates; the result equals the one-device search's
    and carries a `"sharding"` description.

    Returns the Pareto front as `"front"` entries (topology, placement,
    knobs, objectives), the raw archive, the per-(topology, generation)
    history, the island incumbents, scores and weights and the searched
    grids.
    """
    with backend.span("search_codesign", backend.LAYER_ENTRY):
        if engine not in ("device", "host"):
            raise ValueError(f"unknown engine {engine!r} (device|host)")
        _check_codesign_params(generations, population, migrate_every,
                               archive)
        cs, gs, rs = _check_topology_grids(sim, topo_grids)
        knobs, islands = _check_knob_grids(knob_grids, islands)
        shard, sharded = S._grid_sharding(islands, devices, device,
                                          "islands")
        dev = shard.devices[0]
        if engine == "host" or shard.pad:
            # As the reference: islands shard only when they divide evenly
            # over the devices; the host engine runs on one device.
            shard, sharded = S._grid_sharding(islands, None, dev, "islands")
        batch = _codesign_batch(trace)
        if engine == "host":
            return _host_codesign(
                batch, sim, cs, gs, rs, knobs, islands, device=dev,
                generations=generations, population=population,
                migrate_every=migrate_every, archive=archive, seed=seed,
                temperature=temperature, cooling=cooling,
                restart_frac=restart_frac)

        with backend.span("codesign.prepare", backend.LAYER_TABLES):
            sim_p, rows, _cfgs, c_max, statics = _prepare_codesign(
                sim, cs, gs, rs, dev)
            arrays = S._topo_trace_arrays(batch, c_max, dev)
            knob_grid = _knob_grid(knobs, islands, sim, gs)
            lane_rows = {k: rows[k] for k in _LANE_ROWS}
            w_axis = int(arrays[0].shape[0]) if arrays[0].dim() == 3 else 1
            hyper = _hyper(temperature, cooling, restart_frac)
            g = gs[0]
            key = trandom.prng_key(seed, device=dev)
            draw_shape = (len(cs), generations, islands, population - 1,
                          int(rows["coords"].shape[1]), g,
                          hyper["restart_frac"])
            temps = torch.as_tensor(_temperatures(
                hyper["temperature"], hyper["cooling"], generations),
                device=dev)
            weights = island_weights(islands)
            lanes = len(cs) * islands * population * w_axis
            scorings = []
            for (_, idx), (_, (rows_b, arrays_b)) in zip(
                    shard.local_blocks(),
                    shard.replicate((lane_rows, arrays))):
                scoring = S.codesign_scoring(
                    sim_p, rows_b,
                    {f: v[:, idx] for f, v in knob_grid.items()},
                    arrays_b, population, np.asarray(cs))
                design = S._pin_design(sim_p, scoring.xs, scoring.kwargs,
                                       lanes, topo=scoring.topo)
                scorings.append(scoring)
            weights_t = torch.as_tensor(weights, device=dev)
            slot = "eager"
            if _graph_gate(engine, dev, len(scorings), process_count()):
                inputs = (key, temps, weights_t, rows, scorings)
                gkey = _graph_key(
                    dev, sim_p, (sim.cfg, tuple(cs), g, tuple(rs)),
                    _tensors(inputs), generations=generations,
                    population=population, migrate_every=migrate_every,
                    archive=archive, islands=islands, w_axis=w_axis,
                    restart_frac=hyper["restart_frac"], design=design,
                    **statics)
                slot = _graph_slot(gkey)
            if slot == "eager":
                draws = _draws(key, *draw_shape)
        core_kw = dict(generations=generations, population=population,
                       migrate_every=migrate_every, archive=archive,
                       **statics)
        if slot == "eager":
            packed, _trail = _codesign_core(shard, scorings, draws, temps,
                                            rows, weights_t, **core_kw)
        else:
            if slot == "capture":
                # The eager code is the capture's body, run on the graph's
                # static tensors.
                def body(key, temps, weights_t, rows, scorings):
                    return _codesign_core(
                        shard, scorings, _draws(key, *draw_shape), temps,
                        rows, weights_t, **core_kw)[0]
                slot = _GRAPHS[gkey] = _SearchGraph(body, inputs, rows)
            with backend.span("codesign.replay", backend.LAYER_TABLES):
                packed = slot.replay(inputs)
        with backend.span("codesign.result", backend.LAYER_ENTRY):
            # Counted once the last generation is launched: a search that
            # raised never counts.
            S._STATS["search_dispatches"] += 1
            if packed.is_cuda:
                backend.count_host_read("search_codesign.packed",
                                        packed.nbytes)
            host = _unpack(packed.cpu().numpy(), archive, g,  # the copy
                           len(cs), generations, islands)
            meta = {"generations": generations, "population": population,
                    "migrate_every": migrate_every,
                    "archive_capacity": archive, "workloads": w_axis,
                    "candidate_evals": len(cs) * generations * islands
                    * population * w_axis}
            if sharded:
                meta["sharding"] = shard.describe()
            return _codesign_result(host["archive"], host["history"],
                                    host["inc_pos"], host["inc_s"], weights,
                                    cs, gs, rs, knobs, islands, "device",
                                    meta)


# ---------------------------------------------------------------------------
# Host engine and front re-scoring
# ---------------------------------------------------------------------------

def _host_propose(parent, cfg_t, coords, rng, moves, restart_frac, g):
    """One host candidate: a restart or 1-2 collision-free moves,
    spread-ordered (the device proposal semantics with numpy
    randomness)."""
    if rng.rand() < restart_frac:
        idx = rng.choice(len(coords), size=g, replace=False)
        pos = [coords[int(i)] for i in idx]
    else:
        pos = list(parent)
        for _ in range(moves):
            i = int(rng.randint(g))
            occupied = set(pos)
            free = [c for c in coords if c not in occupied]
            if not free:
                break
            pos[i] = free[int(rng.randint(len(free)))]
    return normalize_placement(pos, cfg_t, order="spread")


def _sweep_objectives(batch, sim, grids: dict, device) -> np.ndarray:
    """Objectives [lanes, 3] of one `sweep_topology_batch` call, averaged
    over the workloads in float64 on the host."""
    out = S.sweep_topology_batch(batch, sim, device=device, **grids)
    return np.stack(
        [np.asarray(out["summary"][m].cpu().numpy(), np.float64).mean(axis=0)
         for m in PARETO_OBJECTIVES], axis=-1)


def _host_codesign(batch, sim, cs, gs, rs, knobs, islands, *, device,
                   generations, population, migrate_every, archive, seed,
                   temperature, cooling, restart_frac) -> dict:
    """Host-driven mirror of the device search: the same migration,
    acceptance and archive rules and per-point knob clamps (those of
    `sweep_topology_batch`), with numpy randomness and one sweep call per
    (topology point, generation). Its PRNG stream is the reference host
    engine's, so it walks the reference host engine's trajectory."""
    g = gs[0]
    cfg = sim.cfg
    cfgs = [cfg.with_topology(n_chiplets=c, gateways_per_chiplet=g,
                              mesh_radix=r) for c, r in zip(cs, rs)]
    w_axis = int(batch["ext_load"].shape[0])
    weights = island_weights(islands).astype(np.float64)
    rng = np.random.RandomState(seed)
    moves_hi = max(1, generations // 3)
    lanes = islands * population
    arch = _empty_archive_np(archive, g)
    hist = np.zeros((len(cfgs), generations, len(CODESIGN_HISTORY_KEYS)))
    inc_pos_all, inc_s_all = [], []

    for t, cfg_t in enumerate(cfgs):
        coords = [tuple(int(v) for v in c)
                  for c in topology.router_coords(cfg_t)]
        dflt = normalize_placement(resolve_gateway_positions(cfg_t), cfg_t)
        parent = [dflt] * islands
        inc_pos = list(parent)
        inc_s = np.full((islands,), np.inf)
        norm = np.ones((islands, 3))
        for gen in range(generations):
            if migrate_every > 0 and gen > 0 \
                    and gen % migrate_every == 0:
                parent = [inc_pos[(k - 1) % islands]
                          for k in range(islands)]
            moves = 2 if gen < moves_hi else 1
            cands = [[parent[k]]
                     + [_host_propose(parent[k], cfg_t, coords, rng,
                                      moves, restart_frac, g)
                        for _ in range(population - 1)]
                     for k in range(islands)]

            grids = {"n_chiplets": [cs[t]] * lanes,
                     "gateways_per_chiplet": [g] * lanes,
                     "mesh_radix": [rs[t]] * lanes,
                     "gateway_positions": [cands[k][p]
                                           for k in range(islands)
                                           for p in range(population)]}
            for f, vals in knobs.items():
                grids[f] = [vals[k] for k in range(islands)
                            for _ in range(population)]
            objs = _sweep_objectives(batch, sim, grids, device).reshape(
                islands, population, 3)

            if gen == 0:
                norm = objs[:, 0, :].copy()
            denom = np.maximum(np.abs(norm), 1e-12)
            s = np.sum(weights[:, None, :] * objs / denom[:, None, :],
                       axis=-1)
            ib = np.argmin(s, axis=1)
            sb = s[np.arange(islands), ib]
            cb = [cands[k][int(ib[k])] for k in range(islands)]
            for k in range(islands):
                if sb[k] < inc_s[k]:
                    inc_s[k] = sb[k]
                    inc_pos[k] = cb[k]
            u = rng.rand(islands)
            temp = temperature * cooling ** gen
            for k in range(islands):
                delta = sb[k] - s[k, 0]
                rel = delta / max(abs(s[k, 0]), 1e-12)
                metropolis = temp > 0 \
                    and u[k] < np.exp(-rel / max(temp, 1e-30))
                if delta < 0 or metropolis:
                    parent[k] = cb[k]
            arch = _archive_insert_np(
                arch, objs.reshape(-1, 3),
                np.asarray([cands[k][p] for k in range(islands)
                            for p in range(population)], np.int32),
                np.full((lanes,), t, np.int32),
                np.repeat(np.arange(islands, dtype=np.int32), population),
                archive)
            hist[t, gen] = [float(np.sum(arch["valid"])),
                            float(np.min(inc_s))]
        inc_pos_all.append([np.asarray(p, np.int32) for p in inc_pos])
        inc_s_all.append(inc_s.copy())

    meta = {"generations": generations, "population": population,
            "migrate_every": migrate_every, "archive_capacity": archive,
            "workloads": w_axis,
            "candidate_evals": len(cfgs) * generations * islands
            * population * w_axis}
    return _codesign_result(arch, hist, np.asarray(inc_pos_all),
                            np.asarray(inc_s_all), weights, cs, gs, rs,
                            knobs, islands, "host", meta)


def rescore_front_host(result, trace, sim, *, device=None) -> np.ndarray:
    """Re-score a co-design front through the public host sweep path.

    Every front entry becomes one `sweep_topology_batch` lane: its
    topology point, its (already spread-ordered) placement pinned via the
    `gateway_positions` axis, its island knobs as runtime lanes; the
    per-workload summaries average as the search's do. Returns [n_front,
    3] float64, equal to the front's objectives at 1e-6. Runs on the card
    unless `device="cpu"`.
    """
    entries = result["front"]
    if not entries:
        return np.zeros((0, 3), np.float64)
    grids = {
        "n_chiplets": [e["topology"]["n_chiplets"] for e in entries],
        "gateways_per_chiplet": [e["topology"]["gateways_per_chiplet"]
                                 for e in entries],
        "mesh_radix": [e["topology"]["mesh_radix"] for e in entries],
        "gateway_positions": [e["placement"] for e in entries],
    }
    for f in result.get("knob_grids", {}):
        grids[f] = [e["knobs"][f] for e in entries]
    return _sweep_objectives(_codesign_batch(trace), sim, grids,
                             backend.resolve_device(device))
