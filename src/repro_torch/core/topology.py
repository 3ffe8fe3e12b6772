"""Router coordinate / adjacency model (port of `repro.core.topology`).

A verbatim copy of the reference's design-time numpy geometry, so the port
builds bit-identical tables without importing the JAX package.

Until PR 10 every table builder in the stack — `selection` balanced
partitions, `gateway_controller` activation spread, `photonics` access
loss, the `noc_step` flit router — assumed an implicit mesh-radix layout:
router coordinates were a `mesh_x x mesh_y` grid, distances were Manhattan
closed forms, and "edge" meant the grid border. That blocked exactly the
layouts the co-design literature searches over (PlaceIT's placement-based
topologies, HexaMesh's hexagonal hundreds-of-chiplet arrangements).

This module is the single source of truth for router geometry:

  * `router_coords(cfg)`   — [R, 2] integer coordinates. The mesh grid is
    the DERIVED DEFAULT (`cfg.coords is None`); explicit
    `NetworkConfig.coords` (a hashable tuple) pins an arbitrary layout,
    with `hex_coords(rings)` as the first generator beyond the mesh.
  * `hop_matrix(cfg)`      — [R, R] shortest-path hops. Meshes keep the
    exact Manhattan closed form (bit parity with the pre-PR code paths);
    explicit layouts run BFS over the `coord_model` adjacency (mesh
    4-neighbor / hex 6-neighbor), so partial or holed layouts route
    *around* missing routers instead of through them.
  * gather LUTs (`hop_lut`, `router_index_lut`, `edge_lut`,
    `centrality_lut`) — dense [X, Y]-indexed numpy constants that let the
    TRACEABLE twins (`selection.placement_tables_jnp`,
    `gateway_controller.activation_order_jnp`, the device search) consume
    arbitrary layouts as pure gathers on traced (x, y) positions. On a
    mesh every gather reproduces the old closed form exactly — the 1e-6
    (mostly bit-exact) parity the existing placement/topology tests pin.

Everything here is design-time numpy, lru-memoized per frozen
`NetworkConfig` (the same compile-free discipline as the selection
tables); arrays are returned read-only and must not be mutated.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.constants import NETWORK, NetworkConfig

# Adjacency generators per coordinate model. Mesh: 4-neighbor grid steps.
# Hex: axial-coordinate neighbors — with hex layouts stored as shifted
# axial (q, r) pairs, the six unit moves are the four grid steps plus the
# two anti-diagonal ones.
NEIGHBOR_OFFSETS = {
    "mesh": ((1, 0), (-1, 0), (0, 1), (0, -1)),
    "hex": ((1, 0), (-1, 0), (0, 1), (0, -1), (1, -1), (-1, 1)),
}


def _ro(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


def check_coord_model(model: str) -> None:
    if model not in NEIGHBOR_OFFSETS:
        raise ValueError(f"unknown coord_model {model!r} "
                         f"(known: {sorted(NEIGHBOR_OFFSETS)})")


def hex_coords(rings: int) -> tuple:
    """Hexagonal router layout: `rings` full rings around a center router.

    Axial coordinates (q, r) with max(|q|, |r|, |q+r|) <= rings, shifted by
    +rings so every coordinate is non-negative (3*rings*(rings+1)+1
    routers). Row order is lexicographic in the shifted (x, y) — the
    hex analogue of the mesh's x*mesh_y+y router ordering. Returns the
    hashable tuple form `NetworkConfig.coords` carries.
    """
    if rings < 1:
        raise ValueError(f"hex layout needs rings >= 1, got {rings}")
    out = []
    for q in range(-rings, rings + 1):
        for r in range(-rings, rings + 1):
            if abs(q + r) <= rings:
                out.append((q + rings, r + rings))
    return tuple(out)


def hex_config(rings: int, base: NetworkConfig = NETWORK,
               **replace) -> NetworkConfig:
    """A `base`-derived config whose chiplet network is a hexagonal patch.

    Sets `coords=hex_coords(rings)`, `coord_model="hex"`, and sizes
    `mesh_x`/`mesh_y` to the layout's bounding box (the dense LUT shape —
    nothing below reads them as a router count once `coords` is set).
    """
    import dataclasses

    coords = hex_coords(rings)
    side = 2 * rings + 1
    return dataclasses.replace(base, coords=coords, coord_model="hex",
                               mesh_x=side, mesh_y=side,
                               gateway_positions=None, **replace)


@functools.lru_cache(maxsize=None)
def router_coords(cfg: NetworkConfig) -> np.ndarray:
    """[R, 2] int32 router coordinates (mesh grid unless cfg.coords pins
    an explicit layout). Mesh row order is flat index x*mesh_y + y."""
    if cfg.coords is not None:
        pos = np.asarray(cfg.coords, np.int32).reshape(-1, 2)
        if pos.min() < 0:
            raise ValueError(f"negative router coordinates in "
                             f"NetworkConfig.coords: {cfg.coords}")
        if len(np.unique(pos, axis=0)) != len(pos):
            raise ValueError("NetworkConfig.coords contains duplicate "
                             "router coordinates")
        return _ro(pos)
    xs, ys = np.meshgrid(np.arange(cfg.mesh_x), np.arange(cfg.mesh_y),
                         indexing="ij")
    return _ro(np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.int32))


def lut_shape(cfg: NetworkConfig) -> tuple:
    """(X, Y) dense lookup-table shape covering every router coordinate."""
    if cfg.coords is None:
        return (cfg.mesh_x, cfg.mesh_y)
    pos = router_coords(cfg)
    return (int(pos[:, 0].max()) + 1, int(pos[:, 1].max()) + 1)


@functools.lru_cache(maxsize=None)
def router_index_lut(cfg: NetworkConfig) -> np.ndarray:
    """[X, Y] int32: coordinate -> router row index, -1 off-layout.

    On a mesh this is exactly the flat index x*mesh_y + y the pre-PR
    occupancy tests used — the traceable search keeps its integer
    semantics through a gather instead of a multiply-add.
    """
    pos = router_coords(cfg)
    lut = np.full(lut_shape(cfg), -1, np.int32)
    lut[pos[:, 0], pos[:, 1]] = np.arange(len(pos), dtype=np.int32)
    return _ro(lut)


@functools.lru_cache(maxsize=None)
def hop_matrix(cfg: NetworkConfig) -> np.ndarray:
    """[R, R] int32 router-to-router hop counts.

    Mesh default: the Manhattan closed form (bit parity with the pre-PR
    `selection.hop_count` paths — XY routing hops). Explicit layouts:
    BFS shortest path over the `coord_model` adjacency, which equals the
    metric closed form on full patches and stays correct on partial ones.
    Raises on disconnected layouts (a router no packet can reach is a
    modelling error, not a soft case).
    """
    pos = router_coords(cfg).astype(np.int64)
    if cfg.coords is None:
        d = np.abs(pos[:, None, :] - pos[None, :, :]).sum(-1)
        return _ro(d.astype(np.int32))
    check_coord_model(cfg.coord_model)
    idx = router_index_lut(cfg)
    n = len(pos)
    xmax, ymax = idx.shape
    neigh = []
    for dx, dy in NEIGHBOR_OFFSETS[cfg.coord_model]:
        nx, ny = pos[:, 0] + dx, pos[:, 1] + dy
        ok = (0 <= nx) & (nx < xmax) & (0 <= ny) & (ny < ymax)
        j = np.where(ok, idx[np.clip(nx, 0, xmax - 1),
                            np.clip(ny, 0, ymax - 1)], -1)
        neigh.append(j)
    neigh = np.stack(neigh, axis=1)                       # [R, deg], -1 pad
    dist = np.full((n, n), -1, np.int32)
    for s in range(n):                                    # BFS per source
        dist[s, s] = 0
        frontier = [s]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in neigh[u]:
                    if v >= 0 and dist[s, v] < 0:
                        dist[s, v] = d
                        nxt.append(int(v))
            frontier = nxt
    if (dist < 0).any():
        raise ValueError(
            f"NetworkConfig.coords describes a disconnected "
            f"{cfg.coord_model} layout ({int((dist[0] < 0).sum())} "
            f"unreachable routers from router 0)")
    return _ro(dist)


@functools.lru_cache(maxsize=None)
def hop_lut(cfg: NetworkConfig) -> np.ndarray:
    """[R, X, Y] int32: hops from router r to the router AT (x, y).

    Off-layout (x, y) slots hold max_hops + 1 (a finite, dominated
    sentinel — valid placements never gather them; masked consumers can
    rely on the value staying within int range).
    """
    pos = router_coords(cfg)
    hm = hop_matrix(cfg)
    lut = np.full((len(pos),) + lut_shape(cfg), int(hm.max()) + 1, np.int32)
    lut[:, pos[:, 0], pos[:, 1]] = hm
    return _ro(lut)


@functools.lru_cache(maxsize=None)
def max_hops(cfg: NetworkConfig) -> int:
    """Network diameter in hops (mesh: mesh_x + mesh_y - 2)."""
    return int(hop_matrix(cfg).max())


@functools.lru_cache(maxsize=None)
def mean_hops(cfg: NetworkConfig) -> float:
    """Mean hop count between uniformly random (iid) router pairs.

    Mesh default keeps the exact closed form the NoC model always used
    (E|x1-x2| = (n^2-1)/(3n) per axis); explicit layouts average the hop
    matrix — identical on full grids, correct on everything else.
    """
    if cfg.coords is None:
        mx, my = cfg.mesh_x, cfg.mesh_y
        ex = (mx * mx - 1) / (3.0 * mx)
        ey = (my * my - 1) / (3.0 * my)
        return float(ex + ey)
    return float(hop_matrix(cfg).mean())


def feed_width(cfg: NetworkConfig) -> float:
    """Mesh-feed width for the intra-chiplet link-load model.

    The scan body divides injected intra-chiplet flit load over
    2 * feed_width parallel mesh rows. Mesh: mesh_x (the pre-PR constant,
    bit parity). Explicit layouts: sqrt(R) — the equivalent-area square's
    row count, so hex patches see a comparable bisection.
    """
    if cfg.coords is None:
        return float(cfg.mesh_x)
    return float(np.sqrt(len(router_coords(cfg))))


@functools.lru_cache(maxsize=None)
def edge_distance(cfg: NetworkConfig) -> np.ndarray:
    """[R] int32 hops from each router to the layout boundary.

    Mesh default: the exact min(x, mx-1-x, y, my-1-y) closed form the
    access-loss model always used. Explicit layouts: hop distance to the
    nearest boundary router, where "boundary" means any router with fewer
    than the full `coord_model` neighbor count — the routers a chiplet's
    edge couplers sit next to.
    """
    pos = router_coords(cfg)
    if cfg.coords is None:
        d = np.minimum.reduce([pos[:, 0], cfg.mesh_x - 1 - pos[:, 0],
                               pos[:, 1], cfg.mesh_y - 1 - pos[:, 1]])
        return _ro(d.astype(np.int32))
    check_coord_model(cfg.coord_model)
    idx = router_index_lut(cfg)
    xmax, ymax = idx.shape
    deg = np.zeros((len(pos),), np.int32)
    for dx, dy in NEIGHBOR_OFFSETS[cfg.coord_model]:
        nx, ny = pos[:, 0] + dx, pos[:, 1] + dy
        ok = (0 <= nx) & (nx < xmax) & (0 <= ny) & (ny < ymax)
        j = np.where(ok, idx[np.clip(nx, 0, xmax - 1),
                            np.clip(ny, 0, ymax - 1)], -1)
        deg += (j >= 0).astype(np.int32)
    boundary = deg < len(NEIGHBOR_OFFSETS[cfg.coord_model])
    if not boundary.any():        # pragma: no cover - degenerate layouts
        boundary = np.ones_like(boundary)
    return _ro(hop_matrix(cfg)[:, boundary].min(axis=1).astype(np.int32))


@functools.lru_cache(maxsize=None)
def edge_lut(cfg: NetworkConfig) -> np.ndarray:
    """[X, Y] int32 boundary distance per coordinate (0 off-layout)."""
    pos = router_coords(cfg)
    lut = np.zeros(lut_shape(cfg), np.int32)
    lut[pos[:, 0], pos[:, 1]] = edge_distance(cfg)
    return _ro(lut)


@functools.lru_cache(maxsize=None)
def centrality_int(cfg: NetworkConfig) -> np.ndarray:
    """[R] int32 centrality key (smaller = more central, scale-free).

    Mesh default: 2x the Manhattan distance to the geometric mesh center —
    the exact integer key `activation_order_jnp` always used, so mesh
    activation orders stay bit-identical. Explicit layouts: total hops to
    every router (the medoid rule), which needs no geometric center.
    """
    pos = router_coords(cfg).astype(np.int64)
    if cfg.coords is None:
        c = (np.abs(2 * pos[:, 0] - (cfg.mesh_x - 1))
             + np.abs(2 * pos[:, 1] - (cfg.mesh_y - 1)))
        return _ro(c.astype(np.int32))
    return _ro(hop_matrix(cfg).sum(axis=1).astype(np.int32))


@functools.lru_cache(maxsize=None)
def centrality_lut(cfg: NetworkConfig) -> np.ndarray:
    """[X, Y] int32 centrality per coordinate (off-layout: big sentinel)."""
    pos = router_coords(cfg)
    cent = centrality_int(cfg)
    lut = np.full(lut_shape(cfg), int(cent.max()) + 1, np.int32)
    lut[pos[:, 0], pos[:, 1]] = cent
    return _ro(lut)


def centrality_bound(cfg: NetworkConfig) -> int:
    """Strict upper bound on `centrality_int` values (composite-key base).

    Mesh keeps the exact pre-PR constant 2*(mesh_x + mesh_y - 2) + 1 so
    the integer activation-order keys are bit-identical there.
    """
    if cfg.coords is None:
        return 2 * (cfg.mesh_x + cfg.mesh_y - 2) + 1
    return int(centrality_int(cfg).max()) + 1


def pair_hops(cfg: NetworkConfig, a, b) -> np.ndarray:
    """Hop count between coordinate arrays a, b (numpy, broadcastable).

    Mesh default: Manhattan (the pre-PR `selection.hop_count`). Explicit
    layouts: hop-matrix lookups — both arrays must hold actual router
    coordinates.
    """
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    if cfg.coords is None:
        return np.abs(a[..., 0] - b[..., 0]) + np.abs(a[..., 1] - b[..., 1])
    idx = router_index_lut(cfg)
    ia, ib = idx[a[..., 0], a[..., 1]], idx[b[..., 0], b[..., 1]]
    if (np.asarray(ia) < 0).any() or (np.asarray(ib) < 0).any():
        raise ValueError("pair_hops: coordinates fall outside the layout "
                         "described by NetworkConfig.coords")
    return hop_matrix(cfg)[ia, ib]


@functools.lru_cache(maxsize=None)
def default_positions(cfg: NetworkConfig) -> np.ndarray:
    """Default gateway placement for an explicit (non-mesh) layout.

    The mesh default is the hand-ordered 4-edge-slot scheme
    (`selection.default_gateway_positions`); layouts with explicit coords
    get its deterministic generalization: gateways sit on boundary routers
    (edge_distance == 0 — zero access-waveguide loss, like the mesh edge
    scheme), the first being the most central boundary router and each
    further one greedily maximizing its minimum hop distance to the chosen
    set (ties: centrality, then router index).
    """
    g = cfg.max_gateways_per_chiplet
    pos = router_coords(cfg)
    cent = centrality_int(cfg)
    hm = hop_matrix(cfg)
    cands = np.flatnonzero(edge_distance(cfg) == 0)
    if len(cands) < g:
        raise ValueError(
            f"layout has {len(cands)} boundary routers but "
            f"max_gateways_per_chiplet={g}; pass explicit "
            f"NetworkConfig.gateway_positions")
    chosen = [int(cands[np.lexsort((cands, cent[cands]))[0]])]
    rest = [int(c) for c in cands if c != chosen[0]]
    while len(chosen) < g:
        dmin = hm[np.asarray(rest)][:, np.asarray(chosen)].min(axis=1)
        best = np.lexsort((rest, cent[np.asarray(rest)], -dmin))[0]
        chosen.append(rest.pop(int(best)))
    return _ro(pos[np.asarray(chosen)].astype(np.int32))


def lut_tensors(cfg: NetworkConfig, device) -> dict:
    """The gather tables the tensor twins read, as int64 tensors on
    `device` (memoized per (cfg, device), so a search builds them once,
    before its generation loop, and never copies a table to the device
    inside it): `coords` [R, 2], `router_index` [X, Y], `hop` [R, X, Y],
    `edge` [X, Y] and `centrality` [X, Y]."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # One entry for "cuda" and the tensors' "cuda:<current>".
        device = torch.device("cuda", torch.cuda.current_device())
    return _lut_tensors(cfg, str(device))


@functools.lru_cache(maxsize=None)
def _lut_tensors(cfg: NetworkConfig, device: str) -> dict:
    tables = {"coords": router_coords(cfg),
              "router_index": router_index_lut(cfg), "hop": hop_lut(cfg),
              "edge": edge_lut(cfg), "centrality": centrality_lut(cfg)}
    return {k: torch.as_tensor(np.asarray(v, np.int64), device=device)
            for k, v in tables.items()}


def clear_topology_caches() -> None:
    """Drop every memoized geometry table (test isolation helper)."""
    for f in (router_coords, router_index_lut, hop_matrix, hop_lut,
              max_hops, mean_hops, edge_distance, edge_lut, centrality_int,
              centrality_lut, default_positions, _lut_tensors):
        f.cache_clear()
