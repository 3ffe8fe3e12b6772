"""Adaptive gateway selection (§3.4, Fig. 8): design-time tables.

Port of `repro.core.selection`. Routing an inter-chiplet packet takes three
steps: source router -> source gateway, gateway -> gateway over the
interposer, destination gateway -> destination router. The selection
decisions are design-time tables, one per activation level g: routers are
partitioned into balanced groups of R/g per gateway, each group holding the
routers nearest to its gateway (Fig. 8 a-d).

The numpy builders are verbatim copies of the reference's (so the tables
match it bit for bit); `selection_tables_torch` is the memoized
device-resident view the simulator gathers from. `placement_tables_torch`
and `placement_tables_from_lut_torch` build the two columns the epoch
simulator reads for a batch of placements on the device (the device
placement search's candidates), bit for bit the reference's jnp twins.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.backend import LAYER_TABLES, resolve_device, span
from repro_torch.core import photonics, topology
from repro_torch.core.constants import NETWORK, NetworkConfig
from repro_torch.core.gateway_controller import activation_order


def _validate_positions(pos: np.ndarray, cfg: NetworkConfig,
                        what: str) -> None:
    """Reject out-of-bounds or colliding gateway coordinates loudly.

    Small meshes used to make the default edge formulas (`mx - 2`, `my - 2`)
    underflow into negative or duplicate coordinates *silently*; every
    placement now funnels through this check before any table is built.
    Explicit-coords layouts additionally require each coordinate to name an
    actual router (the dense LUT bounding box has off-layout holes).
    """
    bx, by = topology.lut_shape(cfg)
    oob = ((pos[:, 0] < 0) | (pos[:, 0] >= bx)
           | (pos[:, 1] < 0) | (pos[:, 1] >= by))
    if oob.any():
        bad = [tuple(p) for p in pos[oob]]
        raise ValueError(
            f"{what}: gateway coordinates {bad} fall outside the "
            f"{bx}x{by} chiplet mesh")
    if cfg.coords is not None:
        idx = topology.router_index_lut(cfg)
        hole = idx[pos[:, 0], pos[:, 1]] < 0
        if hole.any():
            bad = [tuple(p) for p in pos[hole]]
            raise ValueError(
                f"{what}: gateway coordinates {bad} are not routers of the "
                f"{cfg.coord_model} layout in NetworkConfig.coords")
    uniq, counts = np.unique(pos, axis=0, return_counts=True)
    if (counts > 1).any():
        dup = [tuple(p) for p in uniq[counts > 1]]
        raise ValueError(
            f"{what}: gateway coordinates collide at {dup} — each gateway "
            f"needs its own router on the {cfg.mesh_x}x{cfg.mesh_y} mesh")


# Slot count of the default edge-distributed scheme below; placements with
# more gateways need explicit NetworkConfig.gateway_positions.
N_DEFAULT_EDGE_SLOTS = 4


def default_gateway_positions(cfg: NetworkConfig = NETWORK) -> np.ndarray:
    """Gateway-attached router coordinates on the chiplet mesh.

    Placement follows the edge-distributed scheme of [29]/Fig. 8d: gateways
    sit on distinct edges so that consecutive activation levels keep them
    maximally spread. Activation order is the row order of this array.
    Raises a clear ValueError on meshes too small to host the scheme
    (the edge formulas need every sliced slot in-bounds and distinct).
    Explicit-coords layouts (hex patches etc.) have no fixed edge slots;
    they use the deterministic boundary max-min-spread generalization in
    `topology.default_positions`.
    """
    if cfg.coords is not None:
        pos = np.array(topology.default_positions(cfg), dtype=np.int32)
        _validate_positions(
            pos, cfg, f"default_gateway_positions on a {cfg.coord_model} "
                      f"layout")
        return pos
    mx, my = cfg.mesh_x, cfg.mesh_y
    pos = np.array([
        [1, 0],                 # G1: south edge
        [mx - 2, my - 1],       # G2: north edge (opposite side for g=2)
        [0, my - 2],            # G3: west edge
        [mx - 1, 1],            # G4: east edge
    ], dtype=np.int32)
    assert len(pos) == N_DEFAULT_EDGE_SLOTS
    if cfg.max_gateways_per_chiplet > len(pos):
        raise ValueError(
            f"default edge scheme defines {len(pos)} gateway slots but "
            f"max_gateways_per_chiplet={cfg.max_gateways_per_chiplet}; pass "
            f"explicit NetworkConfig.gateway_positions for denser placements")
    pos = pos[: cfg.max_gateways_per_chiplet]
    _validate_positions(
        pos, cfg, f"default_gateway_positions on a {mx}x{my} mesh")
    return pos


def resolve_gateway_positions(cfg: NetworkConfig = NETWORK) -> np.ndarray:
    """The placement the config actually means: explicit or default.

    Explicit `cfg.gateway_positions` are validated (bounds, collisions,
    enough rows for `max_gateways_per_chiplet`) and sliced to the first
    `max_gateways_per_chiplet` rows (activation order); None falls back to
    the edge-distributed default scheme. Everything downstream — selection
    tables, flit-kernel topology building, access-waveguide loss — goes
    through this single resolution point.
    """
    if cfg.gateway_positions is None:
        return default_gateway_positions(cfg)
    pos = np.asarray(cfg.gateway_positions, np.int32).reshape(-1, 2)
    if len(pos) < cfg.max_gateways_per_chiplet:
        raise ValueError(
            f"gateway_positions places {len(pos)} gateways but "
            f"max_gateways_per_chiplet={cfg.max_gateways_per_chiplet}")
    _validate_positions(pos, cfg, "gateway_positions")
    return pos[: cfg.max_gateways_per_chiplet]


def normalize_placement(positions, cfg: NetworkConfig = NETWORK, *,
                        order: str = "given"):
    """Canonicalize a placement into the hashable tuple form configs carry.

    `order="spread"` re-rows the placement by the controller's activation
    order (gateway_controller.activation_order) so partial activation levels
    stay well-spread; `order="given"` keeps the caller's row order. Returns
    None unchanged (the default scheme marker).
    """
    if positions is None:
        return None
    pos = np.asarray(positions, np.int64).reshape(-1, 2)
    if order == "spread":
        pos = pos[activation_order(pos, cfg)]
    elif order != "given":
        raise ValueError(f"unknown placement order: {order!r}")
    return tuple((int(x), int(y)) for x, y in pos)


def _balanced_assignment_from_dist(dist: np.ndarray,
                                   capacity: int) -> np.ndarray:
    """Greedy balanced nearest-gateway partition from a [R, G] hop matrix.

    Processes (router, gateway) pairs in (distance, router id, gateway id)
    order and assigns greedily under a per-gateway capacity of ceil(R/g) —
    the R_g = R/g_c balance rule of §3.4. The pair ordering is a single
    vectorized `np.lexsort` (the O(R*G log RG) part); only the inherently
    sequential capacity-constrained walk remains a Python loop, with an
    early exit once every router is assigned.
    """
    n_r, n_g = dist.shape
    rr, gg = np.divmod(np.arange(n_r * n_g), n_g)
    order = np.lexsort((gg, rr, dist.ravel()))     # primary: distance
    assign = np.full((n_r,), -1, dtype=np.int32)
    load = np.zeros((n_g,), dtype=np.int32)
    remaining = n_r
    for idx in order:
        r, g = rr[idx], gg[idx]
        if assign[r] == -1 and load[g] < capacity:
            assign[r] = g
            load[g] += 1
            remaining -= 1
            if remaining == 0:
                break
    # Any leftovers (capacity exhausted by ties) -> least-loaded gateway.
    left = np.flatnonzero(assign == -1)
    for r in left:
        g = int(np.argmin(load))
        assign[r] = g
        load[g] += 1
    return assign


@dataclasses.dataclass(frozen=True)
class SelectionTables:
    """Design-time tables, one slice per activation level g in 1..G.

    src_map:  [G, R] int  — source gateway index for each router when g
                            gateways are active (entries < g).
    dst_map:  [G, R] int  — destination gateway for each destination router.
    src_hops: [G]  float  — mean router->gateway hops under src_map.
    dst_hops: [G]  float  — mean gateway->router hops under dst_map.
    gw_loss_db: [G] float — mean access-waveguide loss (dB) over the active
                            gateways at each level.
    gw_pos:   [Gmax, 2]   — gateway coordinates (activation order).
    """
    src_map: np.ndarray
    dst_map: np.ndarray
    src_hops: np.ndarray
    dst_hops: np.ndarray
    gw_loss_db: np.ndarray
    gw_pos: np.ndarray

    def as_torch(self, device) -> dict:
        return {k: torch.as_tensor(getattr(self, k), device=device)
                for k in ("src_map", "dst_map", "src_hops", "dst_hops",
                          "gw_loss_db")}


@functools.lru_cache(maxsize=None)
def build_selection_tables(cfg: NetworkConfig = NETWORK) -> SelectionTables:
    """Build (and memoize) the design-time tables for one topology.

    `NetworkConfig` is frozen, so equal configs share one cache entry and
    the greedy numpy construction runs at most once per topology. The
    returned arrays must be treated as immutable by callers.
    """
    routers = topology.router_coords(cfg)
    gw_pos = resolve_gateway_positions(cfg)
    n_r = len(routers)
    g_max = cfg.max_gateways_per_chiplet

    # One vectorized [R, Gmax] hop matrix feeds every activation level; the
    # per-level work is the greedy capacity walk plus fancy-indexed means.
    # pair_hops is the Manhattan closed form on meshes (bit parity) and the
    # BFS hop matrix on explicit-coords layouts.
    dist = topology.pair_hops(cfg, routers[:, None, :],
                              gw_pos[None, :, :])               # [R, Gmax]
    levels = np.arange(1, g_max + 1)
    caps = -(-n_r // levels)                                    # ceil(R/g)

    src_map = np.stack([
        _balanced_assignment_from_dist(dist[:, :g], int(cap))
        for g, cap in zip(levels, caps)])                       # [Gmax, R]
    dst_map = src_map.copy()        # step-3 tables share the balance rule
    hops = np.take_along_axis(dist, src_map.T, axis=1)          # [R, Gmax]
    src_hops = hops.mean(axis=0).astype(np.float32)
    dst_hops = src_hops.copy()
    # Level-g mean access loss: running mean over the first g placed
    # gateways — the laser must overcome the average lit access waveguide.
    per_gw_db = photonics.gateway_access_loss_db(gw_pos, cfg)
    gw_loss_db = (np.cumsum(per_gw_db) / levels).astype(np.float32)

    return SelectionTables(src_map=src_map.astype(np.int32),
                           dst_map=dst_map.astype(np.int32),
                           src_hops=src_hops, dst_hops=dst_hops,
                           gw_loss_db=gw_loss_db, gw_pos=gw_pos)


def selection_tables_torch(cfg: NetworkConfig = NETWORK,
                           device=None) -> dict:
    """Memoized device-resident view of the tables for `cfg` (the twin of
    the reference's `selection_tables_jax`): the same dict of tensors for
    equal (cfg, device), so repeated runs never re-upload. `device=None`
    means the card (see `backend.resolve_device`)."""
    with span("selection_tables", LAYER_TABLES):
        return _selection_tables_torch_cached(cfg,
                                              str(resolve_device(device)))


@functools.lru_cache(maxsize=None)
def _selection_tables_torch_cached(cfg: NetworkConfig, device: str) -> dict:
    return build_selection_tables(cfg).as_torch(device)


def mean_access_hops(tables: dict, g: torch.Tensor) -> torch.Tensor:
    """Mean router<->gateway hop count at activation level g (vectorized).

    Levels past the table clamp to its last row, as the reference's gather
    does for out-of-range indices.
    """
    hops = tables["src_hops"]
    return hops[torch.clamp(g.long(), 1, hops.shape[0]) - 1]


# ---------------------------------------------------------------------------
# Tensor twins: tables of placements that stay on the device
# ---------------------------------------------------------------------------

def _class_hop_sums(dist: torch.Tensor, caps: torch.Tensor, d_pad: int,
                    router_on=None) -> torch.Tensor:
    """The balanced partition of every activation level at once, as the
    sum over routers of each router's assigned hop distance [N, L] (int;
    L = G levels, level l using gateways 0..l; a router left unassigned
    adds 0, as in the reference twin).

    `dist` [N, R, G] int router -> gateway hops; `caps` [L] (or [N, L],
    one row per placement) the per-level capacity ceil(R / g); `router_on`
    [R] (or [N, R]) bool masks padded routers. The
    reference's class-column schedule: for each distance d (ascending),
    for each gateway g (ascending), every level that has g takes its first
    `cap - load` unassigned distance-d candidates of g in router order (a
    masked cumsum over routers) - the numpy pair walk's result, exactly.
    Each step is a handful of whole-batch operations on int32 tensors: the
    (d, g) candidate masks, with the levels that lack g zeroed, are built
    once up front.
    """
    n, r, g_n = dist.shape
    dev = dist.device
    i32 = torch.int32
    hit = dist.movedim(-1, 0)[None] \
        == torch.arange(d_pad, device=dev)[:, None, None, None]
    if router_on is not None:
        hit = hit & router_on
    # [D, G, N, L, R]: gateway g's distance-d routers, on the levels >= g.
    has_g = torch.arange(g_n, device=dev)[:, None] \
        <= torch.arange(g_n, device=dev)[None, :]             # [G, L]
    masks = (hit[:, :, :, None, :] & has_g[None, :, None, :, None]).to(i32)
    masks = masks.reshape(d_pad * g_n, n, g_n, r).unbind(0)
    free = torch.ones((n, g_n, r), dtype=i32, device=dev)
    # Room left per (gateway, level), shaped to broadcast over routers.
    room = [caps.to(i32).reshape(-1, g_n, 1).expand(n, g_n, 1).clone()
            for _ in range(g_n)]
    hops = torch.zeros((n, g_n, 1), dtype=i32, device=dev)
    for d in range(d_pad):
        for g in range(g_n):
            cand = free * masks[d * g_n + g]
            rank = torch.cumsum(cand, dim=-1, dtype=i32)      # router order
            take = cand * (rank <= room[g])
            free -= take
            cnt = torch.sum(take, dim=-1, keepdim=True, dtype=i32)
            room[g] -= cnt
            hops.add_(cnt, alpha=d)
    return hops[..., 0]


def _running_mean_db(per_gw_db: torch.Tensor) -> torch.Tensor:
    """Level-g mean access loss [N, G]: the running sum over gateways in
    index order divided by g (as XLA compiles the reference's
    `cumsum(x) / levels`)."""
    g_n = per_gw_db.shape[-1]
    run = [per_gw_db[..., 0]]
    for g in range(1, g_n):
        run.append(run[-1] + per_gw_db[..., g])
    levels = torch.arange(1, g_n + 1, dtype=torch.float32,
                          device=per_gw_db.device)
    return torch.stack(run, dim=-1) / levels


def placement_tables_torch(positions: torch.Tensor,
                           cfg: NetworkConfig = NETWORK) -> dict:
    """Tensor twin of the `build_selection_tables` hot columns for
    placements [..., G, 2] in activation order (the reference's
    `placement_tables_jnp`, batched over leading axes): `src_hops` (mean
    router -> gateway hops under the balanced partition) and `gw_loss_db`
    (running-mean access loss), each float32 [..., G], on the placements'
    device, never leaving it. Bit for bit the reference twin's."""
    from repro_torch.core.photonics import gateway_access_loss_db_torch

    pos = positions.long()
    lead, g_n = pos.shape[:-2], int(pos.shape[-2])
    pos = pos.reshape(-1, g_n, 2)
    lut = topology.lut_tensors(cfg, pos.device)
    routers = lut["coords"]
    n_r = int(routers.shape[0])
    if cfg.coords is None:
        # Derived mesh: the Manhattan closed form (d in 0 .. mx + my - 2).
        d_pad = cfg.mesh_x + cfg.mesh_y - 1
        dist = torch.sum(torch.abs(routers[None, :, None, :]
                                   - pos[:, None, :, :]), dim=-1)
    else:
        d_pad = topology.max_hops(cfg) + 1
        dist = lut["hop"][:, pos[..., 0], pos[..., 1]].movedim(0, 1)
    levels = torch.arange(1, g_n + 1, device=pos.device)
    caps = (n_r + levels - 1) // levels                       # ceil(R/g)
    hops = _class_hop_sums(dist, caps, d_pad)
    # The sum is an exact integer; XLA compiles jnp.mean's division by the
    # constant R as a multiplication by float32(1 / R).
    src_hops = hops.to(torch.float32) * float(np.float32(1.0 / n_r))
    gw_db = _running_mean_db(gateway_access_loss_db_torch(pos, cfg))
    return {"src_hops": src_hops.reshape(lead + (g_n,)),
            "gw_loss_db": gw_db.reshape(lead + (g_n,))}


def placement_tables_from_lut_torch(positions, hop_lut, edge_lut,
                                    router_mask, caps, *, d_pad: int,
                                    db_per_hop: float, point=None) -> dict:
    """`placement_tables_torch` with the topology as data (the reference's
    `placement_tables_from_lut_jnp`, batched over placements [..., g_pad,
    2]): `hop_lut` [r_pad, X, Y] router -> coordinate hops, `edge_lut`
    [X, Y] boundary distances, `router_mask` [r_pad] (1 where the router
    exists), `caps` [g_pad] per-level capacities ceil(R_real / g), `d_pad`
    the distance loop bound, `db_per_hop` the access dB per hop. The same
    class-column schedule over the real routers; `src_hops` is the sum
    over real routers divided by their count.

    With `point` (int, the placements' leading shape) the four topology
    arguments carry a leading [T] axis of topologies and each placement
    reads the rows of its own point: every point of a co-design grid in
    one call, each placement's tables those of a call on its point
    alone."""
    pos = torch.as_tensor(positions).long()
    dev = pos.device
    lead, g_n = pos.shape[:-2], int(pos.shape[-2])
    pos = pos.reshape(-1, g_n, 2)
    hop = torch.as_tensor(hop_lut, device=dev).long()
    edge = torch.as_tensor(edge_lut, device=dev)
    x, y = pos[..., 0], pos[..., 1]
    if point is None:
        r_pad = int(hop.shape[0])
        router_on = torch.as_tensor(router_mask,
                                    device=dev).reshape(r_pad) != 0
        caps = torch.as_tensor(caps, device=dev).long().reshape(g_n)
        n_real = torch.clamp_min(torch.sum(router_on.to(torch.float32)),
                                 1.0)
        dist = hop[:, x, y].movedim(0, 1)
        per_gw = edge[x, y]
    else:
        pt = torch.as_tensor(point, device=dev).long().reshape(-1)
        r_pad = int(hop.shape[1])
        router_on = torch.as_tensor(router_mask, device=dev)[pt] != 0
        caps = torch.as_tensor(caps, device=dev).long()[pt]
        n_real = torch.clamp_min(torch.sum(router_on.to(torch.float32),
                                           dim=-1), 1.0)[:, None]
        dist = hop[pt[:, None, None],
                   torch.arange(r_pad, device=dev)[None, :, None],
                   x[:, None, :], y[:, None, :]]
        per_gw = edge[pt[:, None], x, y]
    hops = _class_hop_sums(dist, caps, int(d_pad), router_on)
    per_gw_db = per_gw.to(torch.float32) * float(np.float32(db_per_hop))
    return {"src_hops": (hops.to(torch.float32) / n_real)
            .reshape(lead + (g_n,)),
            "gw_loss_db": _running_mean_db(per_gw_db)
            .reshape(lead + (g_n,))}


# ---------------------------------------------------------------------------
# Padded tables for topology sweeps
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PaddedSelectionTables:
    """Stacked, zero-padded tables for K topologies sharing one shape.

    Every per-topology table is padded to (g_pad activation levels, r_pad
    routers), so K topologies ride as K lanes of one padded run. Padded
    entries are zero and carry validity masks.

    src_map/dst_map: [K, g_pad, r_pad] int   — padded with gateway 0.
    src_hops/dst_hops: [K, g_pad] float      — padded with 0.0 hops.
    gw_loss_db:  [K, g_pad] float — per-level mean access loss, 0-padded.
    gw_mask:     [K, g_pad] float — 1 where the activation level exists.
    router_mask: [K, r_pad] float — 1 where the router exists.
    n_gateways:  [K] int — real max gateways per chiplet per topology.
    n_routers:   [K] int — real router count per topology.
    """
    src_map: np.ndarray
    dst_map: np.ndarray
    src_hops: np.ndarray
    dst_hops: np.ndarray
    gw_loss_db: np.ndarray
    gw_mask: np.ndarray
    router_mask: np.ndarray
    n_gateways: np.ndarray
    n_routers: np.ndarray

    FIELDS = ("src_map", "dst_map", "src_hops", "dst_hops", "gw_loss_db",
              "gw_mask", "router_mask", "n_gateways", "n_routers")

    def as_torch(self, device) -> dict:
        return {k: torch.as_tensor(getattr(self, k), device=device)
                for k in self.FIELDS}


def _pad_shape(cfgs) -> tuple:
    return (max(c.max_gateways_per_chiplet for c in cfgs),
            max(c.routers_per_chiplet for c in cfgs))


def build_selection_tables_padded(cfgs, pad_to=None) -> PaddedSelectionTables:
    """Build stacked zero-masked tables for a tuple of topologies.

    `pad_to = (g_pad, r_pad)` fixes the padded activation-level and router
    axes; None pads to the max over `cfgs`. Memoized per (cfgs, pad_to);
    each topology's build is keyed on `n_chiplets=1`, since the tables are
    a per-chiplet-mesh structure, so a chiplet scan over one mesh builds
    its tables once. A `pad_to` smaller than a topology's tables raises.
    """
    cfgs = tuple(cfgs)
    return _build_selection_tables_padded_cached(
        cfgs, tuple(_pad_shape(cfgs) if pad_to is None else pad_to))


@functools.lru_cache(maxsize=None)
def _build_selection_tables_padded_cached(cfgs, pad_to
                                          ) -> PaddedSelectionTables:
    g_pad, r_pad = pad_to
    k = len(cfgs)
    src_map = np.zeros((k, g_pad, r_pad), np.int32)
    dst_map = np.zeros((k, g_pad, r_pad), np.int32)
    src_hops = np.zeros((k, g_pad), np.float32)
    dst_hops = np.zeros((k, g_pad), np.float32)
    gw_loss_db = np.zeros((k, g_pad), np.float32)
    gw_mask = np.zeros((k, g_pad), np.float32)
    router_mask = np.zeros((k, r_pad), np.float32)
    n_gw = np.zeros((k,), np.int32)
    n_rt = np.zeros((k,), np.int32)
    for i, cfg in enumerate(cfgs):
        t = build_selection_tables(dataclasses.replace(cfg, n_chiplets=1))
        g, r = t.src_map.shape
        if g > g_pad or r > r_pad:
            raise ValueError(f"pad_to {pad_to} smaller than topology "
                             f"{i} tables {(g, r)}")
        src_map[i, :g, :r] = t.src_map
        dst_map[i, :g, :r] = t.dst_map
        src_hops[i, :g] = t.src_hops
        dst_hops[i, :g] = t.dst_hops
        gw_loss_db[i, :g] = t.gw_loss_db
        gw_mask[i, :g] = 1.0
        router_mask[i, :r] = 1.0
        n_gw[i], n_rt[i] = g, r
    return PaddedSelectionTables(
        src_map=src_map, dst_map=dst_map, src_hops=src_hops,
        dst_hops=dst_hops, gw_loss_db=gw_loss_db, gw_mask=gw_mask,
        router_mask=router_mask, n_gateways=n_gw, n_routers=n_rt)


def padded_selection_tables_torch(cfgs, pad_to=None, device=None) -> dict:
    """Memoized device-resident view of the padded tables (the twin of the
    reference's `padded_selection_tables_jax`): the same dict of tensors
    for equal (cfgs, pad_to, device). `device=None` means the card."""
    cfgs = tuple(cfgs)
    return _padded_tables_torch_cached(
        cfgs, tuple(_pad_shape(cfgs) if pad_to is None else pad_to),
        str(resolve_device(device)))


# Misses of `_padded_tables_torch_cached` (`simulator.engine_stats()`'s
# "padded_table_builds"; `reset_engine_stats()` zeroes it).
TABLE_STATS = {"padded_table_builds": 0}


@functools.lru_cache(maxsize=None)
def _padded_tables_torch_cached(cfgs, pad_to, device: str) -> dict:
    TABLE_STATS["padded_table_builds"] += 1
    return _build_selection_tables_padded_cached(cfgs, pad_to) \
        .as_torch(device)


def clear_padded_table_caches() -> None:
    """Drop the memoized padded tables, their device views and the padded
    entry points' topology plans that hold them (so the next padded sweep
    builds its tables anew, as a first call does)."""
    from repro_torch.core.simulator import clear_topology_plans

    _build_selection_tables_padded_cached.cache_clear()
    _padded_tables_torch_cached.cache_clear()
    clear_topology_plans()
