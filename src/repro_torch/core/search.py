"""Gateway-placement search on the device (port of `repro.core.search`).

The annealed search of `simulator.search_placement` with every generation
built and scored where the data lives, and no host synchronization between
generations:

  * proposals: collision-free single-gateway moves around the incumbent
    and random restarts (Gumbel-top-k over the allowed routers), from
    draws made up front with the threefry twin in the reference's order
    and shapes, so the proposals are the reference device engine's bit for
    bit; each spread-ordered by `gateway_controller.activation_order_torch`;
  * their two table columns (`selection.placement_tables_torch`);
  * scoring: every chain's candidates as the lanes of one interval loop
    (`simulator.score_placement_tables`: one `epoch_step` launch on the
    card for RESIPI / RESIPI_ALL);
  * elitism and annealed acceptance with `torch.where`.

A Python loop over generations on device tensors takes the place of the
reference's `lax.scan`; the only device-to-host copy is the result's, once
per search. `search_placement_device` runs one chain,
`search_placement_islands` K chains (keys `fold_in(prng_key(seed), k)`) as
K x population lanes of each generation's one launch, with runtime
`SWEEPABLE_FIELDS` grids of length K zipped with the islands.

The scores agree with the reference's at 1e-6, not bit for bit (the port
scores through `epoch_step` and its plain loop, the reference through its
scan body), so a decision on a near-tie could part the trajectories; on
the seeds the tests and `chip_smoke.py` run they do not.

`repair_placement` (host-side numpy) moves an incumbent off failed routers
before a warm restart.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import backend
from repro_torch import random as trandom
from repro_torch.core import simulator as S
from repro_torch.core import topology
from repro_torch.core.gateway_controller import activation_order_torch
from repro_torch.core.selection import (normalize_placement,
                                        placement_tables_torch,
                                        resolve_gateway_positions)

# One history record per generation, packed as one [len(HISTORY_KEYS)]
# vector.
HISTORY_KEYS = ("generation", "parent_score", "best_candidate_score",
                "best_score", "accepted", "latency", "power_mw", "energy")


def _mesh_coords(cfg, device) -> torch.Tensor:
    """[R, 2] router coordinates (int64), flat index x*mesh_y + y: the
    row order `placement_tables_torch` builds against."""
    return topology.lut_tensors(cfg, device)["coords"]


# ---------------------------------------------------------------------------
# Proposals
# ---------------------------------------------------------------------------

def _one_move(pos: torch.Tensor, i: torch.Tensor, gumbel: torch.Tensor,
              coords: torch.Tensor, blocked: torch.Tensor) -> torch.Tensor:
    """Collision-free single-gateway moves of N placements [N, G, 2]:
    gateway i[n] goes to the router with the largest `gumbel[n]` [R]
    among the unoccupied ones (the mover's own slot counts as occupied, so
    a move never stays in place; `blocked` [R] bool routers count as
    permanently occupied). No free router: no move. `coords` [R, 2] and
    `blocked` [R] are shared, or [N, R, 2] and [N, R] one mesh per
    placement (the co-design's topology points)."""
    coords = coords.expand(pos.shape[0], -1, -1)
    occupied = torch.any(torch.all(coords[:, :, None, :]
                                   == pos[:, None, :, :], dim=-1), dim=-1)
    occupied = occupied | blocked
    j = torch.argmax(torch.where(occupied, float("-inf"), gumbel), dim=-1)
    movable = torch.any(~occupied, dim=-1)
    mover = torch.arange(pos.shape[1], device=pos.device)[None, :] \
        == i[:, None]
    to = torch.gather(coords, 1, j[:, None, None].expand(-1, 1, 2))
    return torch.where((movable[:, None] & mover)[..., None], to, pos)


def _propose(parent: torch.Tensor, restart: torch.Tensor,
             restart_pos: torch.Tensor, move_i: torch.Tensor,
             move_gumbel: torch.Tensor, moves: int, coords: torch.Tensor,
             blocked: torch.Tensor, cfg) -> torch.Tensor:
    """N candidates: a random restart (`restart` [N] bool, `restart_pos`
    [N, G, 2]) or `moves` (1 or 2) collision-free moves of `parent`
    [N, G, 2] (`move_i` [N, 2], `move_gumbel` [N, 2, R]), each re-rowed by
    the controller's activation rule."""
    pos = _one_move(parent, move_i[:, 0], move_gumbel[:, 0], coords, blocked)
    if moves > 1:
        pos = _one_move(pos, move_i[:, 1], move_gumbel[:, 1], coords,
                        blocked)
    pos = torch.where(restart[:, None, None], restart_pos, pos)
    order = activation_order_torch(pos, cfg)
    return torch.gather(pos, 1, order[..., None].expand_as(pos))


# ---------------------------------------------------------------------------
# The generation loop
# ---------------------------------------------------------------------------

def _draws(keys: torch.Tensor, generations: int, n_prop: int, coords,
           blocked, g_max: int, restart_frac: float) -> dict:
    """Every draw of K chains ([K, 2] keys) up front, from `split(key, 5)`
    in the reference's order and shapes (leading [K])."""
    n_r = int(coords.shape[0])
    k = trandom.split(keys, 5)
    restart = trandom.bernoulli(k[:, 0], restart_frac,
                                (generations, n_prop))
    # Restart placements: Gumbel-top-k, a uniform sample of g_max routers
    # without replacement over the allowed ones.
    rest_gum = torch.where(blocked, float("-inf"), trandom.gumbel(
        k[:, 1], (generations, n_prop, n_r)))
    _, rest_idx = trandom.top_k(rest_gum, g_max)
    return {"restart": restart,
            "restart_pos": coords[rest_idx],       # [K, T, n_prop, G, 2]
            "move_i": trandom.randint(k[:, 2], (generations, n_prop, 2), 0,
                                      g_max).long(),
            "move_gumbel": trandom.gumbel(k[:, 3],
                                          (generations, n_prop, 2, n_r)),
            "acc_u": trandom.uniform(k[:, 4], (generations,))}


def _temperatures(temperature: float, cooling: float,
                  generations: int) -> np.ndarray:
    """temperature * cooling ** gen per generation in float32, with XLA's
    CPU pow (the C library's powf) and denormals flushed, as the
    reference's scan body computes it."""
    out = np.zeros((generations,), np.float32)
    for g in range(generations):
        t = np.float32(temperature) * np.float32(
            trandom.xla_powf(cooling, g))
        out[g] = 0.0 if abs(t) < np.finfo(np.float32).tiny else t
    return out


def _search_core(draws: dict, temps: torch.Tensor, init_pos: torch.Tensor,
                 default_pos: torch.Tensor, blocked: torch.Tensor,
                 scoring: "S.PlacementScoring", *, cfg, generations: int,
                 population: int, objective: str,
                 inject_default: bool) -> torch.Tensor:
    """The generation loop of K annealed chains on the device, from their
    draws (`_draws`) and temperatures [T]: it copies nothing to or from
    the host (every input is on the device before it starts). Lanes of a
    generation are chain-major: lane k*P + p is candidate p (0: the
    incumbent) of chain k. Returns the packed result [K, ...] float32
    (`_unpack`)."""
    dev = init_pos.device
    coords = _mesh_coords(cfg, dev)
    g_max = cfg.max_gateways_per_chiplet
    n_k, n_prop = int(draws["acc_u"].shape[0]), population - 1
    moves_hi = max(1, generations // 3)
    lat_i, pow_i, en_i = (S.SUMMARY_KEYS.index(k) for k in (
        "mean_latency", "mean_power_mw", "mean_energy"))
    f32 = dict(dtype=torch.float32, device=dev)

    parent = init_pos[None].expand(n_k, g_max, 2)
    best_pos = parent
    best_score = torch.full((n_k,), float("inf"), **f32)
    best_summary = torch.zeros((n_k, len(S.SUMMARY_KEYS)), **f32)
    default_score = torch.zeros((n_k,), **f32)
    history = []
    for gen in range(generations):
        # Host schedule: 2 moves for the first max(1, generations // 3)
        # generations (coarse), 1 afterwards (fine).
        moves = 2 if gen < moves_hi else 1
        props = _propose(
            parent[:, None].expand(n_k, n_prop, g_max, 2)
            .reshape(-1, g_max, 2),
            draws["restart"][:, gen].reshape(-1),
            draws["restart_pos"][:, gen].reshape(-1, g_max, 2),
            draws["move_i"][:, gen].reshape(-1, 2),
            draws["move_gumbel"][:, gen].reshape(n_k * n_prop, 2, -1),
            moves, coords, blocked, cfg).reshape(n_k, n_prop, g_max, 2)
        cands = torch.cat([parent[:, None], props], dim=1)   # [K, P, G, 2]
        if inject_default and gen == 0:
            # Generation 0 scores the default scheme when the search
            # starts elsewhere.
            cands[:, 1] = default_pos
        tables = placement_tables_torch(cands.reshape(-1, g_max, 2), cfg)
        scores, summaries = S.score_placement_tables(
            scoring, tables["src_hops"], tables["gw_loss_db"], objective)
        scores = scores.reshape(n_k, population)
        summaries = summaries.reshape(n_k, population, -1)
        if gen == 0:
            default_score = scores[:, 1 if inject_default else 0]

        # Elitist best over everything ever scored.
        ibest = torch.argmin(scores, dim=1)
        sbest = torch.gather(scores, 1, ibest[:, None])[:, 0]
        cbest = torch.gather(cands, 1, ibest[:, None, None, None].expand(
            n_k, 1, g_max, 2))[:, 0]
        sumbest = torch.gather(summaries, 1, ibest[:, None, None].expand(
            n_k, 1, summaries.shape[-1]))[:, 0]
        improved = sbest < best_score
        best_score = torch.where(improved, sbest, best_score)
        best_pos = torch.where(improved[:, None, None], cbest, best_pos)
        best_summary = torch.where(improved[:, None], sumbest, best_summary)

        # Annealed incumbent move: greedy downhill, probabilistic uphill.
        s0 = scores[:, 0]
        delta = sbest - s0
        rel = delta / torch.clamp_min(torch.abs(s0), 1e-12)
        temp = temps[gen]
        metropolis = (temp > 0) & (draws["acc_u"][:, gen] < trandom.xla_exp(
            -rel / torch.clamp_min(temp, 1e-30)))
        accepted = (delta < 0) | metropolis
        parent = torch.where(accepted[:, None, None], cbest, parent)
        history.append(torch.stack([
            torch.full((n_k,), float(gen), **f32), s0, sbest, best_score,
            accepted.to(torch.float32), sumbest[:, lat_i], sumbest[:, pow_i],
            sumbest[:, en_i]], dim=1))
    return torch.cat([best_pos.reshape(n_k, -1).to(torch.float32),
                      parent.reshape(n_k, -1).to(torch.float32),
                      best_score[:, None], default_score[:, None],
                      best_summary,
                      torch.stack(history, dim=1).reshape(n_k, -1)], dim=1)


def _unpack(packed: np.ndarray, g_max: int, generations: int) -> dict:
    """The host copy of `_search_core`'s result, split into its parts."""
    n_s = len(S.SUMMARY_KEYS)
    cuts = np.cumsum([2 * g_max, 2 * g_max, 1, 1, n_s])
    pos, inc, best, dflt, summ, hist = np.split(packed, cuts, axis=1)
    return {"best_placement": pos.reshape(-1, g_max, 2).astype(np.int64),
            "incumbent_placement": inc.reshape(-1, g_max, 2)
            .astype(np.int64),
            "best_score": best[:, 0], "default_score": dflt[:, 0],
            "best_summary": summ,
            "history": hist.reshape(-1, generations, len(HISTORY_KEYS))}


def clear_search_caches() -> None:
    """Drop the search's memoized device tables (the gather tables of
    every layout searched), so the next search copies them to the device
    anew, as a first search does."""
    topology._lut_tensors.cache_clear()


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _check_search_params(generations: int, population: int,
                         objective: str) -> None:
    if population < 2:
        raise ValueError("population must be >= 2 (incumbent + candidates)")
    if generations < 1:
        raise ValueError("generations must be >= 1")
    S.check_placement_objective(objective)


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


def _blocked_mask(blocked_positions, cfg, device) -> torch.Tensor:
    """[R] bool mask in `_mesh_coords` row order (True = excluded)."""
    idx_lut = topology.router_index_lut(cfg)
    bx, by = idx_lut.shape
    mask = np.zeros(cfg.routers_per_chiplet, bool)
    for (x, y) in (blocked_positions or ()):
        x, y = int(x), int(y)
        r = int(idx_lut[x, y]) if (0 <= x < bx and 0 <= y < by) else -1
        if r < 0:
            raise ValueError(f"blocked position ({x}, {y}) is outside the "
                             f"{bx}x{by} mesh")
        mask[r] = True
    return torch.as_tensor(mask, device=device)


def _prepare_search(sim, init, blocked_positions, device) -> tuple:
    """Default and initial placements, whether generation 0 injects the
    default, and the blocked mask. The whole blocked set rides as an [R]
    mask. The scored default is repaired off blocked routers; an `init` on
    a blocked router raises."""
    cfg = sim.cfg
    blocked = {(int(x), int(y)) for (x, y) in (blocked_positions or ())}
    g_max = cfg.max_gateways_per_chiplet
    if cfg.routers_per_chiplet - len(blocked) < g_max:
        raise ValueError(
            f"{len(blocked)} blocked routers leave fewer than "
            f"{g_max} allowed positions on the "
            f"{cfg.mesh_x}x{cfg.mesh_y} mesh")
    default_p = normalize_placement(resolve_gateway_positions(cfg), cfg)
    if set(default_p) & blocked:
        default_p = repair_placement(default_p, blocked, cfg)
    parent_p = default_p if init is None else normalize_placement(init, cfg)
    if set(parent_p) & blocked:
        raise ValueError(
            f"init placement occupies blocked routers "
            f"{sorted(set(parent_p) & blocked)} — repair it first "
            f"(search.repair_placement)")
    if len(parent_p) != g_max:
        raise ValueError(
            f"init places {len(parent_p)} gateways but "
            f"max_gateways_per_chiplet={g_max}")
    return (default_p, parent_p, parent_p != default_p,
            _blocked_mask(blocked, cfg, device))


def _hyper(temperature, cooling, restart_frac) -> dict:
    return {"temperature": float(np.float32(temperature)),
            "cooling": float(np.float32(cooling)),
            "restart_frac": float(np.float32(restart_frac))}


def _history_list(hist: np.ndarray) -> list:
    """[T, len(HISTORY_KEYS)] record matrix -> host-engine list of dicts."""
    out = []
    for row in np.asarray(hist):
        rec = dict(zip(HISTORY_KEYS, (float(v) for v in row)))
        rec["generation"] = int(rec["generation"])
        rec["accepted"] = rec["accepted"] > 0.5
        out.append(rec)
    return out


def _as_placement(pos) -> tuple:
    return tuple((int(x), int(y)) for x, y in np.asarray(pos))


def _run(trace, sim, keys: torch.Tensor, prepared: tuple, overrides, *,
         objective, generations, population, temperature, cooling,
         restart_frac, chains: int = None) -> dict:
    """Shared body of the two entry points, after validation: set-up
    (every table and input on the keys' device before the first
    generation), the chains, and the one device-to-host copy. `keys` are
    the chains' [K, 2] keys, `prepared` what `_prepare_search` returns,
    `overrides` the [K] knob grids; `chains` the whole search's chain
    count, default K (when K is fewer, one block of a sharded search, each
    generation launches the whole search's `epoch_step` design:
    `simulator._pin_design`). The caller counts the search's
    `search_dispatches`."""
    default_p, parent_p, inject_default, blocked = prepared
    dev, n_k, cfg = keys.device, int(keys.shape[0]), sim.cfg
    lanes = {f: torch.as_tensor(v, device=dev).repeat_interleave(population)
             for f, v in (overrides or {}).items()}
    scoring = S.placement_scoring(trace, sim, n_k * population, device=dev,
                                  overrides=lanes)
    S._pin_design(sim, scoring.xs, scoring.kwargs,
                  (chains or n_k) * population, topo=scoring.topo)
    hyper = _hyper(temperature, cooling, restart_frac)
    draws = _draws(keys, generations, population - 1, _mesh_coords(cfg, dev),
                   blocked, cfg.max_gateways_per_chiplet,
                   hyper["restart_frac"])
    temps = torch.as_tensor(_temperatures(
        hyper["temperature"], hyper["cooling"], generations), device=dev)
    packed = _search_core(
        draws, temps, torch.as_tensor(parent_p, device=dev),
        torch.as_tensor(default_p, device=dev), blocked, scoring, cfg=cfg,
        generations=generations, population=population, objective=objective,
        inject_default=inject_default)
    return _unpack(packed.cpu().numpy(),                 # the one copy
                   cfg.max_gateways_per_chiplet, generations)


def search_placement_device(trace: dict, sim, *,
                            objective: str = "inter_latency",
                            generations: int = 10, population: int = 12,
                            seed: int = 0, init=None,
                            temperature: float = 0.05, cooling: float = 0.7,
                            restart_frac: float = 0.25,
                            blocked_positions=None, device=None) -> dict:
    """The annealed placement search on the device, one chain (the
    reference's `search_placement_device`; `simulator.search_placement`
    wraps it): `generations` `epoch_step` launches on the card, one
    device-to-host copy, one `search_dispatches`. Same return structure
    as the host engine, plus the final incumbent. Runs on the card unless
    `device="cpu"`."""
    _check_search_params(generations, population, objective)
    dev = backend.resolve_device(device)
    prepared = _prepare_search(sim, init, blocked_positions, dev)
    default_p = prepared[0]
    host = _run(trace, sim, trandom.prng_key(seed, device=dev)[None],
                prepared, None, objective=objective, generations=generations,
                population=population, temperature=temperature,
                cooling=cooling, restart_frac=restart_frac)
    # Counted once the last generation is launched: a search that raised
    # never counts.
    S._STATS["search_dispatches"] += 1
    best_s = float(host["best_score"][0])
    default_s = float(host["default_score"][0])
    return {"best_placement": _as_placement(host["best_placement"][0]),
            "best_score": best_s,
            "best_summary": dict(zip(S.SUMMARY_KEYS,
                                     map(float, host["best_summary"][0]))),
            "default_placement": default_p, "default_score": default_s,
            "improvement_frac": 1.0 - best_s / max(default_s, 1e-12),
            "incumbent_placement": _as_placement(
                host["incumbent_placement"][0]),
            "objective": objective, "generations": generations,
            "population": population, "engine": "device",
            "history": _history_list(host["history"][0])}


def search_placement_islands(trace: dict, sim, *, islands: int = None,
                             objective: str = "inter_latency",
                             generations: int = 10, population: int = 12,
                             seed: int = 0, init=None,
                             temperature: float = 0.05,
                             cooling: float = 0.7,
                             restart_frac: float = 0.25,
                             devices=None, blocked_positions=None,
                             device=None, **grids) -> dict:
    """K independent annealed chains, each from its own key
    (`fold_in(prng_key(seed), k)`), as K x population lanes of each
    generation's one launch. Runtime `SWEEPABLE_FIELDS` grids of length K
    zip with the island axis::

        search_placement_islands(tr, sim, islands=4,
                                 l_m=[0.008, 0.012, 0.02, 0.03])

    searches the best placement per L_m operating point. Returns the
    overall winner plus per-island bests, incumbents, defaults and
    histories (`island_*` arrays and a `history` dict of [K, T] arrays,
    leading [K] axis), all from one device-to-host copy.

    `devices` with more than one entry (this process's; entries may
    repeat), or one per process after `distributed.init_distributed`,
    shards the islands: K padded by repeating the last island's key and
    knobs, each block's chains on its device with the whole search's
    `epoch_step` design, the blocks gathered on every process; the result
    equals the one-device search's and carries a `"sharding"`
    description. One entry names the device to run on."""
    _check_search_params(generations, population, objective)
    unknown = set(grids) - set(S.SWEEPABLE_FIELDS)
    if unknown:
        raise ValueError(
            f"non-sweepable fields: {sorted(unknown)} (islands zip with "
            f"runtime fields: {S.SWEEPABLE_FIELDS})")
    if islands is not None and (isinstance(islands, bool)
                                or not isinstance(islands,
                                                  (int, np.integer))):
        raise ValueError(
            f"islands must be an int, got {type(islands).__name__} "
            f"{islands!r}")
    lengths = {f: S._topo_grid_len(f, v) for f, v in grids.items()}
    if islands is None:
        if lengths:
            if len(set(lengths.values())) != 1:
                raise ValueError(f"swept fields must share one length, "
                                 f"got {lengths}")
            islands = next(iter(lengths.values()))
        else:
            islands = 8
    bad = {f: n for f, n in lengths.items() if n != islands}
    if bad:
        raise ValueError(
            f"island grids must have length islands={islands}, got {bad} "
            f"— every runtime grid zips element-wise with the island axis")
    if islands < 1:
        raise ValueError("islands must be >= 1")

    gs, sharded = S._grid_sharding(islands, devices, device, "islands")
    dev = gs.devices[0]
    prepared = _prepare_search(sim, init, blocked_positions, dev)
    default_p = prepared[0]
    keys = trandom.fold_in(trandom.prng_key(seed, device=dev),
                           torch.arange(islands, device=dev))
    overrides = {f: S._runtime_grid(f, v) for f, v in grids.items()}
    blocks = []
    for (bdev, idx), (_, (keys_b, over_b)) in zip(
            gs.local_blocks(), gs.shard((keys, overrides))):
        blocks.append(_run(
            trace, sim, keys_b,
            prepared if bdev == dev
            else _prepare_search(sim, init, blocked_positions, bdev),
            over_b, chains=islands, objective=objective,
            generations=generations, population=population,
            temperature=temperature, cooling=cooling,
            restart_frac=restart_frac))
    host = gs.gather(blocks)
    # Counted once the last generation is launched: a search that raised
    # never counts.
    S._STATS["search_dispatches"] += 1
    scores = host["best_score"]
    k_best = int(np.argmin(scores))
    defaults = host["default_score"]
    best_s = float(scores[k_best])
    default_best = float(defaults[k_best])
    hist = host["history"]                     # [K, T, len(HISTORY_KEYS)]
    return {
        "best_placement": _as_placement(host["best_placement"][k_best]),
        "best_score": best_s,
        "best_island": k_best,
        "best_summary": dict(zip(
            S.SUMMARY_KEYS, map(float, host["best_summary"][k_best]))),
        "default_placement": default_p,
        "default_score": default_best,
        "improvement_frac": 1.0 - best_s / max(default_best, 1e-12),
        "island_best_placements": [
            _as_placement(p) for p in host["best_placement"]],
        "island_incumbents": [
            _as_placement(p) for p in host["incumbent_placement"]],
        "island_best_scores": scores,
        "island_default_scores": defaults,
        "island_overrides": {f: np.asarray(v) for f, v in grids.items()},
        "history": {k: hist[..., i] for i, k in enumerate(HISTORY_KEYS)},
        "objective": objective, "generations": generations,
        "population": population, "islands": islands, "engine": "device",
    } | ({"sharding": gs.describe()} if sharded else {})
