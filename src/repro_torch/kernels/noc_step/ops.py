"""Topology construction, arrivals, and the wrapper of the flit-level kernel.

`simulate_residency(ext_load, g_active, wavelengths)` gives the Fig. 13
per-router residency map of one chiplet under a gateway activation (ReSiPI
g = 2..4 at W = 4, PROWAVES g = 1 at W = 16, port-limited drain). It builds
the routing topology from the selection tables (`build_topology`), draws
Bernoulli packet arrivals with the threefry twin (`repro_torch.random`, so
the port's arrivals equal the reference's at the same seed), and runs
`noc_run`. Given CUDA tensors `noc_run` launches `csrc/noc_step.cu` once for
all B runs of a batch; given CPU tensors it runs the plain version
(`ref.reference_noc_run`). There is no fallback. The kernel that runs is
"node" (one block per run, one node per thread over the run's active
prefix, up to MAX_NODES = 1024 nodes); `run_prepared(p, kernel="warp")`
runs the first design, one warp per run (up to WARP_MAX_NODES = 128), on
the same inputs. Each launch counts under `noc_step` and under
`noc_step:<kernel>` (`backend.COUNTERS["variants"]`).

`build_topology_padded` and the dead-lane `valid_mask` are the contract for
batching many topologies through one kernel shape: B runs of mixed mesh
radix and gateway count share one launch.

Port of `repro.kernels.noc_step.ops` and `kernel.noc_run_pallas`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch import random as trandom
from repro_torch.core import topology
from repro_torch.core.constants import NETWORK, NetworkConfig
from repro_torch.core.selection import (build_selection_tables,
                                        resolve_gateway_positions)
from repro_torch.kernels.noc_step.ref import reference_noc_run

NAME = "noc_step"
SOURCE = Path(__file__).resolve().parent / "csrc" / "noc_step.cu"
MAX_NODES = 1024              # the node kernel: kMaxNodeNodes in the source
WARP_MAX_NODES = 128          # the warp kernel: kMaxNodes in the source
KERNELS = {"node": 0, "warp": 1}
# kMaxInDegree in the source: a node receives from at most one neighbor per
# adjacency direction (6 on hex layouts, 4 on meshes; a sink from 1).
MAX_IN_DEGREE = max(len(v) for v in topology.NEIGHBOR_OFFSETS.values())
ARRIVAL_GROUP = 64            # runs drawn together by residency_arrivals

# Deterministic next-hop preference order for explicit-coords layouts: the
# four grid steps first (x before y, matching XY routing's dimension order),
# then the two hex anti-diagonal steps. On a derived mesh the hop-greedy
# walk under this order reproduces XY routing exactly.
_NEXT_HOP_PREFERENCE = ((1, 0), (-1, 0), (0, 1), (0, -1), (1, -1), (-1, 1))

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_F32 = torch.float32


def build_topology(g_active: int, wavelengths: int,
                   cfg: NetworkConfig = NETWORK
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(next_mat [R+g, R+g], drain [R+g], buf [R+g], gw_router_idx [g]).

    Mesh routers 0..R-1 route flits via XY toward their assigned gateway
    (Fig. 8 balanced partition); a gateway sink node is appended per active
    gateway. Sink drain = min(optical serialization, electronic port) rate.
    Placement-aware: `cfg.gateway_positions` (or the default edge scheme)
    decides both the balanced partition and where the sinks sit.
    Explicit-coords layouts route hop-greedily over the coord_model
    adjacency (first `_NEXT_HOP_PREFERENCE` neighbor that strictly reduces
    the BFS hop distance).
    """
    tables = build_selection_tables(cfg)
    assign = tables.src_map[g_active - 1]            # [R] -> gateway id
    routers = topology.router_coords(cfg)
    gw_pos = resolve_gateway_positions(cfg)[:g_active]
    r = len(routers)
    n = r + g_active
    next_mat = np.zeros((n, n), np.float32)

    def rid(x, y):
        return x * cfg.mesh_y + y

    if cfg.coords is None:
        for i, (x, y) in enumerate(routers):
            gx, gy = gw_pos[assign[i]]
            if x == gx and y == gy:
                next_mat[i, r + assign[i]] = 1.0     # eject into gateway
            elif x != gx:                             # XY: x first
                next_mat[i, rid(x + np.sign(gx - x), y)] = 1.0
            else:
                next_mat[i, rid(x, y + np.sign(gy - y))] = 1.0
    else:
        idx_lut = topology.router_index_lut(cfg)
        hm = topology.hop_matrix(cfg)
        xmax, ymax = idx_lut.shape
        gw_rid = idx_lut[gw_pos[:, 0], gw_pos[:, 1]]
        offsets = [o for o in _NEXT_HOP_PREFERENCE
                   if o in topology.NEIGHBOR_OFFSETS[cfg.coord_model]]
        for i, (x, y) in enumerate(routers):
            tgt = int(gw_rid[assign[i]])
            if i == tgt:
                next_mat[i, r + assign[i]] = 1.0     # eject into gateway
                continue
            for dx, dy in offsets:
                nx, ny = x + dx, y + dy
                if not (0 <= nx < xmax and 0 <= ny < ymax):
                    continue
                j = int(idx_lut[nx, ny])
                if j >= 0 and hm[j, tgt] < hm[i, tgt]:
                    next_mat[i, j] = 1.0
                    break
            else:                 # pragma: no cover - hop_matrix is exact
                raise AssertionError("no hop-reducing neighbor found")

    # Gateway sink service: optical lanes vs the 1-flit/cycle electronic
    # port — the min is what the chiplet actually sustains (§3.1 insight).
    optical = wavelengths * cfg.link_gbps_per_wavelength / (
        cfg.flit_bits * cfg.noc_freq_ghz)
    drain = np.zeros((n,), np.float32)
    drain[r:] = min(optical, 1.0)
    buf = np.full((n,), float(cfg.router_buffer_flits), np.float32)
    buf[r:] = float(cfg.gateway_buffer_flits)
    if cfg.coords is None:
        gw_idx = np.array([rid(*gw_pos[k]) for k in range(g_active)])
    else:
        gw_idx = np.array([int(topology.router_index_lut(cfg)[x, y])
                           for x, y in gw_pos[:g_active]])
    return next_mat, drain, buf, gw_idx


def build_topology_padded(g_active: int, wavelengths: int,
                          cfg: NetworkConfig = NETWORK, *, pad_to: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]:
    """`build_topology` padded to `pad_to` nodes with a lane-validity mask.

    Padded node lanes get zero routing rows/columns, zero drain/buffers and
    a zero validity mask — with `noc_run(..., valid_mask=mask)` they are
    dead lanes, so one kernel shape serves every (mesh, g) topology in a
    batch. Returns (next_mat [P, P], drain [P], buf [P], valid_mask [P]).
    """
    next_mat, drain, buf, _ = build_topology(g_active, wavelengths, cfg)
    n = next_mat.shape[0]
    if pad_to < n:
        raise ValueError(f"pad_to {pad_to} < topology nodes {n}")
    p = pad_to - n
    next_mat = np.pad(next_mat, ((0, p), (0, p)))
    drain = np.pad(drain, (0, p))
    buf = np.pad(buf, (0, p))
    mask = np.zeros((pad_to,), np.float32)
    mask[:n] = 1.0
    return next_mat, drain, buf, mask


def build() -> ctypes.CDLL:
    """Build (or load the cached build of) the kernel library."""
    lib = backend.build_library(NAME, SOURCE)
    fn = lib.noc_step_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 12 + [_I] * 5 + [_F, _P]
        fn.restype = _I
    return lib


def _routing_read(x: torch.Tensor):
    """The one element of `x` on the host (counted as a host read)."""
    if x.is_cuda:
        backend.count_host_read("noc_step.routing", x.nbytes)
    return x.item()


def routing(next_mat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's view of a one-hot routing matrix [B, R, R].

    Returns next_hop [B, R] int32 (the destination of each source, -1 for
    sinks and dead rows) and in_src [B, R, MAX_IN_DEGREE] int32 (each
    destination's sources in ascending order, padded with -1). Raises on a
    matrix that is not one-hot (entries 0/1, at most one 1 per row) or whose
    in-degree exceeds MAX_IN_DEGREE.
    """
    nmat = next_mat.to(_F32)
    r = nmat.shape[-1]
    binary = bool(_routing_read(((nmat == 0.0) | (nmat == 1.0)).all()))
    if not binary or bool(_routing_read((nmat.sum(dim=-1) > 1.0).any())):
        raise ValueError("noc_step kernel needs a one-hot next_mat (0/1 "
                         "entries, at most one 1 per row); the plain "
                         "version takes any matrix")
    in_degree = int(_routing_read(nmat.sum(dim=-2).max())) \
        if nmat.numel() else 0
    if in_degree > MAX_IN_DEGREE:
        raise ValueError(f"noc_step kernel supports in-degree up to "
                         f"{MAX_IN_DEGREE}, got {in_degree}")
    idx = torch.arange(r, dtype=torch.int32, device=nmat.device)
    hop = nmat > 0.0
    next_hop = torch.where(hop.any(dim=-1), torch.argmax(nmat, dim=-1)
                           .to(torch.int32), -1)
    # Sources of each destination first, in ascending order, then r.
    key = torch.where(hop.transpose(-1, -2), idx, r)
    k = min(MAX_IN_DEGREE, r)
    srcs = torch.sort(key, dim=-1).values[..., :k]
    in_src = torch.full((*srcs.shape[:-1], MAX_IN_DEGREE), -1,
                        dtype=torch.int32, device=nmat.device)
    in_src[..., :k] = torch.where(srcs < r, srcs, -1)
    return next_hop.contiguous(), in_src.contiguous()


def active_prefix(mask: torch.Tensor, next_hop: torch.Tensor,
                  in_src: torch.Tensor) -> torch.Tensor:
    """R_active per run [B] int32: one past the highest node that is live
    in the static mask [B, R] or routed (a next hop [B, R] or an in-edge
    [B, R, k] of its own; every node routed into has one), 0 for a run
    with none. The "node" kernel simulates that prefix only: a node past
    it holds no flits, receives none and sinks none, so it ends at exactly
    0 (the dead-lane contract). Torch ops on the routing's device; no host
    synchronisation."""
    r = mask.shape[-1]
    live = (mask != 0) | (next_hop >= 0) | (in_src >= 0).any(dim=-1)
    pos = torch.arange(1, r + 1, dtype=torch.int32, device=mask.device)
    return torch.where(live, pos, 0).amax(dim=-1).to(torch.int32)


def noc_run(arrivals: torch.Tensor, next_mat: torch.Tensor,
            drain_rate: torch.Tensor, buf_cap: torch.Tensor, *,
            valid_mask: Optional[torch.Tensor] = None,
            valid_mask_t: Optional[torch.Tensor] = None,
            t_mask: Optional[torch.Tensor] = None,
            link_rate: float = 1.0):
    """Run T cycles of the flit model for one run or a batch of B runs.

    Arguments as `ref.reference_noc_run` ([B?, T, R] arrivals, [B?, R, R]
    next_mat, [B?, R] drain/buffers/validity, [B?, T, R] valid_mask_t,
    [B?, T] t_mask; arrays without the batch axis are shared by all runs).
    On CUDA tensors the kernel runs all B runs in one launch (next_mat must
    be one-hot, R <= MAX_NODES, every T accepted); on CPU tensors the plain
    version runs. Returns (residency, final_occupancy, drained), [B?, R].
    """
    with backend.span("noc_run", backend.LAYER_ENTRY):
        if arrivals.device.type == "cpu":
            with backend.span(NAME, backend.LAYER_KERNELS):
                return reference_noc_run(
                    arrivals, next_mat, drain_rate, buf_cap,
                    valid_mask=valid_mask, valid_mask_t=valid_mask_t,
                    t_mask=t_mask, link_rate=link_rate)
        batched = arrivals.dim() == 3
        outs = run_prepared(prepare(
            arrivals if batched else arrivals[None], next_mat, drain_rate,
            buf_cap, valid_mask=valid_mask, valid_mask_t=valid_mask_t,
            t_mask=t_mask, link_rate=link_rate))
        return outs if batched else tuple(o[0] for o in outs)


def prepare(arrivals: torch.Tensor, next_mat: torch.Tensor,
            drain_rate: torch.Tensor, buf_cap: torch.Tensor, *,
            valid_mask: Optional[torch.Tensor] = None,
            valid_mask_t: Optional[torch.Tensor] = None,
            t_mask: Optional[torch.Tensor] = None,
            link_rate: float = 1.0) -> dict:
    """The kernel's inputs for CUDA tensors (arrivals [B, T, R], the rest
    as `noc_run`), checked and laid out: contiguous float32 [B, ...] arrays
    with the defaults materialized as the reference's wrapper does
    (all-ones masks), the static mask ANDed into `valid_mask_t`, the
    routing as next_hop / in_src, and each run's active prefix
    (`active_prefix`). The one-hot check reads next_mat back to the host;
    nothing else synchronizes."""
    with backend.span(NAME + ".prepare", backend.LAYER_KERNELS):
        dev = arrivals.device
        if dev.type != "cuda":
            raise RuntimeError(f"noc_step kernel needs CUDA tensors, got "
                               f"{dev}")
        if arrivals.dim() != 3:
            raise ValueError(f"noc_step: arrivals must be [B, T, R], got "
                             f"{tuple(arrivals.shape)}")
        b, t, r = arrivals.shape
        if r > MAX_NODES:
            raise ValueError(f"noc_step kernel supports up to {MAX_NODES} "
                             f"nodes, got {r}")
        for name, a in (("next_mat", next_mat), ("drain_rate", drain_rate),
                        ("buf_cap", buf_cap), ("valid_mask", valid_mask),
                        ("valid_mask_t", valid_mask_t), ("t_mask", t_mask)):
            if a is not None and a.device != dev:
                raise ValueError(f"noc_step: {name} is on {a.device}, "
                                 f"arrivals on {dev}")

        def per_run(a, shape, default=1.0):
            a = torch.full(shape[1:], default, dtype=_F32, device=dev) \
                if a is None else a.to(_F32)
            if tuple(a.shape) not in (shape, shape[1:]):
                raise ValueError(f"noc_step: expected {shape} or "
                                 f"{shape[1:]}, got {tuple(a.shape)}")
            return a.expand(shape).contiguous()

        mask = per_run(valid_mask, (b, r))
        next_hop, in_src = routing(per_run(next_mat, (b, r, r)))
        return {"arrivals": arrivals.to(_F32).contiguous(),
                "t_mask": per_run(t_mask, (b, t)), "mask": mask,
                # The static lane mask ANDs in here: the kernel sees one
                # combined per-cycle mask plane.
                "mask_t": None if valid_mask_t is None
                else per_run(valid_mask_t, (b, t, r)) * mask[:, None, :],
                "next_hop": next_hop, "in_src": in_src,
                "drain": per_run(drain_rate, (b, r)),
                "buf": per_run(buf_cap, (b, r)),
                "r_active": active_prefix(mask, next_hop, in_src),
                "link_rate": float(link_rate)}


def run_prepared(p: dict, kernel: Optional[str] = None):
    """One kernel launch on `prepare`'s output, on the current stream
    (never synchronizes); returns (residency, final_occupancy, drained)
    [B, R]. `kernel` is "node" (the default) or "warp" (the first design,
    which tests and timing run on the same inputs, up to WARP_MAX_NODES)."""
    with backend.span(NAME, backend.LAYER_KERNELS):
        kernel = "node" if kernel is None else kernel
        if kernel not in KERNELS:
            raise ValueError(f"noc_step: no {kernel!r} kernel (have "
                             f"{sorted(KERNELS)})")
        arrivals = p["arrivals"]
        b, t, r = arrivals.shape
        if kernel == "warp" and r > WARP_MAX_NODES:
            raise ValueError(f"noc_step: the warp kernel supports up to "
                             f"{WARP_MAX_NODES} nodes, got {r}")
        lib = build()
        out = [torch.empty((b, r), dtype=_F32, device=arrivals.device)
               for _ in range(3)]
        ptr = [None if p[k] is None else p[k].data_ptr() for k in
               ("arrivals", "t_mask", "mask", "mask_t", "next_hop", "in_src",
                "drain", "buf", "r_active")]
        err = lib.noc_step_launch(
            *ptr, *(o.data_ptr() for o in out), b, t, r, MAX_IN_DEGREE,
            KERNELS[kernel], p["link_rate"],
            torch.cuda.current_stream(arrivals.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"noc_step {kernel} kernel launch failed: "
                               f"CUDA error {err}")
        backend.count_launch(NAME, kernel)
        return tuple(out)


def residency_arrivals(keys: torch.Tensor, ext_load: Sequence[float],
                       routers: Sequence[int], cycles: int, pad_to: int, *,
                       packet_flits: int = NETWORK.packet_flits
                       ) -> torch.Tensor:
    """Bernoulli packet arrivals of B runs: [B, cycles, pad_to] float32.

    Run b draws `uniform(keys[b], (cycles, routers[b])) < ext_load[b] /
    routers[b]` — the reference's `simulate_residency` draw, compared in
    float32 as its weakly typed `uniform(...) < per_router` is — times
    `packet_flits` in its first `routers[b]` lanes, zero in its sink and
    dead lanes. Runs are drawn in groups of `ARRIVAL_GROUP` runs of one
    router count, so the int64 threefry temporaries stay bounded (about a GB
    for 64 runs of 8192 cycles x 64 routers).
    """
    b = keys.shape[0]
    out = torch.zeros((b, cycles, pad_to), dtype=_F32, device=keys.device)
    routers = np.asarray(routers, np.int64)
    thresh = torch.tensor(np.asarray(ext_load, np.float64) / routers,
                          dtype=_F32, device=keys.device)
    for r in np.unique(routers):
        runs = np.flatnonzero(routers == r)
        for lo in range(0, len(runs), ARRIVAL_GROUP):
            idx = torch.as_tensor(runs[lo:lo + ARRIVAL_GROUP],
                                  device=keys.device)
            u = trandom.uniform(keys[idx], (cycles, int(r)))
            out[idx, :, :r] = (u < thresh[idx, None, None]).to(_F32) \
                * packet_flits
    return out


def simulate_residency(ext_load: float, g_active: int, wavelengths: int,
                       cycles: int = 4096, seed: int = 0,
                       cfg: NetworkConfig = NETWORK,
                       active_cycles: Optional[int] = None, *, device=None):
    """Returns (mean residency per router [mesh_x, mesh_y], drained flits).

    ext_load: chiplet-level inter-chiplet packet rate (pkts/cycle); packets
    arrive as `packet_flits`-sized bursts Poisson-thinned over routers.
    active_cycles: run only the first `active_cycles` of the window (the
    rest are t_mask-frozen), so mixed-duration runs share one kernel shape.
    Explicit-coords layouts return the flat [R] residency in router order.
    Runs on the card unless `device` says otherwise.
    """
    dev = backend.resolve_device(device)
    r = cfg.routers_per_chiplet
    next_mat, drain, buf, _ = build_topology(g_active, wavelengths, cfg)
    n = next_mat.shape[0]
    if active_cycles is None:
        active_cycles = cycles
    if not 0 < active_cycles <= cycles:
        raise ValueError(f"active_cycles must be in (0, {cycles}], "
                         f"got {active_cycles}")
    key = trandom.prng_key(seed, device=dev)
    arrivals = residency_arrivals(key[None], [ext_load], [r], cycles, n,
                                  packet_flits=cfg.packet_flits)[0]
    t_mask = (torch.arange(cycles, device=dev) < active_cycles).to(_F32)
    resid, _, drained = noc_run(
        arrivals, torch.as_tensor(next_mat, device=dev),
        torch.as_tensor(drain, device=dev), torch.as_tensor(buf, device=dev),
        valid_mask=torch.ones(n, dtype=_F32, device=dev), t_mask=t_mask)
    mean_resid = (resid[:r] / active_cycles).cpu().numpy()
    total = float(torch.sum(drained))
    if cfg.coords is not None:
        return mean_resid, total
    return mean_resid.reshape(cfg.mesh_x, cfg.mesh_y), total
