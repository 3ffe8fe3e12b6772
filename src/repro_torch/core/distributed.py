"""Multi-process (fleet) execution of the DSE sweeps on `torch.distributed`
(port of `repro.core.distributed`).

One process per host, every process running the same program: this module
joins the processes into one `torch.distributed` group, describes a 1-D
"grid" mesh over every device of the fleet, and splits the leading grid
axis of a sweep into blocks, block i of the padded grid on device i, so
`shard_sweep`, `sweep_workload`, `search_placement_islands` and
`search_codesign` run their lanes over several devices and hosts. Three
rules keep it honest:

  * a single-host passthrough everywhere: with one process and one device
    every helper leaves its input as it is;
  * every process builds identical host-side grids (deterministic from the
    seed), so sharding is a pure placement decision: each process runs the
    blocks of its own devices, and `gather` collects every block on every
    process;
  * no silent padding: the grid is padded to a device-count multiple by
    repeating its last point, and the pad count is logged and reported in
    the sweep's summary (`GridSharding.describe`).

Devices may repeat (`["cpu"] * 4`, `["cuda:0"] * 4`): the blocks then run
one after another on one device, which is how one machine stands in for
several. Across processes, each rank holds the same number of devices and
the collectives run on the group's backend: "gloo" (host tensors; the card
copies to the host first) or "nccl".

The mesh is 1-D: one "grid" axis over every device of every process
(`fleet_devices`; `launch.mesh.make_fleet_mesh` describes it), which is
where the rules table (`sharding.rules`) resolves the DSE axes "sweep"
and "islands".
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("repro_torch.distributed")

# Environment contract between the fleet launcher and its workers
# (repro_torch.launch.fleet sets these before spawning each worker).
ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"

COLLECTIVES = ("gloo", "nccl")
# How long a collective waits for the other processes.
_TIMEOUT_S = 600.0

_STATE = {"initialized": False, "info": None}


def init_distributed(*, coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     collectives: str = "gloo") -> dict:
    """Join (or skip) the fleet: `torch.distributed.init_process_group`
    over `tcp://<coordinator>` from explicit arguments or the REPRO_*
    environment, a no-op for one process.

    `collectives` names the group's backend, "gloo" or "nccl"; it is never
    picked from what happens to be installed. Idempotent: a second call
    returns the first call's info.
    """
    if _STATE["initialized"]:
        return dict(_STATE["info"])
    if collectives not in COLLECTIVES:
        raise ValueError(f"collectives must be one of {COLLECTIVES}, got "
                         f"{collectives!r}")
    env = os.environ
    coordinator = coordinator or env.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = int(env.get(ENV_NUM_PROCESSES, "1"))
    if process_id is None:
        process_id = int(env.get(ENV_PROCESS_ID, "0"))
    if num_processes <= 1 or coordinator is None:
        info = {"distributed": False, "coordinator": None,
                "num_processes": 1, "process_id": 0, "collectives": None}
        _STATE.update(initialized=True, info=info)
        return dict(info)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of range for "
                         f"{num_processes} processes")
    dist.init_process_group(
        backend=collectives, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    info = {"distributed": True, "coordinator": coordinator,
            "num_processes": num_processes, "process_id": process_id,
            "collectives": collectives}
    _STATE.update(initialized=True, info=info)
    log.info("joined fleet: process %d/%d via %s (%s)", process_id,
             num_processes, coordinator, collectives)
    return dict(info)


def shutdown_distributed() -> None:
    """Leave the fleet (tests / clean worker exit); no-op if never
    joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(initialized=False, info=None)


def is_distributed() -> bool:
    """More than one process in this group?"""
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def process_count() -> int:
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


def partition_bounds(grid_points: int, num_shards: int, shard: int):
    """Contiguous [start, stop) of grid shard `shard` of `num_shards`.

    Exactly the block partition of the padded grid axis over the devices
    (pad rows land in the last block and are sliced off), so an
    emulated-host worker computing `grid[start:stop]` reproduces the rows
    a real fleet member owns. The shards are disjoint and cover the grid.
    """
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} out of range for {num_shards}")
    padded = grid_points + ((-grid_points) % num_shards)
    block = padded // num_shards
    start = min(shard * block, grid_points)
    stop = min(start + block, grid_points)
    return start, stop


def _local_devices(devices=None) -> list:
    """This process's devices: `devices`, or the card (which must be
    present)."""
    if devices is None:
        from repro_torch.backend import resolve_device
        return [resolve_device(None)]
    local = [torch.device(d) for d in devices]
    if not local:
        raise ValueError("a fleet needs at least one device")
    return local


def fleet_devices(devices=None) -> tuple:
    """The fleet's 1-D device list and each device's process: this
    process's `devices` (default the card) once for each process of the
    `torch.distributed` group (one without a group), every process
    holding the same number. Returns (devices as strings, the process
    index of each)."""
    local = _local_devices(devices)
    n_proc = process_count()
    return (tuple(str(d) for d in local) * n_proc,
            tuple(p for p in range(n_proc) for _ in local))


def tree_map(fn, tree):
    """`fn` over the array leaves of nested dicts, lists and tuples (None
    leaves stay None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _concat(parts: list, axis: int):
    """Leafwise concatenation of same-structured trees along `axis`."""
    first = parts[0]
    if len(parts) == 1:
        return first
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts], axis) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_concat([p[i] for p in parts], axis)
                           for i in range(len(first)))
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(first.device) for p in parts], dim=axis)
    return np.concatenate([np.asarray(p) for p in parts], axis=axis)


def _to_host(tree):
    return tree_map(lambda a: a.detach().cpu()
                    if isinstance(a, torch.Tensor) else a, tree)


def all_gather_trees(tree) -> list:
    """Every process's `tree`, in rank order (tensors through the host, as
    gloo needs); `[tree]` without a group."""
    if not is_distributed():
        return [tree]
    out = [None] * process_count()
    dist.all_gather_object(out, _to_host(tree))
    return out


class GridSharding:
    """Pad a sweep's leading grid axis and split it over the fleet's
    devices.

    ::

        gs = GridSharding(k, devices=["cuda:0"] * 4)
        outs = [run(dev, idx) for dev, idx in gs.local_blocks()]
        out = gs.gather(outs)                  # full results, pad dropped

    `devices` are this process's (default: the card; entries may
    repeat); with a `torch.distributed` group every process holds the
    same number, and the grid spans them all (`fleet_devices`), unless
    `across_processes=False` keeps it on this process alone (a one-device
    run inside a fleet worker). Block i of the padded grid belongs to
    device i; this process runs the blocks of its own devices
    (`local_blocks`). The grid is padded to a device-count multiple by
    repeating the last point; `gather` slices the pad off and
    `describe()` reports it. `logical_axis` and `mesh_axis` keep the
    reference's signature; "grid" is the mesh's only axis.
    """

    def __init__(self, grid_points: int, *, devices=None,
                 logical_axis: str = "sweep", mesh_axis: str = "grid",
                 across_processes: bool = True):
        if mesh_axis != "grid":
            raise ValueError(f"the fleet mesh has no {mesh_axis!r} axis")
        del logical_axis               # every logical axis maps to "grid"
        self.grid_points = int(grid_points)
        self.devices = _local_devices(devices)
        self.processes = process_count() if across_processes else 1
        self.rank = process_index() if across_processes else 0
        self.n_devices = len(self.devices) * self.processes
        self.multiprocess = self.processes > 1
        self.pad = (-self.grid_points) % self.n_devices
        self.block = (self.grid_points + self.pad) // self.n_devices
        if self.pad:
            log.info(
                "grid sharding: %d grid points padded with %d repeated "
                "lanes to fill %d devices (%d processes)", self.grid_points,
                self.pad, self.n_devices, self.processes)

    def describe(self) -> dict:
        """Sharding metadata surfaced in sweep summaries (no silent
        pads)."""
        return {"grid_points": self.grid_points, "pad_lanes": self.pad,
                "devices": self.n_devices, "processes": self.processes}

    # ---------------------------------------------------------- placement
    def padded_index(self) -> np.ndarray:
        """The padded grid as indices into the grid: 0..K-1, then K-1
        repeated `pad` times."""
        return np.concatenate([np.arange(self.grid_points),
                               np.full(self.pad, self.grid_points - 1)]) \
            .astype(np.int64)

    def local_blocks(self) -> list:
        """[(device, grid indices [block])] of this process's devices, in
        mesh order."""
        idx = self.padded_index()
        first = self.rank * len(self.devices)
        return [(d, idx[(first + j) * self.block:
                        (first + j + 1) * self.block])
                for j, d in enumerate(self.devices)]

    def pad_tree(self, tree):
        """Repeat each leaf's last grid row `pad` times (sliced off by
        `gather`; repeated points cost compute, never correctness)."""
        if not self.pad:
            return tree

        def _pad(a):
            if isinstance(a, torch.Tensor):
                return torch.cat([a, a[-1:].repeat_interleave(self.pad, 0)])
            if isinstance(a, np.ndarray):
                return np.concatenate([a, np.repeat(a[-1:], self.pad, 0)])
            return list(a) + [a[-1]] * self.pad
        return tree_map(_pad, tree)

    def shard(self, tree) -> list:
        """This process's blocks of `tree` (leaves with a leading grid
        axis): [(device, block)], each tensor block moved to its
        device."""
        out = []
        for dev, idx in self.local_blocks():
            def take(a, idx=idx, dev=dev):
                if isinstance(a, torch.Tensor):
                    return a[torch.as_tensor(idx, device=a.device)].to(dev)
                if isinstance(a, np.ndarray):
                    return a[idx]
                return [a[i] for i in idx]
            out.append((dev, tree_map(take, tree)))
        return out

    def replicate(self, tree) -> list:
        """`tree` on each of this process's devices: [(device, tree)]
        (the tree itself where a device already holds it)."""
        return [(dev, tree_map(lambda a, dev=dev: a.to(dev)
                               if isinstance(a, torch.Tensor) else a, tree))
                for dev in self.devices]

    # ------------------------------------------------------------ results
    def gather(self, blocks: list, *, axis: int = 0):
        """The full (unpadded) result on every process from this process's
        block results (in `local_blocks` order): blocks concatenated along
        `axis` (1 for [N, K] batched sweeps), across processes through
        `all_gather_trees`, tensors on this process's first device; the
        pad rows sliced off."""
        local = _concat(list(blocks), axis)
        if self.multiprocess:
            dev = self.devices[0]
            parts = all_gather_trees(local)
            local = _concat([tree_map(
                lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a,
                p) for p in parts], axis)
        if self.pad:
            k = self.grid_points
            sl = (slice(None),) * axis + (slice(0, k),)
            local = tree_map(lambda a: a[sl], local)
        return local
