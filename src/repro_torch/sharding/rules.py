"""Logical-axis sharding rules (port of `repro.sharding.rules`).

Code names the axes of its arrays logically ("batch", "heads", "sweep",
...); the rules table maps each name to mesh axes of whatever mesh is
active. The port's meshes are descriptions (`launch.mesh.Mesh`: devices,
axis names, the process of each device), and a resolved spec is a plain
tuple with one entry per tensor dimension: None (replicated), one mesh
axis name, or a tuple of them. No DTensor is involved: every DSE lane is
independent, so the sharded entry points place blocks of lanes on devices
themselves (`core.distributed.GridSharding`).

The DSE axes "sweep" and "islands" both resolve to the fleet mesh's "grid"
axis; on meshes without one they resolve to replicated. The LLM rows and
overlays resolve the training state's and the batches' specs
(`models.params.partition_specs`, `train.train_step.state_pspecs`,
`launch.specs`); `to_shardings` turns a tree of specs into placements and
`place` puts a whole tensor on a device of the mesh that this process
owns (it raises for a mesh with none, such as the reference's production
meshes, which serve spec derivation only).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

Axis = Union[str, None]

DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("data",),
    "expert_ff": ("model",),
    "seq": (),
    # Residual-stream sequence axis: sharded over model under sequence
    # parallelism (SP_OVERLAY), distinct from "seq" so SP never takes the
    # model axis from heads / ff inside a block.
    "seq_outer": (),
    # Decode KV caches shard their sequence dimension over the model axis.
    "kv_seq": ("model",),
    # FSDP: weight embedding dims shard over the data axis.
    "model_d": ("data",),
    "state": (),
    "layers": (),
    "capacity": (),
    # DSE fleet axes (core.distributed / launch.fleet): the grid-point axis
    # of a topology / placement / workload sweep and the island axis of the
    # annealed searches shard over the 1-D fleet mesh's "grid" axis
    # (launch.mesh.make_fleet_mesh).
    "sweep": ("grid",),
    "islands": ("grid",),
    # Pareto co-design outputs stay replicated: every process carries the
    # whole front, and the topology axis is a sequential loop.
    "archive": (),
    "topology_grid": (),
}

# Overlays (levers of the LLM stack's parallelism).
SP_OVERLAY = {"seq_outer": ("model",)}                   # sequence parallel
TP_ONLY_OVERLAY = {"model_d": ()}                        # pre-FSDP baseline


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A resolved placement: the mesh and one spec entry per dimension."""
    mesh: object
    spec: tuple


class Rules:
    """Resolves logical axis names against a mesh (`launch.mesh.Mesh`)."""

    def __init__(self, mesh, overrides: Optional[dict] = None):
        self.mesh = mesh
        table = dict(DEFAULT_RULES)
        if overrides:
            table.update(overrides)
        self.table = table

    def _mesh_axes(self, logical: Axis) -> Optional[tuple]:
        if logical is None:
            return None
        axes = tuple(a for a in self.table[logical]
                     if a in self.mesh.axis_names)
        return axes or None

    def spec(self, *logical_axes: Axis) -> tuple:
        """One entry per logical axis: None, a mesh axis, or a tuple of
        mesh axes; a mesh axis is used by one dimension at most."""
        resolved = []
        used = set()
        for ax in logical_axes:
            mesh_axes = self._mesh_axes(ax)
            if mesh_axes is None:
                resolved.append(None)
                continue
            fresh = tuple(a for a in mesh_axes if a not in used)
            used.update(fresh)
            if not fresh:
                resolved.append(None)
            elif len(fresh) == 1:
                resolved.append(fresh[0])
            else:
                resolved.append(fresh)
        return tuple(resolved)

    def spec_for_shape(self, shape: Sequence[int],
                       *logical_axes: Axis) -> tuple:
        """Like `spec`, but a dimension that does not divide its mesh axes'
        product is replicated, and those axes stay free for a later
        dimension."""
        sizes = dict(zip(self.mesh.axis_names, self.mesh.shape))
        resolved = []
        used = set()
        for dim, ax in zip(shape, logical_axes + (None,) * (
                len(shape) - len(logical_axes))):
            mesh_axes = self._mesh_axes(ax)
            if mesh_axes is None:
                resolved.append(None)
                continue
            fresh = tuple(a for a in mesh_axes if a not in used)
            prod = 1
            for a in fresh:
                prod *= sizes[a]
            if not fresh or dim % prod != 0:
                resolved.append(None)
                continue
            used.update(fresh)
            resolved.append(fresh[0] if len(fresh) == 1 else fresh)
        return tuple(resolved)

    def sharding(self, *logical_axes: Axis) -> Sharding:
        return Sharding(self.mesh, self.spec(*logical_axes))


_ACTIVE: list = []


def use_rules(rules: Rules):
    """Context manager installing `rules` for `shard()` and
    `active_rules()`."""
    class _Ctx:
        def __enter__(self):
            _ACTIVE.append(rules)
            return rules

        def __exit__(self, *exc):
            _ACTIVE.pop()
            return False
    return _Ctx()


def active_rules() -> Optional[Rules]:
    return _ACTIVE[-1] if _ACTIVE else None


def shard(x, *logical_axes: Axis):
    """A logical sharding annotation: the identity, as on the reference's
    one-device mesh (the port's sharded paths place lanes themselves)."""
    return x


def to_shardings(pspec_tree, mesh):
    """A tree of partition specs (tuples; nested dicts) as `Sharding`s on
    `mesh`, the counterpart of the reference's `dryrun.to_shardings`."""
    if isinstance(pspec_tree, dict):
        return {k: to_shardings(v, mesh) for k, v in pspec_tree.items()}
    return Sharding(mesh, tuple(pspec_tree))


def _local_device(d) -> Optional[torch.device]:
    """`d` as a torch device this process has, else None."""
    try:
        dev = torch.device(d)
    except (RuntimeError, TypeError):
        return None
    if dev.type == "cpu":
        return dev
    if dev.type == "cuda" and torch.cuda.is_available() \
            and (dev.index or 0) < torch.cuda.device_count():
        return dev
    return None


def place(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """`x`, whole, on the first device of `sharding.mesh` that this process
    owns (the port keeps no sharded tensors); raises, naming the mesh, when
    the mesh holds no device of this process."""
    mesh = sharding.mesh
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
    for d in mesh.local_devices(rank):
        dev = _local_device(d)
        if dev is not None:
            return x.to(dev)
    axes = dict(zip(mesh.axis_names, mesh.shape))
    raise ValueError(
        f"cannot place a tensor on the mesh {axes}: none of its {mesh.size} "
        f"devices is a device of process {rank} (a logical mesh serves spec "
        f"derivation only)")
