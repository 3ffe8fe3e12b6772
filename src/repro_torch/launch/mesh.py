"""Mesh descriptions (port of `repro.launch.mesh`).

A mesh here is a description, not a device object: its devices (a device
may repeat, to emulate several on one), its axis names and shape, and the
process that owns each device. Building one touches no device, so
importing this module is free.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.distributed import fleet_devices


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`devices` in row-major order over `shape`; `process_index[i]` is the
    rank of the process that owns device i."""
    devices: tuple
    axis_names: tuple
    shape: tuple
    process_index: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def local_devices(self, rank: int) -> list:
        """The devices process `rank` owns, in mesh order."""
        return [d for d, p in zip(self.devices, self.process_index)
                if p == rank]


def make_fleet_mesh(devices=None) -> Mesh:
    """1-D ("grid",) mesh over every device of the fleet: `devices` (this
    process's; default the card, which must be present) for each process
    of the `torch.distributed` group (one without a group), every process
    holding the same number (`distributed.fleet_devices`). With one
    device in one process every sharding over it is a placement no-op."""
    devs, owner = fleet_devices(devices)
    return Mesh(devs, ("grid",), (len(devs),), owner)


def make_host_mesh() -> Mesh:
    """Single-device mesh for CPU smoke tests (axis sizes 1)."""
    return Mesh(("cpu",), ("data", "model"), (1, 1), (0,))


def make_logical_mesh(shape: tuple, axis_names: tuple) -> Mesh:
    """A mesh of placeholder devices ("logical:<i>", row-major over
    `shape`): it serves spec derivation (`sharding.rules.Rules`,
    `launch.specs`, `train_step.state_pspecs`) and the dry run's
    accounting (`launch.op_analysis`); placing a tensor on it raises
    (`sharding.rules.place`)."""
    n = 1
    for a in shape:
        n *= a
    return Mesh(tuple(f"logical:{i}" for i in range(n)), tuple(axis_names),
                tuple(shape), (0,) * n)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, 16 x 16 ("data", "model"), or
    2 x 16 x 16 ("pod", "data", "model") with `multi_pod`, as a logical
    mesh (`make_logical_mesh`), as the reference's dry run lowers onto 512
    placeholder devices."""
    if multi_pod:
        return make_logical_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_logical_mesh((16, 16), ("data", "model"))
