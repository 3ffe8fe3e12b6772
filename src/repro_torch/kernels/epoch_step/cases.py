"""The simulator cases past 128 chiplets that hold the `epoch_step` kernel's
"wide" design against the plain version, built in one place for every
caller.

`chip_smoke.py` runs them on the card (kernel against plain on the same
inputs, and through `simulate`), the card tests (`tests/test_torch_cuda.py`)
likewise at a smaller T, and the CPU tests hold the plain version to the
reference's `simulate` on the same numpy inputs.

Cases: RESIPI at 144 and 256 chiplets, each clean, with destination
matrices, and with a fault frame (dead slot windows, random dead slots,
stuck-on cells, a loss-drift ramp) together with destination matrices; and
RESIPI_ALL at 256 chiplets. Traces are made with numpy from a seed per
case: per-chiplet loads around the controller's L_m (so gateways switch),
intra-chiplet and memory traffic, a ragged tail under `t_mask`.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

from repro_torch.core.constants import NETWORK
from repro_torch.core.simulator import Arch, SimConfig

WIDE_NAMES = ("c144", "c144-dest", "c144-faults+dest", "c256", "c256-dest",
              "c256-faults+dest", "c256-all-gateways")


class Case(NamedTuple):
    name: str
    trace: dict          # numpy arrays: the loads, t_mask, dest, faults
    sim: SimConfig


def make_trace(rng: np.random.RandomState, t: int, c: int, g: int, *,
           dest: bool, faults: bool) -> dict:
    """One numpy trace of `t` intervals over `c` chiplets: loads around
    the controller's L_m, a ragged tail under `t_mask`, and optionally a
    random row-stochastic destination matrix and a fault frame."""
    phase = 1.0 + 0.5 * np.sin(np.arange(t) / 7.0 + rng.rand() * 6.28)
    ext = (0.03 * phase[:, None] * rng.lognormal(0.0, 0.4, (t, c))
           * rng.uniform(0.6, 1.4, c)).astype(np.float32)
    t_mask = np.ones(t, np.float32)
    t_mask[t - t // 6:] = 0.0                  # a ragged tail
    out = {"ext_load": ext,
           "mem_load": (0.02 * ext.sum(1)).astype(np.float32),
           "int_load": (1.5 * ext * rng.rand(t, c)).astype(np.float32),
           "ext_frac": np.float32(0.4), "t_mask": t_mask}
    if dest:
        d = rng.rand(c, c).astype(np.float32) ** 4
        np.fill_diagonal(d, 0.0)
        out["dest"] = (d / d.sum(-1, keepdims=True)).astype(np.float32)
    if faults:
        ok = np.ones((t, c, g), np.float32)
        ok[t // 5: t // 2, min(3, c - 1), 0] = 0.0   # a dead slot window
        ok[t // 3:, c - 1, :] = 0.0             # a chiplet's gateways down
        ok[rng.rand(t, c, g) < 0.02] = 0.0       # scattered dead slots
        stuck = np.zeros((t, c, g), np.float32)
        stuck[2: t - 2, min(5, c - 1), g - 1] = 1.0  # a stuck-on cell
        stuck[rng.rand(t, c, g) < 0.01] = 1.0
        out.update(gw_ok=ok, stuck_on=stuck,
                   drift_db=np.clip(0.04 * np.arange(t) - 0.6, 0.0, 1.5)
                   .astype(np.float32))
    return out


def wide_case(name: str, t: int = 48) -> Case:
    """The case `name` of WIDE_NAMES over `t` intervals."""
    if name not in WIDE_NAMES:
        raise KeyError(f"no wide epoch_step case {name!r} (have "
                       f"{WIDE_NAMES})")
    c = int(name[1:4])
    cfg = NETWORK.with_topology(n_chiplets=c)
    arch = Arch.RESIPI_ALL if name.endswith("all-gateways") else Arch.RESIPI
    rng = np.random.RandomState(WIDE_NAMES.index(name) + 100)
    trace = make_trace(rng, t, c, cfg.max_gateways_per_chiplet,
                   dest="dest" in name, faults="faults" in name)
    return Case(name, trace, SimConfig(cfg=cfg).with_arch(arch))


def wide_cases(t: int = 48, names: Sequence[str] = WIDE_NAMES) -> List[Case]:
    return [wide_case(n, t) for n in names]


# Padded calls (one topology per lane): the grid of each width, zipped
# (n_chiplets, gateways_per_chiplet, l_m) points over three traces made at
# the grid's widest point.
PADDED_GRIDS = {
    9: dict(n_chiplets=[4, 6, 9, 9], gateways_per_chiplet=[4, 2, 3, 4],
            l_m=[0.006, 0.02, 0.0152, 0.01]),
    16: dict(n_chiplets=[4, 8, 12, 16], gateways_per_chiplet=[1, 4, 2, 4],
             l_m=[0.012, 0.006, 0.0152, 0.02]),
    144: dict(n_chiplets=[16, 64, 100, 144],
              gateways_per_chiplet=[4, 3, 4, 2],
              l_m=[0.0152, 0.008, 0.02, 0.0152]),
}
PADDED_KINDS = ("clean", "dest", "ragged")
PADDED_NAMES = tuple(f"pad{c}-{kind}" for c in PADDED_GRIDS
                     for kind in PADDED_KINDS)


class PaddedCase(NamedTuple):
    name: str
    traces: list         # numpy trace dicts at the grid's widest point
    sim: SimConfig       # the unpadded base config
    grid: dict           # sweep_topology grids (zipped)


def padded_case(name: str, t: int = 24,
                arch: Arch = Arch.RESIPI) -> PaddedCase:
    """The padded case `name` of PADDED_NAMES over `t` intervals: three
    traces (a ragged tail each; "ragged" adds an all-masked trace and one
    with an interior gap) and the grid of its width."""
    if name not in PADDED_NAMES:
        raise KeyError(f"no padded epoch_step case {name!r} (have "
                       f"{PADDED_NAMES})")
    c_max = int(name[3:].split("-")[0])
    kind = name.split("-")[1]
    cfg = NETWORK.with_topology(n_chiplets=c_max)
    rng = np.random.RandomState(PADDED_NAMES.index(name) + 300)
    traces = [make_trace(rng, t, c_max, cfg.max_gateways_per_chiplet,
                         dest=kind == "dest", faults=False)
              for _ in range(3)]
    if kind == "ragged":
        traces[1]["t_mask"] = np.zeros(t, np.float32)
        traces[2]["t_mask"][t // 4: t // 2] = 0.0
    grid = {k: (np.float32(v) if k == "l_m" else list(v))
            for k, v in PADDED_GRIDS[c_max].items()}
    return PaddedCase(name, traces, SimConfig().with_arch(arch), grid)
