"""Faults planted under the topology DSE's timed path
(`perfbench/drivers/sweep_topology_batch.py`), to show that the comparison
which decides `correct` catches them (`perfbench/faults.py` keys its
faults by the other drivers). Each takes a set-up driver, patches the
program where the fault would be produced and returns the undo.

- `state_unchanged`: every lane's gateway bounds pinned to its start, so
  the controller never moves;
- `half_batch`: the summaries taken over the first half of the intervals;
- `altered_answer`: interval 7's latency record of every lane x 1.5;
- `neighbour_topology`: each lane given the next grid point's topology
  rows (chiplet count, selection rows, mesh scalars);
- `padding_leak`: each lane given one chiplet more than its point has, so
  load lands on its first padded chiplet.

`readings(drv, fault)` runs fresh calls with the fault planted (None: the
program as it is) and returns the compared numbers.
"""
from __future__ import annotations

import torch

from perfbench import seeds
from perfbench.checks import Reservoir

FAULTS = ("state_unchanged", "half_batch", "altered_answer",
          "neighbour_topology", "padding_leak")


def _patch(module, name: str, new):
    old = getattr(module, name)
    setattr(module, name, new)
    return lambda: setattr(module, name, old)


def plant(fault: str, drv):
    """Plant `fault` under driver `drv`'s timed path; returns the undo."""
    S = drv.S
    if fault == "state_unchanged":
        from repro_torch.kernels.epoch_step import ops

        real = ops.epoch_run

        def frozen(state, xs, sim, tables, **kw):
            knobs = dict(kw["knobs"], min_gateways=kw["knobs"]["max_gateways"])
            return real(state, xs, sim, tables, **dict(kw, knobs=knobs))
        return _patch(ops, "epoch_run", frozen)
    if fault == "half_batch":
        real = S._record_sums

        def half(recs, t_mask):
            t = t_mask.shape[1] // 2
            return real({k: v[:, :t] for k, v in recs.items()},
                        t_mask[:, :t])
        return _patch(S, "_record_sums", half)
    if fault == "altered_answer":
        real = S.sweep_topology_batch

        def altered(*a, **kw):
            out = real(*a, **kw)
            out["records"]["latency"][:, :, 7] *= 1.5
            return out
        return _patch(S, "sweep_topology_batch", altered)
    real = S.lane_topology
    if fault == "neighbour_topology":
        def neighbour(topo, point, c_max):
            k = int(topo["n_chiplets"].shape[0])
            return real(topo, (point + 1) % k, c_max)
        return _patch(S, "lane_topology", neighbour)
    if fault == "padding_leak":
        def leaking(topo, point, c_max):
            wider = torch.clamp(topo["n_chiplets"] + 1, max=c_max)
            return real(dict(topo, n_chiplets=wider), point, c_max)
        return _patch(S, "lane_topology", leaking)
    raise ValueError(f"no fault {fault!r}")


def readings(drv, fault=None) -> dict:
    """The compared numbers of fresh calls of a set-up driver, as many as
    its check keeps, run with `fault` planted (None: none)."""
    calls = len(drv.buffers)
    drv.kept = Reservoir(calls, seeds.rng(drv.seed, 999))
    undo = plant(fault, drv) if fault else None
    try:
        for i in range(calls):
            drv.call(i)
    finally:
        if undo is not None:
            undo()
    return drv.readings()
