"""Driver of the flit-level cells on
`repro_torch.kernels.noc_step.ops.noc_run`.

A call is one flit-level DSE: every (mesh radix, active gateways,
wavelengths, load) run of the cell, padded to one node count, simulated
for the cell's cycles in one `noc_run`, ending when residency, final
occupancy and drained flits of every run are on the host. The runs'
topologies come from the program's `build_topology_padded` at set-up; the
arrivals are drawn from the seed (`traffic.flit`), several sets that the
calls cycle through.

The check: for each arrival set, one of its calls drawn from the seed (a
reservoir over the window) is compared run by run, dead padded lanes
included, with the plain reference (`reference.flit`), which builds every
run's routing, drains and buffers itself.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import seeds
from perfbench.checks import Reservoir, limit_checks, row_scaled_error
from perfbench.drivers.sweep_batch import network_config
from perfbench.reference import flit as fref
from perfbench.traffic.flit import arrivals
from perfbench.work import bound_s
from perfbench.work.noc import noc_work


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device):
        self.cell, self.config, self.seed = cell, config, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        from repro_torch.core import simulator as S
        from repro_torch.kernels.noc_step import ops as nops

        self.S, self.nops = S, nops
        c = self.cell
        loads = np.linspace(*c["loads"][:2], int(c["loads"][2]))
        self.runs = [(r, g, w, float(ld)) for r in c["radix"]
                     for g in c["gateways"] for w in c["wavelengths"]
                     for ld in loads]
        net = network_config(self.config)
        topo = {}
        for r, g, w, _ in self.runs:
            if (r, g, w) not in topo:
                topo[r, g, w] = nops.build_topology_padded(
                    g, w, net.with_topology(mesh_radix=r),
                    pad_to=c["pad_to"])
        self.topo = [torch.as_tensor(np.stack(
            [topo[r, g, w][i] for r, g, w, _ in self.runs]),
            device=self.device) for i in range(4)]
        routers = [r * r for r, _, _, _ in self.runs]
        self.sets = [arrivals([x[3] for x in self.runs], routers,
                              c["cycles"], c["pad_to"],
                              self.config["packet_flits"], self.seed, s,
                              self.device)
                     for s in range(c["arrival_sets"])]
        live = sum(r * r + g for r, g, _, _ in self.runs)
        nbytes, ops = noc_work(len(self.runs), c["cycles"], c["pad_to"],
                               live)
        self.bound = bound_s(nbytes, ops)
        self.node_cycles = live * c["cycles"]
        self.kept = [Reservoir(c["check"]["calls_per_set"],
                               seeds.rng(self.seed, 301 + s))
                     for s in range(c["arrival_sets"])]
        for s in range(c["arrival_sets"]):
            self._run(s)

    def _run(self, s: int) -> tuple:
        nm, drain, buf, mask = self.topo
        out = self.nops.noc_run(self.sets[s], nm, drain, buf,
                                valid_mask=mask)
        return tuple(x.cpu() for x in out)

    def call(self, i: int) -> dict:
        s = i % len(self.sets)
        host = self._run(s)
        if i >= 0:
            self.kept[s].offer(i, host)
        return {"work": {"node_cycles": self.node_cycles},
                "bound_s": self.bound,
                "kernel_bound_s": {"noc_step": self.bound}}

    def counters(self) -> dict:
        return self.S.engine_stats()

    def release(self) -> None:
        """Frees the program's routing tensors; the check reads the
        arrivals and the kept host results."""
        self.topo = None

    # -- the check ---------------------------------------------------------

    def reference_topology(self) -> tuple:
        c = self.cell
        per = {}
        for r, g, w, _ in self.runs:
            if (r, g, w) not in per:
                per[r, g, w] = fref.topology(r, g, w, self.config,
                                             c["pad_to"])
        return tuple(torch.as_tensor(np.stack(
            [per[r, g, w][i] for r, g, w, _ in self.runs]),
            device=self.device) for i in range(4))

    def readings(self, dtype=torch.float32) -> dict:
        """The compared number over the kept calls, with the reference
        (float32) or the control (`dtype` lower) in the program's place:
        the largest error of residency, final occupancy or drained flits
        of any run relative to that run's own largest value (at least one
        flit)."""
        nm, drain, buf, mask = self.reference_topology()
        err = 0.0
        for s, kept in enumerate(self.kept):
            for _, host in kept.items():
                want = fref.run(self.sets[s], nm, drain, buf, mask)
                got = host if dtype == torch.float32 else fref.run(
                    self.sets[s], nm, drain, buf, mask, dtype=dtype)
                for a, b in zip(got, want):
                    err = max(err, row_scaled_error(a, b, 1.0))
        return {"flit_err": err}

    def check(self) -> dict:
        return limit_checks(self.readings(), self.cell["limits"])
