"""Driver of the co-design cells on `repro_torch.core.pareto.search_codesign`
(the device engine).

A call is one search a user runs: topology points x K islands x P
candidates x W workloads scored each generation, a Pareto archive kept
over (latency, power, energy), the result on the host. The workloads'
traces are drawn from the seed once at set-up; each call's search seed
is drawn from the seed too, so every search of a run differs.

The check, on searches drawn from the seed (a reservoir over the
window): the reference cannot replay the search's proposals (they come
from the program's own generator), so it follows the program's reported
state and checks it. Every design the search reports (each archive
entry, each island's incumbent) is simulated again unpadded at its own
chiplet count; its objectives must match, each island's score must be
its incumbent's scalarization against the point's default placement
(the search's start, simulated by the reference too), no archive entry
may dominate another, and every reported placement must lie on the mesh,
collision-free, in the controller's activation order (what the skipped
proposal stage guarantees). The search's public history must agree with
what it reports: each point's best score after its last generation is
its islands' least score, the best score never rises from one
generation to the next, and the archive's size after the last insert is
the count of its valid entries. Which proposals a generation made and
which it accepted are not compared: the result does not hold them.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import seeds
from perfbench.checks import Reservoir, limit_checks
from perfbench.drivers.sweep_batch import network_config
from perfbench.reference import codesign as cref
from perfbench.reference import epoch as ref
from perfbench.traffic.parsec import app_batch, stacked
from perfbench.work import bound_s
from perfbench.work.epoch import padded_epoch_work


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device):
        self.cell, self.config, self.seed = cell, config, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        from repro_torch.core import pareto as P
        from repro_torch.core import simulator as S

        self.S, self.P = S, P
        c, cfg = self.cell, self.config
        self.sim = S.SimConfig(cfg=network_config(cfg)).with_arch(
            S.Arch(cfg["arch"]))
        self.traces = app_batch(list(c["apps"]), c["intervals"],
                                cfg["n_chiplets"], self.seed, 0, self.device,
                                dest=c["dest"])
        self.lm = np.asarray(c["l_m"], np.float32)
        self.kw = dict(n_chiplets=list(c["n_chiplets"]),
                       islands=c["islands"], population=c["population"],
                       generations=c["generations"], archive=c["archive"],
                       migrate_every=c["migrate_every"],
                       knob_grids={"l_m": list(c["l_m"])})
        self.search_seeds = seeds.rng(self.seed, 201).integers(
            0, 2 ** 31 - 1, size=1 << 16)
        g = cfg["max_gateways_per_chiplet"]
        n_w, pts = len(c["apps"]), list(c["n_chiplets"])
        per_pt = c["islands"] * c["population"] * n_w
        lane_c = np.repeat(pts, per_pt)
        pair_c = np.tile(pts, n_w) if c["dest"] else None
        nbytes, ops = padded_epoch_work(
            n_w, c["intervals"], max(pts), g, lane_c,
            np.full(len(lane_c), g), pair_c)
        self.launch_bound = bound_s(nbytes, ops)
        self.bound = c["generations"] * self.launch_bound
        self.lane_intervals = c["generations"] * len(lane_c) * c["intervals"]
        self.kept = Reservoir(c["check"]["calls"], seeds.rng(self.seed, 202))
        self._run(-1)

    def _run(self, i: int) -> dict:
        seed = int(self.search_seeds[i % len(self.search_seeds)])
        return self.P.search_codesign(self.traces, self.sim,
                                      device=self.device, seed=seed,
                                      **self.kw)

    def call(self, i: int) -> dict:
        res = self._run(i)
        if i >= 0:
            self.kept.offer(i, res)
        return {"work": {"lane_intervals": self.lane_intervals},
                "bound_s": self.bound,
                "kernel_bound_s": {"epoch_step": self.bound}}

    def counters(self) -> dict:
        return self.S.engine_stats()

    def release(self) -> None:
        """Nothing to free: the kept results are on the host."""

    # -- the check ---------------------------------------------------------

    def designs(self, res: dict) -> tuple:
        """(designs, archive rows, incumbent (t, k), default (t, k)) of one
        result: every valid archive entry, every island incumbent and each
        (point, island)'s default placement, as (n_chiplets, placement,
        knobs)."""
        cfg = self.config
        g = cfg["max_gateways_per_chiplet"]
        pts = list(self.cell["n_chiplets"])
        arch = res["archive"]
        knobs = [{"l_m": float(self.lm[k]), "max_gateways": g}
                 for k in range(len(self.lm))]
        dpos = ref.default_positions(cfg["mesh_x"], cfg["mesh_y"], g)
        designs, rows, incs, defs = [], [], [], []
        for i in np.flatnonzero(arch["valid"]):
            t, k = int(arch["topology_index"][i]), int(arch["island"][i])
            designs.append((pts[t], np.asarray(arch["placements"][i]),
                            knobs[k]))
            rows.append(i)
        for t, per_t in enumerate(res["island_incumbents"]):
            for k, pos in enumerate(per_t):
                designs.append((pts[t], np.asarray(pos), knobs[k]))
                incs.append((t, k))
        for t in range(len(pts)):
            for k in range(len(self.lm)):
                designs.append((pts[t], dpos, knobs[k]))
                defs.append((t, k))
        return designs, rows, incs, defs

    def readings(self, dtype=torch.float32) -> dict:
        """The compared numbers over the kept searches, with the reference
        (float32) or the control (`dtype` lower) in the program's place."""
        arrs = stacked(self.traces)
        w = cref.island_weights(len(self.lm))
        mx, my = self.config["mesh_x"], self.config["mesh_y"]
        out = {"objective_err": 0.0, "score_err": 0.0, "history_faults": 0,
               "dominated": 0, "placement_faults": 0}
        for _, res in self.kept.items():
            designs, rows, incs, _ = self.designs(res)
            wk = w[[k for _, k in incs]]
            want = cref.objectives(arrs, designs, self.config)
            na, ni = len(rows), len(incs)
            if dtype != torch.float32:
                got = cref.objectives(arrs, designs, self.config,
                                      dtype=dtype)
                got_obj = got[:na]
                norm = got[na + ni:]
                got_s = cref.scalarize(got[na:na + ni], wk, norm)
            else:
                got_obj = res["archive"]["objectives"][rows]
                got_s = np.asarray([res["island_scores"][t][k]
                                    for t, k in incs])
            want_s = cref.scalarize(want[na:na + ni], wk, want[na + ni:])
            rel = np.abs(got_obj - want[:na]) / np.maximum(
                np.abs(want[:na]), 1e-30)
            out["objective_err"] = max(out["objective_err"],
                                       float(np.max(rel, initial=0.0)))
            srel = np.abs(got_s - want_s) / np.maximum(np.abs(want_s), 1e-30)
            out["score_err"] = max(out["score_err"],
                                   float(np.max(srel, initial=0.0)))
            out["history_faults"] += history_faults(res)
            out["dominated"] += cref.dominated(np.asarray(got_obj))
            out["placement_faults"] += sum(
                cref.placement_faults(d[1], mx, my)
                for d in designs[:na + ni])
            if not np.all(np.isfinite(got_obj)) or not np.all(
                    np.isfinite(got_s)):
                out["objective_err"] = float("inf")
        return out

    def check(self) -> dict:
        return limit_checks(self.readings(), self.cell["limits"])


def history_faults(res: dict) -> int:
    """How many of the history's rows disagree with the reported result:
    per point, a last best score other than its islands' least score or a
    best score that rises; then an archive size after the last insert
    other than the count of valid entries."""
    best = np.asarray(res["history"]["best_scalar"])
    scores = np.asarray(res["island_scores"])
    n = int(np.sum(best[:, -1] != scores.min(axis=1)))
    n += int(np.sum(np.any(np.diff(best, axis=1) > 0, axis=1)))
    size = np.asarray(res["history"]["archive_size"])
    return n + int(size[-1, -1] != np.sum(res["archive"]["valid"]))
