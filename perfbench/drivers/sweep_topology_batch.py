"""Driver of the topology DSE cells on
`repro_torch.core.simulator.sweep_topology_batch`.

A call is one topology scan a user runs: `sweep_topology_batch(traces,
sim, n_chiplets=[..], gateways_per_chiplet=[..])` over N application
traces (each with its destination matrix) x K zipped points, N x K lanes
of T intervals padded to the largest point's chiplet count, ending when
its per-lane summary is in host buffers. The cell's batches of traces are
drawn from the seed at set-up and cycled.

The check: from calls drawn from the seed (a reservoir over the window),
every lane (each of the K points N times) is simulated again by the plain
reference (`reference.topology`), unpadded at its own point, and compared
record by record and summary by summary as in `sweep_batch`'s check;
`padding_leak` counts the per-chiplet records (g, wavelengths, gateway
loads) that are not zero on a lane's padded chiplets.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import seeds
from perfbench.checks import Reservoir, limit_checks, scaled_error
from perfbench.drivers.sweep_batch import network_config
from perfbench.reference import epoch as ref
from perfbench.reference import topology as tref
from perfbench.traffic.parsec import app_batch, stacked
from perfbench.work import bound_s
from perfbench.work.epoch import padded_epoch_work


def points(cell: dict) -> list:
    """The zipped grid's (n_chiplets, gateways_per_chiplet) points, the
    chiplet count slowest."""
    return [(int(c), int(g)) for c in cell["n_chiplets"]
            for g in cell["gateways_per_chiplet"]]


def cell_work(cell: dict) -> tuple:
    """(lane intervals, least seconds) of one call: every lane's real
    chiplets and gateway slots, one destination matrix per (trace, chiplet
    count) pair."""
    pts = points(cell)
    n, t = len(cell["apps"]), cell["intervals"]
    cs = [c for c, _ in pts]
    gs = [g for _, g in pts]
    nbytes, ops = padded_epoch_work(
        n, t, max(cs), max(gs), np.tile(cs, n), np.tile(gs, n),
        np.tile(sorted(set(cs)), n))
    return n * len(pts) * t, bound_s(nbytes, ops)


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device):
        self.cell, self.config, self.seed = cell, config, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        from repro_torch.core import simulator as S

        self.S = S
        c, cfg = self.cell, self.config
        self.sim = S.SimConfig(cfg=network_config(cfg)).with_arch(
            S.Arch(cfg["arch"]))
        pts = points(c)
        self.grid = {"n_chiplets": [p[0] for p in pts],
                     "gateways_per_chiplet": [p[1] for p in pts]}
        self.c_pad = max(self.grid["n_chiplets"])
        self.batches = [app_batch(list(c["apps"]), c["intervals"],
                                  cfg["n_chiplets"], self.seed, b,
                                  self.device)
                        for b in range(c["batches"])]
        n = len(c["apps"])
        self.lane_c = np.tile(self.grid["n_chiplets"], n)
        self.lane_g = np.tile(self.grid["gateways_per_chiplet"], n)
        self.lane_trace = np.repeat(np.arange(n), len(pts))
        self.lane_intervals, self.bound = cell_work(c)
        self.kept = Reservoir(c["check"]["calls"], seeds.rng(self.seed, 301))
        self.host = None
        out, _ = self._run(0)
        # The summary lands in host buffers allocated once (pinned on the
        # card), as in `sweep_batch`'s driver; a kept call copies its
        # records into device buffers allocated once here.
        self.host = {k: torch.empty(v.shape, dtype=v.dtype,
                                    pin_memory=self.device.type == "cuda")
                     for k, v in out["summary"].items()}
        self.buffers = [{k: torch.empty_like(v)
                         for k, v in out["records"].items()}
                        for _ in range(c["check"]["calls"])]
        del out
        self._run(0)

    def _run(self, b: int) -> tuple:
        out = self.S.sweep_topology_batch(self.batches[b], self.sim,
                                          device=self.device, **self.grid)
        if self.host is None:
            return out, {k: v.cpu() for k, v in out["summary"].items()}
        for k, v in out["summary"].items():
            self.host[k].copy_(v, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out, self.host

    def call(self, i: int) -> dict:
        b = i % len(self.batches)
        out, host = self._run(b)
        slot = self.kept.slot() if i >= 0 else None
        if slot is not None:
            buf = self.buffers[slot]
            for k, v in out["records"].items():
                buf[k].copy_(v)
            self.kept.put(slot, i, (b, buf, {k: v.clone()
                                             for k, v in host.items()}))
        return {"work": {"lane_intervals": self.lane_intervals},
                "bound_s": self.bound,
                "kernel_bound_s": {"epoch_step": self.bound}}

    def counters(self) -> dict:
        return self.S.engine_stats()

    def release(self) -> None:
        """Nothing to free: the check reads the kept calls' records and
        the traces they ran on."""

    # -- the check ---------------------------------------------------------

    def kept_lanes(self) -> tuple:
        """The kept calls' lanes as one batch: (stacked traces of every
        kept call's batch, lane -> trace, program records and summaries
        with one lane axis). The reference runs on the traces' device: on
        the host's CPU its sums over chiplets round otherwise than the
        card's, and about one seed in ten then flips a controller decision
        at its threshold (PERF.md §6)."""
        parts = [(stacked(self.batches[b]), rec, summ)
                 for _, (b, rec, summ) in self.kept.items()]
        arrs = {k: None if parts[0][0][k] is None
                else torch.cat([p[0][k] for p in parts])
                for k in parts[0][0]}
        n = len(self.cell["apps"])
        lane_trace = np.concatenate([self.lane_trace + j * n
                                     for j in range(len(parts))])
        recs = {k: torch.cat([p[1][k].flatten(0, 1) for p in parts])
                for k in parts[0][1]}
        summ = {k: torch.cat([p[2][k].reshape(-1) for p in parts])
                for k in parts[0][2]}
        return arrs, lane_trace, recs, summ

    def readings(self, dtype=torch.float32) -> dict:
        """The compared numbers over the kept calls, with the reference
        (float32) or the control (`dtype` lower) in the program's place."""
        arrs, lane_trace, rec, summ = self.kept_lanes()
        reps = len(lane_trace) // len(self.lane_c)
        lane_c = np.tile(self.lane_c, reps)
        lane_g = np.tile(self.lane_g, reps)
        want = tref.run_topology(arrs, lane_trace, lane_c, lane_g,
                                 self.config, self.c_pad)
        if dtype != torch.float32:
            got = tref.run_topology(arrs, lane_trace, lane_c, lane_g,
                                    self.config, self.c_pad, dtype=dtype)
            rec, summ = got["records"], got["summary"]
        dev = arrs["ext"].device
        real = (torch.arange(self.c_pad, device=dev)[None, None, :]
                < torch.as_tensor(lane_c, device=dev)[:, None, None])
        out = {"record_err": 0.0, "summary_err": 0.0}
        wrong = total = leak = 0
        for k in ref.RECORD_INTS:
            w, g = want["records"][k], rec[k]
            if k in tref.PER_CHIPLET:
                mask = real.expand_as(w)
                wrong += int(((g != w) & mask).sum())
                total += int(mask.sum())
            else:
                wrong += int((g != w).sum())
                total += w.numel()
        for k in tref.PER_CHIPLET:
            leak += int(((rec[k] != 0) & ~real).sum())
        for k in ref.RECORD_FLOATS:
            out["record_err"] = max(out["record_err"],
                                    scaled_error(rec[k], want["records"][k]))
        for k, w in want["summary"].items():
            out["summary_err"] = max(out["summary_err"],
                                     scaled_error(summ[k], w))
        out["int_mismatch"] = wrong / max(total, 1)
        out["padding_leak"] = leak
        return out

    def check(self) -> dict:
        return limit_checks(self.readings(), self.cell["limits"])
