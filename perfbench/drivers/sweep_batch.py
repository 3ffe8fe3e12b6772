"""Driver of the DSE cells on `repro_torch.core.simulator.sweep_batch`.

A call is one DSE a user runs: `sweep_batch(traces, sim, l_m=..,
buffer_sat=..)` over N application traces x K knob points (N x K lanes,
every lane T intervals), ending when its per-lane summary is on the host.
The cell's batches of traces are drawn from the seed at set-up and cycled.

The check: from calls drawn from the seed (a reservoir over the window),
a sample of lanes drawn from the seed (their records copied out as the
call is kept) is simulated again by the plain reference
(`reference.epoch`) from the same traces and knobs, with its own
selection tables, and compared record by record (every interval's g,
saturation, latency, power, laser, energy, reconfiguration energy,
wavelengths, gateway loads, mean inter-chiplet latency) and summary by
summary (what the user read).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import seeds
from perfbench.checks import Reservoir, limit_checks, scaled_error
from perfbench.reference import epoch as ref
from perfbench.traffic.parsec import app_batch, stacked
from perfbench.work import bound_s
from perfbench.work.epoch import epoch_work


def network_config(config: dict):
    """The program's NetworkConfig with the configuration file's sizes."""
    from repro_torch.core.constants import NETWORK

    fields = {f.name for f in dataclasses.fields(NETWORK)}
    return dataclasses.replace(NETWORK, **{k: v for k, v in config.items()
                                            if k in fields})


def knob_grid(spec: dict) -> dict:
    """{"l_m": [lo, hi, n], ...}: every field a float32 linspace, crossed
    (the first field slowest) and flattened to zipped points."""
    axes = [np.linspace(lo, hi, int(n), dtype=np.float32)
            for lo, hi, n in spec.values()]
    mesh = np.meshgrid(*axes, indexing="ij")
    return {k: m.ravel() for k, m in zip(spec, mesh)}


class Driver:
    def __init__(self, cell: dict, config: dict, seed: int, device):
        self.cell, self.config, self.seed = cell, config, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        from repro_torch.core import simulator as S

        self.S = S
        cfg = network_config(self.config)
        self.sim = S.SimConfig(cfg=cfg).with_arch(
            S.Arch(self.config["arch"]))
        c = self.cell
        self.apps = list(c["apps"])
        self.grid = knob_grid(c["grid"])
        self.batches = [app_batch(self.apps, c["intervals"],
                                  self.config["n_chiplets"], self.seed, b,
                                  self.device)
                        for b in range(c["batches"])]
        self.n, self.k = len(self.apps), len(next(iter(self.grid.values())))
        nbytes, ops = epoch_work(self.n, c["intervals"],
                                 self.config["n_chiplets"],
                                 self.config["max_gateways_per_chiplet"],
                                 self.n * self.k, dest=True)
        self.bound = bound_s(nbytes, ops)
        self.lane_intervals = self.n * self.k * c["intervals"]
        self.kept = Reservoir(c["check"]["calls"],
                              seeds.rng(self.seed, 101))
        nk = self.n * self.k
        self.lanes = np.sort(seeds.rng(self.seed, 102).choice(
            nk, min(c["check"]["lanes"], nk), replace=False))
        self.lane_idx = torch.as_tensor(self.lanes, device=self.device)
        self.host = None
        out, _ = self._run(0)
        # The client reads every summary into host buffers allocated once
        # here (pinned on the card), as a DSE client that reads a 17 MB
        # summary 40 times a second does: a fresh pageable copy a call
        # makes the call's time follow the host's memory load.
        self.host = {k: torch.empty(v.shape, dtype=v.dtype,
                                    pin_memory=self.device.type == "cuda")
                     for k, v in out["summary"].items()}
        # Buffers for the kept calls' sampled lanes, allocated once here:
        # a kept call copies its sample in and drops its output, so the
        # window's calls run on the same memory whatever is kept.
        self.buffers = [{k: v.new_empty((len(self.lanes),) + v.shape[2:])
                         for k, v in out["records"].items()}
                        for _ in range(c["check"]["calls"])]
        del out
        self._run(0)

    def _run(self, b: int) -> tuple:
        out = self.S.sweep_batch(self.batches[b], self.sim,
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
                torch.index_select(v.flatten(0, 1), 0, self.lane_idx,
                                   out=buf[k])
            lanes = torch.as_tensor(self.lanes)
            self.kept.put(slot, i, (b, buf, {
                k: v.reshape(-1)[lanes] for k, v in host.items()}))
        return {"work": {"lane_intervals": self.lane_intervals},
                "bound_s": self.bound,
                "kernel_bound_s": {"epoch_step": self.bound}}

    def counters(self) -> dict:
        return self.S.engine_stats()

    def release(self) -> None:
        """Nothing to free: the check reads the kept calls' samples and
        the traces they ran on."""

    # -- the check ---------------------------------------------------------

    def reference_lanes(self, b: int, lanes: np.ndarray) -> dict:
        """The reference's lanes dict for lane indices of batch `b`."""
        arrs = stacked(self.batches[b])
        dev = arrs["ext"].device
        idx = torch.as_tensor(lanes // self.k, device=dev)
        pt = lanes % self.k
        cfg = self.config
        src, loss = ref.selection_columns(
            cfg["mesh_x"], cfg["mesh_y"],
            ref.default_positions(cfg["mesh_x"], cfg["mesh_y"],
                                  cfg["max_gateways_per_chiplet"]),
            cfg["router_pitch_mm"])
        m = len(lanes)

        def full(v, dtype=torch.float32):
            return torch.full((m,), v, dtype=dtype, device=dev)

        knobs = {k: full(cfg[k]) for k in ("l_m", "buffer_sat",
                                            "wavelengths")}
        for k, v in self.grid.items():
            knobs[k] = torch.as_tensor(v[pt], device=dev)
        return dict(
            knobs, ext=arrs["ext"][idx], intra=arrs["intra"][idx],
            mem=arrs["mem"][idx], t_mask=arrs["t_mask"][idx],
            dest=arrs["dest"][idx],
            max_gateways=full(cfg["max_gateways_per_chiplet"], torch.int32),
            min_gateways=full(cfg["min_gateways"], torch.int32),
            src_hops=torch.as_tensor(src, device=dev).expand(m, -1),
            gw_loss_db=torch.as_tensor(loss, device=dev).expand(m, -1),
            n_chiplets=full(float(cfg["n_chiplets"])))

    def readings(self, dtype=torch.float32) -> dict:
        """The compared numbers over the kept calls, with the reference
        (float32) or the control (`dtype` lower) in the program's place."""
        net = ref.network_constants(self.config)
        worst = {"record_err": 0.0, "summary_err": 0.0}
        wrong, total = 0, 0
        for _, (b, rec, summ) in self.kept.items():
            lanes_in = self.reference_lanes(b, self.lanes)
            want = ref.run_lanes(lanes_in, net)
            if dtype != torch.float32:
                got = ref.run_lanes(lanes_in, net, dtype=dtype)
                rec, summ = got["records"], got["summary"]
            for k in ref.RECORD_INTS:
                w = want["records"][k]
                wrong += int((rec[k].to(w.device) != w).sum())
                total += w.numel()
            for k in ref.RECORD_FLOATS:
                worst["record_err"] = max(worst["record_err"],
                                          scaled_error(rec[k],
                                                       want["records"][k]))
            for k in want["summary"]:
                worst["summary_err"] = max(
                    worst["summary_err"],
                    scaled_error(summ[k], want["summary"][k]))
        worst["int_mismatch"] = wrong / max(total, 1)
        return worst

    def check(self) -> dict:
        return limit_checks(self.readings(), self.cell["limits"])
