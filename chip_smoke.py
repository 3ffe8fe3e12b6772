#!/usr/bin/env python3
"""Drive the PyTorch port of the ReSiPI simulator on one NVIDIA card.

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds every kernel of the port's main path from the sources in the
checkout, holds each kernel against its plain PyTorch version on the card,
drives the main path through the entry points a user calls, and measures
the kernels. Phases (one line per step; any failure exits non-zero):

  1. card and build: nvidia-smi name and power limit, build seconds and the
     ptxas register / spill report;
  2. kernel against plain on the card at the Table-1 widths, T = 100:
     clean, destination matrices, a ragged t_mask batch with an all-masked
     lane, a fault frame, and a 64-point sweep over the five kernel knobs
     (rtol = atol = 1e-6, integer g and boolean saturation exact);
  3. the paper through the port's own generator: Fig. 11 (8 PARSEC apps x
     4 architectures), Fig. 10 (L_m) and Fig. 12 (settle times);
  4. a full-size DSE: RESIPI `sweep_batch` over 8 PARSEC apps with
     destination matrices x a 64 x 64 (l_m x buffer_sat) grid at T = 100
     (32 768 lanes); then every kernel call of phases 3 and 4 is held
     against the plain version on its own inputs, and the kernel's time,
     the plain version's and the entry point's warm host time are taken;
  5. a `kernels` JSON line (launches on the main path, error against plain,
     times and the bound).

Phases 3 and 4 are the main path: the launch counters are zeroed before
phase 3 and read after the phase-4 entry-point run, before any timing.
The last line is {"ok": true, "device": {...}}. Without a card, or without
the rest of the repository beside this file, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

T_INTERVALS = 100
RTOL = ATOL = 1e-6
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Float operations of the epoch_step kernel, counted from its source per
# lane-interval (memory-gateway latency, reductions, power), per chiplet
# (loads, M/D/1 terms, controller), per chiplet pair when destination
# matrices are on (recv, phi and the destination leg sum) and per gateway
# slot (old and new Eq. 4 kappas and the switch test).
OPS_PER_LANE, OPS_PER_CHIPLET, OPS_PER_PAIR, OPS_PER_SLOT = 90, 80, 6, 12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_cuda(fn, reps: int) -> list:
    """Per-call milliseconds of `fn` on the current stream (CUDA events)."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def compare(got, want, what: str) -> float:
    """Max abs error of float fields; ints and bools must be exact."""
    worst = 0.0
    for k in want:
        a, b = got[k], want[k]
        if a.shape != b.shape:
            fail(f"{what}: {k} shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if b.dtype in (torch.bool, torch.int32, torch.int64):
            if a.dtype != b.dtype or not torch.equal(a, b):
                bad = int((a != b).sum())
                fail(f"{what}: {k} differs exactly in {bad} entries")
            continue
        if not torch.isfinite(a).all():
            fail(f"{what}: {k} has non-finite values")
        if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
            err = float((a - b).abs().max())
            fail(f"{what}: {k} max abs err {err:g} beyond rtol=atol={RTOL}")
        if a.numel():
            worst = max(worst, float((a - b).abs().max()))
    return worst


def state_fields(state) -> dict:
    return {"g": state.ctl.g, "packets_seen": state.ctl.packets_seen,
            "epoch": state.ctl.epoch, "wavelengths": state.wavelengths,
            "prev_active": state.prev_active}


def fault_frame(rng: np.random.RandomState, t: int, c: int, g: int) -> dict:
    """A numpy-made fault frame: one dead slot window, one stuck-on cell
    and a loss-drift ramp."""
    ok = np.ones((t, c, g), np.float32)
    ok[20:45, 1, 0] = 0.0
    ok[rng.rand(t, c, g) < 0.02] = 0.0
    stuck = np.zeros((t, c, g), np.float32)
    stuck[10:80, 2, g - 1] = 1.0
    drift = np.clip(0.02 * np.arange(t) - 0.5, 0.0, 1.2).astype(np.float32)
    return {"gw_ok": ok, "stuck_on": stuck, "drift_db": drift}


def epoch_work(n, t, c, g, b, dest: bool) -> tuple:
    """(bytes read once + written once, float ops) of one epoch_step call
    without faults. Written per lane-interval: the six scalars the records
    need (latency, power, laser, reconfiguration energy, mean inter-chiplet
    latency, saturated) and g_eff, gw_load per chiplet; per lane the final
    g. Read: ext, intra, mem, t_mask, dest per trace; lane_trace, the five
    knobs and g0 per lane; the two selection-table rows."""
    f = 4
    read = (2 * n * t * c + 2 * n * t + (n * c * c if dest else 0)) * f \
        + b * (4 + 5 * f + c * f) + 2 * g * f
    written = b * t * (6 + 2 * c) * f + b * c * f
    ops = b * t * (OPS_PER_LANE + c * OPS_PER_CHIPLET
                   + (c * c * OPS_PER_PAIR if dest else 0)
                   + c * g * OPS_PER_SLOT)
    return read + written, ops


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script measures the port on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print(f"chip_smoke: the port's sources are missing ({SRC}); run "
              f"from the root of a checkout", file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))

    from repro_torch import backend
    from repro_torch import figures
    from repro_torch.core import simulator as sim_mod
    from repro_torch.core import traffic
    from repro_torch.kernels.epoch_step import ops
    from repro_torch.kernels.epoch_step.ref import epoch_run_reference
    from repro_torch.core.simulator import (Arch, SimConfig, epoch_inputs,
                                            sweep_batch)

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # --- 1. card and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("1", f"device {kind} x{count}; torch {torch.__version__} cuda "
             f"{torch.version.cuda}")
    t0 = time.perf_counter()
    ops.build()
    build_s = time.perf_counter() - t0
    log = backend.build_log(ops.NAME) or ""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
    if not regs:
        fail("no ptxas register report in the build log")
    say("1", f"built {ops.NAME} in {build_s:.2f} s "
             f"(builds this run: {backend.COUNTERS['builds']}); ptxas: "
             f"{len(regs)} kernel variants, registers {min(regs)}-"
             f"{max(regs)}, spill bytes max {max(spills or [0])}")

    # --- 2. kernel against plain on the card -------------------------------
    rng = np.random.RandomState(2026)
    apps = traffic.APP_NAMES
    clean = [traffic.generate_trace(a, T_INTERVALS, 100 + i, device=dev)
             for i, a in enumerate(apps)]
    with_dest = traffic.all_app_traces(T_INTERVALS, seed=5, dest=True,
                                       device=dev)
    with_dest = [with_dest[a] for a in apps]
    ragged = [traffic.generate_trace(a, t, 200 + i, device=dev)
              for i, (a, t) in enumerate(zip(apps[:4], (100, 73, 41, 100)))]
    ragged[3] = dict(ragged[3], t_mask=torch.zeros(T_INTERVALS, device=dev))
    cfg = SimConfig().cfg
    faulted = [dict(tr, **{k: torch.as_tensor(v, device=dev) for k, v in
                           fault_frame(rng, T_INTERVALS, cfg.n_chiplets,
                                       cfg.max_gateways_per_chiplet).items()})
               for tr in with_dest[:4]]
    knob_grid = {
        "l_m": rng.uniform(0.004, 0.032, 64).astype(np.float32),
        "max_gateways": rng.randint(2, 5, 64).astype(np.int32),
        "min_gateways": rng.randint(1, 3, 64).astype(np.int32),
        "buffer_sat": rng.uniform(0.45, 0.95, 64).astype(np.float32),
        "wavelengths": rng.randint(2, 9, 64).astype(np.int32)}
    cases = [("clean", clean, Arch.RESIPI, {}),
             ("clean-all-gateways", clean, Arch.RESIPI_ALL, {}),
             ("dest", with_dest, Arch.RESIPI, {}),
             ("ragged+all-masked", ragged, Arch.RESIPI, {}),
             ("faults", faulted, Arch.RESIPI, {}),
             ("faults-all-gateways", faulted, Arch.RESIPI_ALL, {}),
             ("sweep-64", with_dest[:1], Arch.RESIPI, knob_grid)]
    max_err = 0.0
    for name, traces, arch, grid in cases:
        sim = SimConfig().with_arch(arch)
        state0, xs, tables, kw = epoch_inputs(traces, sim, device=dev,
                                              **grid)
        got_state, got = ops.epoch_run(state0, xs, sim, tables, **kw)
        torch.cuda.synchronize()
        want_state, want = epoch_run_reference(state0, xs, sim, tables,
                                               **kw)
        torch.cuda.synchronize()
        err = compare(got, want, name)
        err = max(err, compare(state_fields(got_state),
                               state_fields(want_state), name + " state"))
        if name.startswith("ragged"):
            # The all-masked lane returns its input carry untouched.
            lane = state_fields(got_state)
            for k, v in state_fields(state0).items():
                if not torch.equal(lane[k][3], v[3]):
                    fail(f"all-masked lane changed its carry ({k})")
        max_err = max(max_err, err)
        say("2", f"{name}: {int(kw['lane_trace'].shape[0])} lanes x "
                 f"{xs[0].shape[1]} intervals, kernel == plain "
                 f"(max abs err {err:.3g})")

    # --- 3. the paper (main path starts here) ------------------------------
    # Every main-path call of the kernel wrapper is kept with its inputs and
    # outputs, and held against the plain version after the main path.
    calls = []
    kernel_epoch_run = ops.epoch_run

    def recorded_epoch_run(state, xs, sim, tables, **kw):
        out = kernel_epoch_run(state, xs, sim, tables, **kw)
        calls.append((phase, state, xs, sim, tables, kw, out))
        return out

    ops.epoch_run = recorded_epoch_run
    phase = "fig11"
    sim_mod.reset_engine_stats()
    traces11 = traffic.all_app_traces(T_INTERVALS, seed=1, device=dev)
    f11 = figures.fig11_main(traces11, device=dev)
    means = {arch: {m: float(np.mean([f11["per_app"][a][arch][m]
                                      for a in apps]))
                    for m in ("mean_latency", "mean_power_mw",
                              "mean_energy")}
             for arch in ("resipi", "resipi_all", "prowaves", "awgr")}
    for arch, m in means.items():
        say("3", f"fig11 {arch:10s} latency {m['mean_latency']:.4f} "
                 f"power {m['mean_power_mw']:.4f} mW energy "
                 f"{m['mean_energy']:.4f}")
    s = f11["summary"]
    deltas = {"latency": s["latency_reduction_vs_prowaves"],
              "power": s["power_reduction_vs_prowaves"],
              "energy": s["energy_reduction_vs_prowaves"]}
    say("3", "fig11 ReSiPI vs PROWAVES: " + ", ".join(
        f"{k} -{v:.1%}" for k, v in deltas.items())
        + " (paper -37% / -25% / -53%)")
    for k, v in deltas.items():
        if not 0.10 <= v <= 0.70:
            fail(f"fig11 {k} reduction vs PROWAVES {v:.3f} outside "
                 f"[0.10, 0.70]")
    phase = "fig10"
    traces10 = traffic.all_app_traces(60, seed=7, device=dev)
    f10 = figures.fig10_dse([traces10[a] for a in apps], device=dev)
    say("3", f"fig10 L_m selected {f10['l_m_selected']:.4f} (paper "
             f"0.0152), {f10['n_accepted']} points in the 10% band")
    phase = "fig12"
    gen = torch.Generator().manual_seed(3)
    seq = traffic.concat_traces([
        traffic.generate_trace(a, T_INTERVALS, gen, device=dev)
        for a in figures.FIG12_SEQUENCE])
    f12 = figures.fig12_adaptivity(seq, per_app=T_INTERVALS, device=dev)
    say("3", f"fig12 settle after switches: ReSiPI "
             f"{f12['adaptation']['resipi_settle']}, PROWAVES "
             f"{f12['adaptation']['prowaves_settle']} (paper ~3 / ~5); "
             f"max gateways {f12['max_gateways_used']} (paper 18)")
    for k in ("latency_resipi", "power_resipi", "latency_prowaves"):
        if not np.all(np.isfinite(f12[k])) or len(f12[k]) != 3 * T_INTERVALS:
            fail(f"fig12 {k} malformed")

    # --- 4. full-size DSE (main path, then timing) -------------------------
    dse_traces = traffic.all_app_traces(T_INTERVALS, seed=11, dest=True,
                                        device=dev)
    dse_traces = [dse_traces[a] for a in apps]
    lm, bs = np.meshgrid(np.linspace(0.004, 0.032, 64, dtype=np.float32),
                         np.linspace(0.5, 0.95, 64, dtype=np.float32),
                         indexing="ij")
    grid = {"l_m": lm.ravel(), "buffer_sat": bs.ravel()}
    sim = SimConfig().with_arch(Arch.RESIPI)
    phase = "dse"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dse = sweep_batch(dse_traces, sim, device=dev, **grid)
    torch.cuda.synchronize()
    dse_s = time.perf_counter() - t0
    stats = sim_mod.engine_stats()           # main path ends here
    ops.epoch_run = kernel_epoch_run
    lanes = len(apps) * lm.size
    expected = 2 * len(apps) + 1 + 1 + 1     # fig11, fig10, fig12, DSE
    say("4", f"DSE sweep_batch: {lanes} lanes x {T_INTERVALS} intervals "
             f"in {dse_s:.3f} s (entry point, host clock); max memory "
             f"allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    say("4", f"engine_stats after the main path: {json.dumps(stats)}")
    if stats["epoch_step_launches"] != expected:
        fail(f"main path launched epoch_step {stats['epoch_step_launches']} "
             f"times, expected {expected}")
    summ = dse["summary"]
    if dse["records"]["g"].shape != (len(apps), lm.size, T_INTERVALS,
                                     cfg.n_chiplets):
        fail(f"DSE records shape {tuple(dse['records']['g'].shape)}")
    for k, v in summ.items():
        if not torch.isfinite(v).all():
            fail(f"DSE summary {k} not finite")
    # Every kernel call of the main path against the plain version on the
    # same inputs: records and final state.
    if len(calls) != expected:
        fail(f"recorded {len(calls)} kernel-wrapper calls, expected "
             f"{expected}")
    checked = {}
    for name, state0, xs, csim, tables, kw, (got_state, got) in calls:
        want_state, want = epoch_run_reference(state0, xs, csim, tables,
                                               **kw)
        what = f"main path {name} {csim.arch.value}"
        err = max(compare(got, want, what),
                  compare(state_fields(got_state), state_fields(want_state),
                          what + " state"))
        max_err = max(max_err, err)
        n, e = checked.get(name, (0, 0.0))
        checked[name] = (n + 1, max(e, err))
    say("4", "main-path kernel calls == plain version on their own inputs: "
             + ", ".join(f"{k} {n} call(s) max abs err {e:.3g}"
                         for k, (n, e) in checked.items()))
    _, state0, xs, sim, tables, kw, _ = calls[-1]        # the DSE call
    if kw["lane_trace"].shape[0] != lanes:
        fail("the last main-path kernel call is not the DSE")
    del calls

    # Kernel time: median of 5 launches after warm-up, CUDA events.
    g0 = state0.ctl.g
    run = lambda: ops.launch(g0, xs, sim, tables, **kw)  # noqa: E731
    time_cuda(run, 2)
    ms = float(np.median(time_cuda(run, 5)))
    plain_ms = time_cuda(
        lambda: epoch_run_reference(state0, xs, sim, tables, **kw), 1)[0]
    n_tr, t_len, c = xs[0].shape
    nbytes, nops = epoch_work(n_tr, t_len, c, cfg.max_gateways_per_chiplet,
                              lanes, dest=True)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS_PER_S * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    say("4", f"epoch_step kernel: median {ms:.4f} ms over 5 runs, "
             f"{lanes * T_INTERVALS / (ms * 1e-3):.4g} lane-intervals/s; "
             f"plain version {plain_ms:.2f} ms once; bound {bound_ms:.4f} "
             f"ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
             f"{nops / 1e9:.2f} GFLOP); card: {card}")
    # The same DSE through the entry point again, now warm (host clock).
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        sweep_batch(dse_traces, sim, device=dev, **grid)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    say("4", f"DSE sweep_batch warm: median {np.median(warm):.4f} s of 3 "
             f"(host clock; kernel share {ms * 1e-3 / np.median(warm):.1%})")

    # --- 5. kernels line ----------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": ops.NAME, "route": "cuda",
        "source": "src/repro_torch/kernels/epoch_step/csrc/epoch_step.cu",
        "replaces": "src/repro/kernels/epoch_step/kernel.py:48",
        "launches": stats["epoch_step_launches"],
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
