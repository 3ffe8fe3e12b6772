#!/usr/bin/env python3
"""Drive the PyTorch port of the ReSiPI simulator on one NVIDIA card.

Run from the repository root on a machine with a CUDA card, the CUDA
toolkit (nvcc) and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds every kernel of the port's main paths from the sources in the
checkout (`epoch_step`, `noc_step`, `flash_attention` and `ssd_scan`, one
nvcc each, started together), holds each kernel against its plain PyTorch
version on the card, drives the main paths through the entry points a user
calls, and measures the kernels. Phases (one line per step; any failure
exits non-zero):

  1. card and build: nvidia-smi name and power limit, build seconds and the
     ptxas register / shared memory / spill report of each kernel, and per
     design of the two simulator kernels (epoch_step "split" and "warp",
     noc_step "node" and "warp"), naming any instantiation that spills;
  2. epoch_step against plain on the card at the Table-1 widths, T = 100,
     both designs on each case (the wrapper runs "split"; "warp" is forced
     on the same inputs): clean, destination matrices, a ragged t_mask
     batch with an all-masked lane, a fault frame, and a 64-point sweep
     over the five kernel knobs (rtol = atol = 1e-6, integer g and boolean
     saturation exact); noc_step against plain (rtol 1e-5, atol 1e-3) on
     the cases of `kernels/noc_step/cases.py` (the card tests run them at a
     smaller T), the "node" kernel the wrapper runs and the "warp" kernel
     bit for bit equal on each: Fig. 13's two topologies at 8192 cycles, a
     padded topology with garbage in its dead lanes (exactly 0 out), a
     lane dying mid-run (final occupancy exactly 0), an all-ones
     valid_mask_t (bitwise the static run), a ragged t_mask, hex_config(2),
     and a batch of mixed-T runs (bitwise the runs one by one);
     flash_attention and ssd_scan against plain on the cases of
     `kernels/flash_attention/cases.py` and `kernels/ssd_scan/cases.py`
     (float32 and bfloat16, causal and not, head dims 16-128, S 1-2049;
     d_state 16-128, chunks 32-128, one and two groups, ragged L, initial
     states), each through its wrapper, which picks the tensor-core
     (`wgmma`) or SIMT kernel by dtype and shape; each case prints the
     kernel that ran (read from the launch counters);
  3. the paper through the port's own generator: Fig. 11 (8 PARSEC apps x
     4 architectures), Fig. 10 (L_m), Fig. 12 (settle times) and Fig. 13
     (residency maps, arrivals from the threefry twin at seed 5, held to
     the reference's values);
  4. two full-size DSEs: RESIPI `sweep_batch` over 8 PARSEC apps with
     destination matrices x a 64 x 64 (l_m x buffer_sat) grid at T = 100
     (32 768 lanes), and one `noc_run` over 512 flit-level runs (mesh radix
     {4, 8} x g {1..4} x W {2, 16} x 32 loads, padded to 68 nodes, 8192
     cycles); then the main path's kernel variants are read (19
     epoch_step:split, 3 noc_step:node), every kernel call of phases 3 and
     4 is held against the plain version on its own inputs and each
     noc_step call against the warp kernel bit for bit; both designs of
     each simulator kernel are timed on the same inputs, per launch shape
     (epoch_step on one call of each of its launch shapes: the DSE, Fig.
     10, a RESIPI and a RESIPI_ALL lane of Fig. 11 and Fig. 12, device time
     by CUDA-graph replays and the wrapper call; noc_step on the DSE and
     both Fig. 13 calls, in turns), each beside its bound, with the plain
     versions' time, the epoch entry point's warm host time, its host
     stages and its profiled device breakdown, and a per-cycle probe of
     noc_step: nodes a thread, traffic load, and two A/B builds of its
     source (NOC_AB: the node kernel without, the warp kernel with the
     zero-numerator guard on its division, built beside the kernels in
     phase 1 and held bitwise to them);
  5. LLM serving, the second main path, through `get_model(cfg)`,
     `prefill` and `decode_step`: (a) zamba2-7b at full width and depth
     (81 layers, 6.75 B parameters drawn on the card from a seeded
     generator, float32 as the reference keeps them), a batch of 4 prompts
     x 2048 tokens (max_len 2064), then 16 greedy decode steps; (b)
     mamba2-130m, 8 x 2048, then 16 steps. Every ssd_scan and
     flash_attention launch of those runs is held against its plain
     version on its own inputs (inline), the launches are counted (81 + 13
     and 24, every one of them the tensor-core kernel: the prefill runs in
     bf16), and the whole prefill's logits against the same prefill with
     the plain ops (held in float32 compute; in bf16, where rounding noise
     dominates these random-weight models at full depth, shown beside the
     bf16 prefill's own distance from float32); then the kernels' times at
     the main-path shapes (the tensor-core kernel, and the SIMT kernel on
     the same inputs for information), the plain versions', SDPA's for
     flash, each kernel's bound (SSD's at the tensor-core peak, with its
     figure at the float32 peak beside it), prefill and
     decode tokens/s and peak memory, and (information only) zamba2's
     decode-vs-prefill consistency;
  6. a `kernels` JSON line (launches on the main paths, error against
     plain, times, the bound and the kernel variant that ran) for all four
     kernels; the simulator kernels' entries add the first design's time
     in the same run (`warp_ms`) and the times per launch shape
     (`shapes`).

Phases 3 and 4 are the first main path: the launch counters are zeroed
before phase 3 and read after the last DSE, before any check or timing.
Each LLM run of phase 5 is a main path of its own, with the counters zeroed
just before its prefill and read just after its last decode step.
The last line is {"ok": true, "device": {...}}. Without a card, or without
the rest of the repository beside this file, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import ctypes
import json
import re
from concurrent.futures import ThreadPoolExecutor
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
# noc_step against plain: the in-edge sums run in another order than the
# plain version's products (ulp noise that accumulates over the cycles);
# the reference's own bound for this kernel is rtol 1e-4, atol 1e-2.
NOC_RTOL, NOC_ATOL = 1e-5, 1e-3
# Float operations of the noc_step kernel per node-cycle, counted from its
# source: arrivals add, mask, link-rate min, router mask (4); the in-edge
# sum of send (one add per node on average: every node has one out-edge);
# space sub and max, want > 0, max with 1e-9, division, min with 1 (6);
# moved (1); the in-edge sum of moved (1); land: sub, mask mul, add, drain
# min, sub (5); t_mask freeze of occ, residency and drained (8).
OPS_PER_NODE_CYCLE = 26
NOC_CYCLES = 8192
# A/B builds of noc_step.cu for the per-cycle breakdown: the node kernel
# without its zero-numerator guard on space / want, the warp kernel with
# it; each is the checked-out source with one expression replaced (both
# stay bitwise equal to the kernels as built).
NOC_AB = {
    "node-unguarded": ("fminf(1.f, fdiv_guarded(space, fmaxf(want, 1e-9f)))",
                       "fminf(1.f, space / fmaxf(want, 1e-9f))"),
    "warp-guarded": ("fminf(1.f, space / fmaxf(want, 1e-9f))",
                     "fminf(1.f, fdiv_guarded(space, fmaxf(want, 1e-9f)))")}
DSE_RADIX, DSE_G, DSE_W = (4, 8), (1, 2, 3, 4), (2, 16)
DSE_LOADS = np.linspace(0.02, 0.64, 32)
DSE_PAD = 8 * 8 + 4                           # mesh radix 8 plus 4 sinks
# Dense bf16 tensor-core peak. Flash's and SSD's bf16 main-path launches run
# their products on the tensor cores (SSD's float32 factors split into bf16
# terms), so their bound is at this rate; SSD's bound at the float32 peak
# (what its SIMT kernel's arithmetic is held to) is printed beside it, so
# the row reads the same work whatever implements it.
BF16_FLOPS_PER_S = 989e12
# LLM serving (phase 5): (arch, batch, prompt tokens, decode steps).
LLM_RUNS = (("zamba2-7b", 4, 2048, 16), ("mamba2-130m", 8, 2048, 16))
LLM_SEED = 2026
# Bound of the whole prefill's logits against the same prefill with the
# plain ops, in relative RMS, with float32 compute. In bf16 these
# random-weight models at full depth are dominated by rounding noise: every
# layer adds some to the residual stream and it persists, so on an H100
# the plain bf16 prefill lands tens of percent from the float32 one, and
# two bf16 prefills whose floats differ in the last bits part by about as
# much (phase 5 prints both); no bf16 bound can hold there. In float32 the
# kernel and plain prefills part by under 1e-3 at the logits.
PREFILL_F32_REL_TOL = 5e-3


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


def time_graph(fn, reps: int = 5) -> float:
    """Median device milliseconds of `fn`'s launches alone: `fn` captured
    once into a CUDA graph (after a warm-up call), the graph replayed
    `reps` times between CUDA events. Unlike `time_cuda` around the call,
    no host work of the wrapper (argument checks, allocations) sits between
    the events, so a launch shorter than its wrapper's host time is timed
    as the device runs it."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    return float(np.median(time_cuda(graph.replay, reps)))


def ptxas_entries(log: str) -> list:
    """(entry function, registers, spill bytes stored + loaded) for each
    kernel of a `ptxas -v` report."""
    out = []
    for part in log.split("Compiling entry function")[1:]:
        name = part.split("'")[1]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        out.append((name, int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) + int(spill.group(2)) if spill
                    else 0))
    return out


def template_args(mangled: str) -> str:
    """The integer and bool template arguments of a mangled kernel name,
    in order ("4,1,0,1" for <4, true, false, true>)."""
    m = re.search(r"_kernelI(.*?)EEv", mangled)
    return ",".join(re.findall(r"L[ib](\d+)E", m.group(1) + "E")) if m \
        else "?"


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


def noc_work(prep: dict, t_mask_passed: bool, max_in: int) -> tuple:
    """(bytes read once + written once, float ops) that one noc_run call
    must move and compute, from `prepare`'s output, counted from what this
    call's data needs. Read: arrivals (and the time-varying mask, when
    given) in live lanes only (static mask != 0: a dead lane's arrivals
    only ever meet a zero factor), t_mask [B, T] only when the caller
    passes one, and the mask, drain, buffer and next hop [B, R] and the
    in-edge lists [B, R, max_in] of every lane (a dead lane's buffer still
    scales a sender routed into it); written: residency, final occupancy
    and drained [B, R]. Operations: OPS_PER_NODE_CYCLE per live
    node-cycle. The kernel itself reads every lane and the all-ones t_mask
    the wrapper fills in: more than this."""
    f = 4
    b, t, r = prep["arrivals"].shape
    live = int((prep["mask"] != 0).sum())
    planes = 1 + (prep["mask_t"] is not None)
    read = (planes * live * t + (b * t if t_mask_passed else 0)
            + b * r * (4 + max_in)) * f
    written = 3 * b * r * f
    return read + written, live * t * OPS_PER_NODE_CYCLE


def noc_compare(got, want, what: str) -> float:
    """Max abs error of (residency, occupancy, drained) at the noc_step
    tolerance; fails on non-finite values or a miss."""
    worst = 0.0
    for name, a, b in zip(("residency", "occupancy", "drained"), got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{what}: {name} malformed ({tuple(a.shape)})")
        err = float((a - b).abs().max()) if a.numel() else 0.0
        if not torch.allclose(a, b, rtol=NOC_RTOL, atol=NOC_ATOL):
            fail(f"{what}: {name} max abs err {err:g} beyond rtol "
                 f"{NOC_RTOL} atol {NOC_ATOL}")
        worst = max(worst, err)
    return worst


def noc_bitwise(node, warp, what: str) -> None:
    """The node kernel's (residency, occupancy, drained) must be the warp
    kernel's bit for bit: the same products summed in the same order."""
    for name, a, b in zip(("residency", "occupancy", "drained"), node, warp):
        if not torch.equal(a, b):
            fail(f"{what}: node kernel {name} differs from the warp kernel "
                 f"(max abs {float((a - b).abs().max()):.3g}; must be 0)")


def sweep_host_stages(sim_mod, ops, traces, sim, dev, grid) -> dict:
    """Information: host-clock milliseconds of the stages of one warm
    `sweep_batch` call, as `simulator._run` runs them, each stage ended by
    a synchronize (median of 3): stacking the traces, `epoch_inputs`, the
    kernel wrapper's launch, `_reassemble`, the summaries."""
    names = ("stack_traces", "epoch_inputs", "launch", "_reassemble",
             "summaries")
    stages = {k: [] for k in names}
    for _ in range(3):
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        batch = sim_mod.stack_traces(list(traces), pad=True)
        mark()
        state0, xs, tables, kw = sim_mod.epoch_inputs(
            batch, sim, device=dev, faults=False, **grid)
        mark()
        out = ops.launch(state0.ctl.g, xs, sim, tables, **kw)
        mark()
        _, recs = ops._reassemble(state0, out, xs, sim, kw["faulted"])
        mark()
        sim_mod._summary_from_sums(sim_mod._record_sums(
            recs, xs[4][kw["lane_trace"]]), sim.cfg.n_chiplets)
        mark()
        for name, a, b in zip(names, marks, marks[1:]):
            stages[name].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in stages.items()}


def build_noc_ab(backend, nops, name: str):
    """Build the NOC_AB variant `name` of noc_step.cu into build/ab/<name>
    and return its library (bind it with `nops.build()`'s argtypes)."""
    src = nops.SOURCE.read_text()
    old, new = NOC_AB[name]
    if src.count(old) != 1:
        fail(f"noc_step.cu holds {src.count(old)} copies of the A/B "
             f"expression {old!r}, expected 1")
    where = backend.BUILD_DIR.parent / "ab" / name
    where.mkdir(parents=True, exist_ok=True)
    (where / "noc_step.cu").write_text(src.replace(old, new))
    return backend.build_library(f"noc_step-{name}", where / "noc_step.cu")


def noc_cycle_probe(nops, prep: dict, runs: list, ab_libs: dict,
                    card: str) -> None:
    """Information: what one simulated cycle costs each noc_step design,
    from slices of the DSE's prepared inputs (CUDA events, median of 5),
    with the A/B builds beside (NOC_AB: node without, warp with the
    zero-numerator guard; each held bitwise to its kernel). (a) The DSE's
    256 radix-4 runs (at most 20 live nodes) at the DSE's 68-node width
    and cut to 20 nodes: the warp kernel then runs 3 and 1 nodes a thread
    on the same live work; the node kernel is the same either way. (b) One
    radix-8 run (g 4, W 16) at the lowest and at the highest DSE load: how
    the cost of a cycle depends on the traffic. (c) The whole DSE."""
    def sub(idx, width):
        out = {"link_rate": prep["link_rate"], "mask_t": None,
               "t_mask": prep["t_mask"][idx].contiguous(),
               "r_active": prep["r_active"][idx].contiguous(),
               "in_src": prep["in_src"][idx][:, :width].contiguous()}
        for k in ("arrivals", "mask", "next_hop", "drain", "buf"):
            out[k] = prep[k][idx][..., :width].contiguous()
        return out

    dev = prep["arrivals"].device
    radix4 = torch.tensor([i for i, x in enumerate(runs) if x[0] == 4],
                          device=dev)
    lo, hi = (runs.index((8, 4, 16, load))
              for load in (DSE_LOADS[0], DSE_LOADS[-1]))
    probes = {"256 radix-4 runs at 68 nodes": sub(radix4, DSE_PAD),
              "256 radix-4 runs cut to 20 nodes": sub(radix4, 20),
              f"1 radix-8 run at {DSE_LOADS[0]:.2f} pkts/cycle":
                  sub(torch.tensor([lo], device=dev), DSE_PAD),
              f"1 radix-8 run at {DSE_LOADS[-1]:.2f} pkts/cycle":
                  sub(torch.tensor([hi], device=dev), DSE_PAD),
              f"the DSE ({len(runs)} runs)": prep}
    kernel_build = nops.build
    designs = (("node", "node", kernel_build()),
               ("warp", "warp", kernel_build()),
               ("node-unguarded", "node", ab_libs["node-unguarded"]),
               ("warp-guarded", "warp", ab_libs["warp-guarded"]))
    for label, p in probes.items():
        cyc = p["arrivals"].shape[1]
        got, outs = {}, {}
        for name, kern, lib in designs:
            nops.build = lambda: lib                 # noqa: B023
            try:
                run = lambda: nops.run_prepared(p, kernel=kern)  # noqa
                outs[name] = run()
                time_cuda(run, 2)
                got[name] = float(np.median(time_cuda(run, 5)))
            finally:
                nops.build = kernel_build
        noc_bitwise(outs["node-unguarded"], outs["node"], label + " (A/B)")
        noc_bitwise(outs["warp-guarded"], outs["warp"], label + " (A/B)")
        say("4", f"noc_step cycle probe, {label}: " + ", ".join(
            f"{name} {got[name]:.4f} ms ({got[name] * 1e6 / cyc:.1f} ns a "
            f"cycle)" for name, _, _ in designs)
            + f"; warp runs {-(-p['arrivals'].shape[2] // 32)} node(s) a "
              f"thread; card: {card}")


def flash_work(b, s, h, d, in_bytes, causal=True) -> tuple:
    """(bytes read once + written once, flops) of one attention call:
    q, k, v read and o written in the inputs' type; two products of
    2 d flops per (query, key) pair the mask keeps."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4 * b * s * h * d * in_bytes, 4 * d * pairs * b * h


def ssd_work(b, nc, q, h, p, g, n, in_bytes) -> tuple:
    """(bytes read once + written once, float ops) of one intra-chunk
    call. Read: x, B, C (grouped, in their type), dt and a (float32);
    written: y_intra and the chunk states (float32). Ops per (batch,
    chunk, head): for each of the Q(Q+1)/2 kept pairs 2P for y plus 5 for
    the weight (difference, clamp, exp, two products); 2QPN for the state
    plus QP for x * decay and 4Q for the cumsum and the decay to the end;
    per (batch, chunk, group) 2N per pair for the C B^T scores."""
    pairs = q * (q + 1) // 2
    nbytes = (b * nc * q * h * p + 2 * b * nc * q * g * n) * in_bytes \
        + (b * nc * q * h + h) * 4 \
        + (b * nc * q * h * p + b * nc * h * p * n) * 4
    ops = b * nc * (h * (pairs * (2 * p + 5) + 2 * q * p * n + q * p + 4 * q)
                    + g * 2 * n * pairs)
    return nbytes, ops


def device_breakdown(fn, label: str, top: int = 6, phase: str = "5"):
    """Information: one call of `fn` under torch.profiler; prints its host
    wall time, the summed device time of its kernels, the device's busy
    share (kernels run one at a time on one stream) and the kernels that
    take the most device time. Returns (wall seconds, {kernel: device
    microseconds}), or None when the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            kernels[e.key] = kernels.get(e.key, 0.0) + us
    except Exception as e:                   # information only
        say(phase, f"{label}: device breakdown not measured ({e!r})")
        return None
    busy = sum(kernels.values()) / 1e6
    if busy <= 0:
        say(phase, f"{label}: device breakdown not measured (the profiler "
                   f"recorded no device time)")
        return None
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    say(phase, f"{label}: wall {wall * 1e3:.2f} ms, kernels {busy * 1e3:.2f} "
             f"ms on the device (busy {busy / wall:.1%}, idle "
             f"{1 - busy / wall:.1%}; profiled, so slower than untraced); "
             f"top: " + "; ".join(f"{k[:48]} {v / 1e3:.3f} ms "
                                  f"({v / 1e6 / busy:.1%})"
                                  for k, v in ranked))
    return wall, kernels


def launched_variants(before: dict, after: dict) -> str:
    """The kernel variants launched between two snapshots of
    `backend.COUNTERS["variants"]` ("wgmma", "simt", or both)."""
    ran = sorted({k.split(":")[1] for k, v in after.items()
                  if v != before.get(k, 0)})
    if not ran:
        fail("no kernel variant was launched")
    return "+".join(ran)


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp(min=1e-30))


def llm_checked_ops(fops, sops, flash_ref, ssd_ref, errs: dict,
                    first: dict):
    """Wrappers for the two kernel ops that hold every call against the
    plain version on its own inputs right after it (float32 outputs at
    the cases' bounds; a bf16 attention output at 3e-2), and keep the
    first call's inputs for timing."""
    kernel_flash, kernel_intra = fops.flash_attention, sops.ssd_intra_chunk

    def flash(q, k, v, *, causal=True):
        out = kernel_flash(q, k, v, causal=causal)
        want = flash_ref(q, k, v, causal=causal)
        tol = 2e-5 if q.dtype == torch.float32 else 3e-2
        if not torch.allclose(out.float(), want.float(), rtol=tol, atol=tol):
            fail(f"main path flash_attention launch {tuple(q.shape)} "
                 f"differs from plain (max abs err "
                 f"{float((out.float() - want.float()).abs().max()):.3g})")
        errs["flash"] = max(errs.get("flash", 0.0), float(
            (out.float() - want.float()).abs().max()))
        first.setdefault("flash", (q, k, v, causal))
        return out

    def intra(x, dt, a, b_in, c_in):
        out = kernel_intra(x, dt, a, b_in, c_in)
        want = ssd_ref(x, dt, a, b_in, c_in)
        tol = 2e-4 if x.shape[2] >= 128 else 1e-4
        for name, u, w in zip(("y_intra", "states"), out, want):
            if not torch.allclose(u, w, rtol=tol, atol=tol):
                fail(f"main path ssd_scan launch {tuple(x.shape)}: {name} "
                     f"differs from plain (max abs err "
                     f"{float((u - w).abs().max()):.3g})")
            errs["ssd"] = max(errs.get("ssd", 0.0),
                              float((u - w).abs().max()))
        first.setdefault("ssd", (x, dt, a, b_in, c_in))
        return out

    return flash, intra


def serve_llms(dev, card: str, fops, sops, llm_err: dict) -> list:
    """Phase 5: the LLM serving main paths (LLM_RUNS), then the two LLM
    kernels' timings; returns their rows of the `kernels` line."""
    from repro_torch import backend
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import reference_attention
    from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.models.params import count_params, init_params

    def flash_ref(q, k, v, *, causal=True):
        return reference_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2),
                                   causal=causal).transpose(1, 2)

    launches_total: dict = {}
    timing_inputs: dict = {}
    for arch, batch, prompt, steps in LLM_RUNS:
        cfg = get_config(arch)
        model = get_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(LLM_SEED)
        t0 = time.perf_counter()
        params = init_params(model.spec(), gen, dev)
        toks = torch.randint(0, cfg.real_vocab, (batch, prompt), device=dev,
                             generator=gen)
        torch.cuda.synchronize()
        say("5", f"{arch}: {count_params(model.spec()) / 1e9:.4g} B "
                 f"parameters drawn on the card in "
                 f"{time.perf_counter() - t0:.2f} s (float32, "
                 f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                 f"allocated)")
        max_len = prompt + steps
        errs: dict = {}
        first: dict = {}
        flash, intra = llm_checked_ops(fops, sops, flash_ref,
                                       reference_intra_chunk, errs, first)
        kernel_flash, kernel_intra = fops.flash_attention, \
            sops.ssd_intra_chunk
        fops.flash_attention, sops.ssd_intra_chunk = flash, intra
        try:
            backend.reset_counters()              # main path starts here
            caches, logits = model.prefill(params, {"tokens": toks},
                                           max_len)
            prefill_logits = logits
            for _ in range(steps):
                nxt = logits[:, :cfg.real_vocab].argmax(-1, keepdim=True)
                logits, caches = model.decode_step(params, nxt, caches)
            torch.cuda.synchronize()
            launches = dict(backend.COUNTERS["launches"])  # ... ends here
            variants = dict(backend.COUNTERS["variants"])
        finally:
            fops.flash_attention, sops.ssd_intra_chunk = kernel_flash, \
                kernel_intra
        n_flash = cfg.n_layers // cfg.attn_every \
            if cfg.family == "hybrid" else 0
        expected = {"ssd_scan": cfg.n_layers}
        if n_flash:
            expected["flash_attention"] = n_flash
        if launches != expected:
            fail(f"{arch}: main path launched {launches}, expected "
                 f"{expected}")
        # Every bf16 launch of the prefill goes through the tensor cores.
        want_variants = {f"{k}:wgmma": v for k, v in expected.items()}
        if variants != want_variants:
            fail(f"{arch}: main path launched the variants {variants}, "
                 f"expected {want_variants}")
        for k, v in launches.items():
            launches_total[k] = launches_total.get(k, 0) + v
        for name in ("flash", "ssd"):
            llm_err[name] = max(llm_err[name], errs.get(name, 0.0))
        if prefill_logits.shape != (batch, cfg.vocab) or logits.shape != (
                batch, cfg.vocab):
            fail(f"{arch}: logits shape {tuple(logits.shape)}")
        for what, lg in (("prefill", prefill_logits), ("decode", logits)):
            if not torch.isfinite(lg.float()).all():
                fail(f"{arch}: {what} logits not finite")
        say("5", f"{arch}: prefill {batch} x {prompt} + {steps} greedy "
                 f"decode steps; launches {launches}, variants {variants} "
                 f"(expected); every "
                 f"launch == plain on its own inputs (max abs err "
                 + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + ")")

        # The whole prefill against the same prefill with the plain ops, on
        # the card: held in float32 compute, shown in bf16 beside the bf16
        # prefill's own distance from float32.
        del caches
        got = {(torch.bfloat16, False): prefill_logits.float()}
        for dtype, plain in ((torch.bfloat16, True), (torch.float32, False),
                             (torch.float32, True)):
            L.COMPUTE_DTYPE = dtype
            if plain:
                fops.flash_attention, sops.ssd_intra_chunk = flash_ref, \
                    reference_intra_chunk
            try:
                _, lg = model.prefill(params, {"tokens": toks}, max_len)
            finally:
                fops.flash_attention, sops.ssd_intra_chunk = kernel_flash, \
                    kernel_intra
                L.COMPUTE_DTYPE = torch.bfloat16
            got[dtype, plain] = lg.float()
        f32_k, f32_p = got[torch.float32, False], got[torch.float32, True]
        rel = rel_rms(f32_k, f32_p)
        if not (torch.isfinite(f32_k).all() and rel <= PREFILL_F32_REL_TOL):
            fail(f"{arch}: float32 prefill logits vs the plain-op prefill: "
                 f"relative RMS {rel:.3g} beyond {PREFILL_F32_REL_TOL}")
        bf_k, bf_p = got[torch.bfloat16, False], got[torch.bfloat16, True]
        say("5", f"{arch}: prefill logits == plain-op prefill in float32 "
                 f"compute (relative RMS {rel:.3g}, bound "
                 f"{PREFILL_F32_REL_TOL}; max abs diff "
                 f"{float((f32_k - f32_p).abs().max()):.3g} on logits of RMS "
                 f"{float(f32_p.pow(2).mean().sqrt()):.3g}); in bf16 "
                 f"(information) kernel vs plain {rel_rms(bf_k, bf_p):.3g}, "
                 f"the plain bf16 prefill vs float32 "
                 f"{rel_rms(bf_p, f32_p):.3g}, the kernel bf16 prefill vs "
                 f"float32 {rel_rms(bf_k, f32_p):.3g}")
        del got, f32_k, f32_p, bf_k, bf_p

        # Serving speed: prefill and decode on the host clock, synchronized.
        prefill_s, decode_s = [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            caches, logits = model.prefill(params, {"tokens": toks},
                                           max_len)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            for _ in range(steps):
                nxt = logits[:, :cfg.real_vocab].argmax(-1, keepdim=True)
                logits, caches = model.decode_step(params, nxt, caches)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t0)
            del caches
        peak = torch.cuda.max_memory_allocated() / 2**30
        p_s, d_s = float(np.median(prefill_s)), float(np.median(decode_s))
        say("5", f"{arch}: prefill {batch * prompt / p_s:.6g} tokens/s "
                 f"({p_s:.4f} s median of 3), decode "
                 f"{batch * steps / d_s:.6g} tokens/s ({d_s / steps * 1e3:.3f}"
                 f" ms a step, median of 3 runs of {steps}); peak memory "
                 f"{peak:.2f} GiB; card: {card}")

        # Where the time goes (information): one prefill, one decode step.
        caches = None

        def one_prefill():
            nonlocal caches, logits
            caches, logits = model.prefill(params, {"tokens": toks},
                                           max_len)

        def one_step():
            nonlocal caches, logits
            nxt = logits[:, :cfg.real_vocab].argmax(-1, keepdim=True)
            logits, caches = model.decode_step(params, nxt, caches)

        device_breakdown(one_prefill, f"{arch} prefill")
        device_breakdown(one_step, f"{arch} decode step")
        del caches

        if cfg.family == "hybrid":
            # Information only: prefill(S) against prefill(S - 1) and one
            # decode step (the reference's check, tests/test_models.py).
            caches, _ = model.prefill(params, {"tokens": toks[:, :-1]},
                                      max_len)
            step_logits, _ = model.decode_step(params, toks[:, -1:], caches)
            diff = step_logits.float() - prefill_logits.float()
            say("5", f"{arch}: decode-vs-prefill consistency (information): "
                     f"max abs diff {float(diff.abs().max()):.4g}, relative "
                     f"RMS {rel_rms(step_logits, prefill_logits):.4g}")
            del caches
        timing_inputs.setdefault("flash", first.get("flash"))
        timing_inputs.setdefault(("ssd", arch), first["ssd"])
        del params, logits
        torch.cuda.empty_cache()

    # Kernel times at the main-path shapes: median of 5 launches after
    # warm-up (CUDA events) of the tensor-core kernel the main path ran and
    # of the SIMT kernel on the same inputs (information), the plain
    # version's median of 3, SDPA's.
    rows = []
    q, k, v, causal = timing_inputs["flash"]
    ms = float(np.median(time_cuda(
        lambda: fops.launch(q, k, v, causal=causal), 7)[2:]))
    simt_ms = float(np.median(time_cuda(
        lambda: fops.launch(q, k, v, causal=causal, kernel="simt"), 7)[2:]))
    plain_ms = float(np.median(time_cuda(
        lambda: flash_ref(q, k, v, causal=causal), 3)))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = float(np.median(time_cuda(
        lambda: sdpa(qt, kt, vt, is_causal=causal), 7)[2:]))
    b, s_len, h, d = q.shape
    variant = fops.variant(q.dtype, d)
    nbytes, flops = flash_work(b, s_len, h, d, q.element_size(), causal)
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    bound_ms, bound_by = max((t_b, "bytes"), (t_o, "operations"))
    say("5", f"flash_attention {variant} kernel at [{b}, {s_len}, {h}, {d}] "
             f"{q.dtype}, causal: median {ms:.4f} ms (SIMT kernel "
             f"{simt_ms:.4f} ms); plain {plain_ms:.3f} ms; SDPA "
             f"{lib_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} "
             f"({flops / 1e9:.2f} GFLOP at the bf16 tensor-core peak, "
             f"{nbytes / 1e9:.3f} GB), {bound_ms / ms:.1%} of it; card: "
             f"{card}")
    rows.append({
        "name": fops.NAME, "route": "cuda", "variant": variant,
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
        "launches": launches_total.get(fops.NAME, 0),
        "max_abs_err": llm_err["flash"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "simt_ms": simt_ms})

    ssd_rows = []
    for arch, *_ in LLM_RUNS:
        x, dt, a, b_in, c_in = timing_inputs["ssd", arch]
        ms = float(np.median(time_cuda(
            lambda: sops.launch(x, dt, a, b_in, c_in), 7)[2:]))
        simt_ms = float(np.median(time_cuda(
            lambda: sops.launch(x, dt, a, b_in, c_in, kernel="simt"),
            7)[2:]))
        plain_ms = float(np.median(time_cuda(
            lambda: reference_intra_chunk(x, dt, a, b_in, c_in), 3)))
        bsz, nc, cq, h, p = x.shape
        g, n = b_in.shape[3], b_in.shape[4]
        variant = sops.variant(x.dtype, cq, p, n)
        nbytes, n_ops = ssd_work(bsz, nc, cq, h, p, g, n, x.element_size())
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms, bound_by = max((t_b, "bytes"),
                                 (n_ops / BF16_FLOPS_PER_S * 1e3,
                                  "operations"))
        f32_bound_ms = max(t_b, n_ops / F32_FLOPS_PER_S * 1e3)
        say("5", f"ssd_scan {variant} kernel, {arch} layer [B {bsz}, NC "
                 f"{nc}, Q {cq}, H {h}, P {p}, G {g}, N {n}] {x.dtype}: "
                 f"median {ms:.4f} ms (SIMT kernel {simt_ms:.4f} ms); plain "
                 f"{plain_ms:.3f} ms; no library call; bound {bound_ms:.4f} "
                 f"ms by {bound_by} ({nbytes / 1e9:.4f} GB, "
                 f"{n_ops / 1e9:.3f} GFLOP at the bf16 tensor-core peak), "
                 f"{bound_ms / ms:.1%} of it; at the float32 peak "
                 f"{f32_bound_ms:.4f} ms; card: {card}")
        ssd_rows.append((ms, plain_ms, bound_ms, bound_by, simt_ms,
                         f32_bound_ms, variant))
    ms, plain_ms, bound_ms, bound_by, simt_ms, f32_bound_ms, variant = \
        ssd_rows[0]                                      # zamba2-7b's layer
    rows.append({
        "name": sops.NAME, "route": "cuda", "variant": variant,
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:29",
        "launches": launches_total.get(sops.NAME, 0),
        "max_abs_err": llm_err["ssd"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "simt_ms": simt_ms, "bound_f32_peak_ms": f32_bound_ms})
    return rows


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
    from repro_torch import random as trandom
    from repro_torch.kernels.epoch_step import ops
    from repro_torch.kernels.epoch_step.ref import epoch_run_reference
    from repro_torch.kernels.noc_step import cases as noc_cases
    from repro_torch.kernels.noc_step import ops as nops
    from repro_torch.kernels.noc_step.ref import reference_noc_run
    from repro_torch.kernels.flash_attention import cases as flash_cases
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ssd_scan import cases as ssd_cases
    from repro_torch.kernels.ssd_scan import ops as sops
    from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk
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
    kernels = (ops, nops, fops, sops)
    with ThreadPoolExecutor(len(kernels) + len(NOC_AB)) as pool:
        # one nvcc per source, the A/B variants of noc_step.cu among them
        ab = {name: pool.submit(build_noc_ab, backend, nops, name)
              for name in NOC_AB}
        for f in [pool.submit(m.build) for m in kernels]:
            f.result()
        noc_ab_libs = {name: f.result() for name, f in ab.items()}
    build_s = time.perf_counter() - t0
    for lib in noc_ab_libs.values():
        lib.noc_step_launch.argtypes = nops.build().noc_step_launch.argtypes
        lib.noc_step_launch.restype = ctypes.c_int
    for m in kernels:
        log = backend.build_log(m.NAME) or ""
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        smem = [int(x) for x in re.findall(r"(\d+) bytes smem", log)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        if not regs:
            fail(f"no ptxas register report in the {m.NAME} build log")
        say("1", f"built {m.NAME}: ptxas {len(regs)} kernel variants, "
                 f"registers {min(regs)}-{max(regs)}, static shared memory "
                 f"max {max(smem or [0])} bytes, spill bytes max "
                 f"{max(spills or [0])}")
    say("1", f"all {len(kernels)} kernels (and {len(NOC_AB)} A/B builds of "
             f"noc_step.cu) built in {build_s:.2f} s, in parallel (builds "
             f"this run: {backend.COUNTERS['builds']})")
    for m, designs in ((ops, (("split", "epoch_recurrence_kernel"),
                              ("split", "epoch_metrics_kernel"),
                              ("warp", "epoch_step_kernel"))),
                       (nops, (("node", "noc_node_kernel"),
                               ("warp", "noc_step_kernel")))):
        entries = ptxas_entries(backend.build_log(m.NAME) or "")
        for design, kname in designs:
            got = [(template_args(e), r, sp) for e, r, sp in entries
                   if kname in e]
            if not got:
                fail(f"no ptxas report for {m.NAME}'s {kname}")
            spilled = [f"<{a}> {sp} bytes" for a, _, sp in got if sp]
            say("1", f"{m.NAME} {design}: {kname} x{len(got)} "
                     f"instantiations, registers {min(r for _, r, _ in got)}-"
                     f"{max(r for _, r, _ in got)}, spill bytes max "
                     f"{max(sp for _, _, sp in got)}"
                     + (f" (spilling: {', '.join(spilled)})" if spilled
                        else ""))
    smem = sops.build().ssd_scan_smem_bytes
    for kern, code in (("simt", 0), ("wgmma", 1)):
        for n in (64, 128):
            if smem(128, 64, n, code) != sops.smem_bytes(kern, 128, 64, n):
                fail(f"ssd_scan {kern} shared memory at N {n}: the source "
                     f"says {smem(128, 64, n, code)}, ops.smem_bytes "
                     f"{sops.smem_bytes(kern, 128, 64, n)}")
    say("1", "ssd_scan dynamic shared memory per block (wgmma / simt): "
             f"{smem(128, 64, 64, 1)} / {smem(128, 64, 64, 0)} bytes at "
             f"zamba2-7b's layer (Q 128, P 64, N 64), {smem(128, 64, 128, 1)}"
             f" / {smem(128, 64, 128, 0)} at mamba2-130m's (N 128)")

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
        before = dict(backend.COUNTERS["variants"])
        got_state, got = ops.epoch_run(state0, xs, sim, tables, **kw)
        torch.cuda.synchronize()
        ran = launched_variants(before, backend.COUNTERS["variants"])
        if ran != "split":
            fail(f"epoch_step {name}: the {ran} kernel ran, not split")
        want_state, want = epoch_run_reference(state0, xs, sim, tables,
                                               **kw)
        torch.cuda.synchronize()
        err = compare(got, want, name)
        err = max(err, compare(state_fields(got_state),
                               state_fields(want_state), name + " state"))
        # The first design ("warp") on the same inputs, held alike.
        warp_state, warp = ops._reassemble(
            state0, ops.launch(state0.ctl.g, xs, sim, tables, kernel="warp",
                               **kw), xs, sim, kw["faulted"])
        torch.cuda.synchronize()
        warp_err = max(compare(warp, want, name + " (warp kernel)"),
                       compare(state_fields(warp_state),
                               state_fields(want_state),
                               name + " state (warp kernel)"))
        if name.startswith("ragged"):
            # The all-masked lane returns its input carry untouched.
            lane = state_fields(got_state)
            for k, v in state_fields(state0).items():
                if not torch.equal(lane[k][3], v[3]):
                    fail(f"all-masked lane changed its carry ({k})")
        max_err = max(max_err, err)
        say("2", f"{name}: {int(kw['lane_trace'].shape[0])} lanes x "
                 f"{xs[0].shape[1]} intervals, {ran} kernel == plain "
                 f"(max abs err {err:.3g}; warp kernel {warp_err:.3g})")

    noc_err = 0.0
    for case in noc_cases.kernel_cases(dev, 2048, fig13_cycles=NOC_CYCLES):
        before = dict(backend.COUNTERS["variants"])
        got = nops.noc_run(*case.args, **case.kwargs)
        torch.cuda.synchronize()
        ran = launched_variants(before, backend.COUNTERS["variants"])
        if ran != "node":
            fail(f"noc_step {case.name}: the {ran} kernel ran, not node")
        want = reference_noc_run(*case.args, **case.kwargs)
        err = noc_compare(got, want, f"noc_step {case.name}")
        try:
            noc_cases.check_case(case, got, nops.noc_run)
        except AssertionError as e:
            fail(str(e))
        noc_err = max(noc_err, err)
        batched = case.args[0].dim() == 3
        warp = nops.run_prepared(nops.prepare(
            case.args[0] if batched else case.args[0][None], *case.args[1:],
            **case.kwargs), kernel="warp")
        noc_bitwise(got if batched else tuple(o[None] for o in got), warp,
                    f"noc_step {case.name}")
        say("2", f"noc_step {case.name}: {list(case.args[0].shape)} "
                 f"arrivals, {ran} kernel == plain (max abs err {err:.3g}) "
                 f"and == warp kernel bitwise")

    llm_err = {"flash": 0.0, "ssd": 0.0}
    for case in flash_cases.kernel_cases(dev):
        before = dict(backend.COUNTERS["variants"])
        got = fops.flash_attention(*case.args, causal=case.causal)
        torch.cuda.synchronize()
        ran = launched_variants(before, backend.COUNTERS["variants"])
        want = flash_cases.plain(case)
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != want.dtype or not torch.isfinite(got.float()).all() \
                or not torch.allclose(got.float(), want.float(),
                                      rtol=case.tol, atol=case.tol):
            fail(f"flash_attention {case.name}: max abs err {err:.3g} "
                 f"beyond {case.tol}")
        llm_err["flash"] = max(llm_err["flash"], err)
        say("2", f"flash_attention {case.name}: {ran} kernel == plain (max "
                 f"abs err {err:.3g}, bound {case.tol})")
    for case in ssd_cases.kernel_cases(dev):
        before = dict(backend.COUNTERS["variants"])
        y, state = ssd_cases.run_chunked(case)
        torch.cuda.synchronize()
        ran = launched_variants(before, backend.COUNTERS["variants"])
        want_y, want_state = ssd_cases.run_chunked(case, plain=True)
        inputs = ssd_cases.chunked_inputs(case)
        pairs = [("y", y.float(), want_y.float(), case.y_tol),
                 ("final state", state, want_state, case.tol)] + [
            (name, u, w, case.tol) for name, u, w in zip(
                ("y_intra", "chunk states"), sops.ssd_intra_chunk(*inputs),
                reference_intra_chunk(*inputs))]
        errs = []
        for name, u, w, tol in pairs:
            err = float((u - w).abs().max())
            if u.shape != w.shape or not torch.isfinite(u).all() \
                    or not torch.allclose(u, w, rtol=tol, atol=tol):
                fail(f"ssd_scan {case.name}: {name} max abs err {err:.3g} "
                     f"beyond {tol}")
            errs.append(f"{name} {err:.3g}")
            if name != "y":
                llm_err["ssd"] = max(llm_err["ssd"], err)
        say("2", f"ssd_scan {case.name}: {ran} kernel == plain (max abs "
                 f"err " + ", ".join(errs) + ")")

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
    noc_calls = []
    kernel_noc_run = nops.noc_run

    def recorded_noc_run(*args, **kw):
        out = kernel_noc_run(*args, **kw)
        noc_calls.append((phase, args, kw, out))
        return out

    nops.noc_run = recorded_noc_run
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

    phase = "fig13"
    f13 = figures.fig13_residency(device=dev)
    say("3", f"fig13 PROWAVES residency max {f13['prowaves_max']:.4f} mean "
             f"{f13['prowaves_mean']:.4f}, ReSiPI max "
             f"{f13['resipi_max']:.4f} mean {f13['resipi_mean']:.4f}; max "
             f"ratio {f13['max_ratio_pro_over_resipi']:.4f}; drained "
             f"{f13['drained']['prowaves']:.4f} / "
             f"{f13['drained']['resipi']:.4f}")
    if not f13["max_ratio_pro_over_resipi"] > 1.0:
        fail("fig13: PROWAVES' max residency is not above ReSiPI's")
    # The reference's own Fig. 13 at seed 5 (JAX package on the CPU, same
    # threefry arrivals): max 1.936 / 0.908, ratio 2.133, drained 6056 /
    # 6058.
    for k, v in (("prowaves_max", 1.936), ("resipi_max", 0.908),
                 ("max_ratio_pro_over_resipi", 2.133)):
        if abs(f13[k] - v) > 5e-4:
            fail(f"fig13 {k} {f13[k]:.5f} is not the reference's {v}")
    for k, v in (("prowaves", 6056.0), ("resipi", 6058.0)):
        if abs(f13["drained"][k] - v) > 1e-2:
            fail(f"fig13 drained {k} {f13['drained'][k]} is not the "
                 f"reference's {v}")

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
    dse_mib = torch.cuda.max_memory_allocated() / 2**20
    # The flit-level DSE: 512 runs in one noc_run launch, each a padded
    # topology (dead lanes past its routers and sinks) and its own key.
    phase = "noc-dse"
    runs = [(radix, g, w, load) for radix in DSE_RADIX for g in DSE_G
            for w in DSE_W for load in DSE_LOADS]
    topo = {}
    for radix, g, w, _ in runs:
        if (radix, g, w) not in topo:
            cfg_r = nops.NETWORK.with_topology(mesh_radix=radix)
            topo[radix, g, w] = nops.build_topology_padded(g, w, cfg_r,
                                                           pad_to=DSE_PAD)
    nm, drain, buf, mask = (torch.as_tensor(np.stack(
        [topo[radix, g, w][i] for radix, g, w, _ in runs]), device=dev)
        for i in range(4))
    keys = trandom.split(trandom.prng_key(13, device=dev), len(runs))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    noc_arr = nops.residency_arrivals(
        keys, [x[3] for x in runs], [x[0] ** 2 for x in runs], NOC_CYCLES,
        DSE_PAD)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    noc_dse = nops.noc_run(noc_arr, nm, drain, buf, valid_mask=mask)
    torch.cuda.synchronize()
    noc_dse_s = time.perf_counter() - t0
    noc_mib = torch.cuda.max_memory_allocated() / 2**20
    stats = sim_mod.engine_stats()           # main path ends here
    variants = dict(backend.COUNTERS["variants"])
    ops.epoch_run = kernel_epoch_run
    nops.noc_run = kernel_noc_run
    say("4", f"engine_stats after the main path: {json.dumps(stats)}")
    noc_launches = stats["kernel_launches"].get(nops.NAME, 0)
    if noc_launches != 3:
        fail(f"main path launched noc_step {noc_launches} times, expected 3 "
             f"(fig13 x2, DSE)")
    say("4", f"noc DSE: {len(runs)} runs x {NOC_CYCLES} cycles x {DSE_PAD} "
             f"nodes ({noc_arr.numel() * 4 / 1e9:.3f} GB of arrivals drawn "
             f"in {gen_s:.3f} s) in {noc_dse_s:.3f} s (entry point, host "
             f"clock); max memory allocated {noc_mib:.1f} MiB")
    dead = mask == 0
    for name, a in zip(("residency", "occupancy", "drained"), noc_dse):
        if a.shape != (len(runs), DSE_PAD) or not torch.isfinite(a).all():
            fail(f"noc DSE {name} malformed")
        if bool((a[dead] != 0).any()):
            fail(f"noc DSE {name}: a dead lane came out non-zero")
    injected = noc_arr.sum(dim=(1, 2), dtype=torch.float64)
    kept = (noc_dse[1].sum(1, dtype=torch.float64)
            + noc_dse[2].sum(1, dtype=torch.float64))
    leak = float(((kept - injected).abs() / injected.clamp(min=1)).max())
    if leak > 1e-4:
        fail(f"noc DSE: flits not conserved (rel err {leak:.3g})")
    top = [i for i, x in enumerate(runs) if x[3] == DSE_LOADS[-1]]
    say("4", f"noc DSE at {DSE_LOADS[-1]:.2f} pkts/cycle, drained per "
             f"cycle by (radix, g, W): " + ", ".join(
                 f"{runs[i][:3]} {float(noc_dse[2][i].sum()) / NOC_CYCLES:.3f}"
                 for i in top[::2]) + f"; flit conservation rel err "
             f"{leak:.2g}")
    lanes = len(apps) * lm.size
    expected = 2 * len(apps) + 1 + 1 + 1     # fig11, fig10, fig12, DSE
    say("4", f"DSE sweep_batch: {lanes} lanes x {T_INTERVALS} intervals "
             f"in {dse_s:.3f} s (entry point, host clock); max memory "
             f"allocated {dse_mib:.1f} MiB")
    if stats["epoch_step_launches"] != expected:
        fail(f"main path launched epoch_step {stats['epoch_step_launches']} "
             f"times, expected {expected}")
    want_variants = {f"{ops.NAME}:split": expected,
                     f"{nops.NAME}:node": noc_launches}
    if variants != want_variants:
        fail(f"main path kernel variants {variants}, expected "
             f"{want_variants}")
    say("4", f"main path kernel variants: {json.dumps(variants)}")
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
    dse_call = calls[-1]
    if dse_call[5]["lane_trace"].shape[0] != lanes:
        fail("the last main-path kernel call is not the DSE")
    # One call of each launch shape of the main path (Fig. 11's 16 calls
    # are 8 apps x RESIPI and RESIPI_ALL, whose split runs only the metrics
    # launch).
    shape_calls = {
        "dse": dse_call,
        "fig10": next(c for c in calls if c[0] == "fig10"),
        "fig11-resipi": next(c for c in calls
                             if c[0] == "fig11" and c[3].arch == Arch.RESIPI),
        "fig11-resipi_all": next(c for c in calls if c[0] == "fig11"
                                 and c[3].arch == Arch.RESIPI_ALL),
        "fig12": next(c for c in calls if c[0] == "fig12")}
    del calls

    # Kernel times per launch shape, both designs on the same inputs: the
    # device time of the launch(es) alone (CUDA-graph replays, median of 5)
    # and the wrapper call around them (CUDA events, median of 5).
    epoch_shapes = {}
    for label, (_, state0, xs, csim, tables, kw, _) in shape_calls.items():
        row = {}
        for kern in ("split", "warp"):
            run = lambda: ops.launch(state0.ctl.g, xs, csim, tables,  # noqa
                                     kernel=kern, **kw)
            row[f"{kern}_ms"] = time_graph(run)
            time_cuda(run, 2)
            row[f"{kern}_call_ms"] = float(np.median(time_cuda(run, 5)))
        n_tr, t_len, c = xs[0].shape
        n_lanes = int(kw["lane_trace"].shape[0])
        nbytes, n_ops = epoch_work(n_tr, t_len, c,
                                   cfg.max_gateways_per_chiplet, n_lanes,
                                   dest=kw["dest"] is not None)
        bound, by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                        (n_ops / F32_FLOPS_PER_S * 1e3, "operations"))
        epoch_shapes[label] = dict(row, lanes=n_lanes, intervals=t_len,
                                   bound_ms=bound, bound_by=by)
        say("4", f"epoch_step {label} launch ({n_lanes} lane(s) x {t_len} "
                 f"intervals): split {row['split_ms']:.4f} ms, warp "
                 f"{row['warp_ms']:.4f} ms (device: CUDA-graph replays, "
                 f"median of 5; split "
                 f"{'faster' if row['split_ms'] < row['warp_ms'] else 'NOT faster'}"
                 f"); wrapper call split {row['split_call_ms']:.4f} / warp "
                 f"{row['warp_call_ms']:.4f} ms; bound {bound:.4f} ms by {by} "
                 f"({nbytes / 1e6:.2f} MB, {n_ops / 1e9:.3f} GFLOP); card: "
                 f"{card}")
    _, state0, xs, sim, tables, kw, _ = dse_call
    ms, warp_ms = epoch_shapes["dse"]["split_ms"], epoch_shapes["dse"]["warp_ms"]
    bound_ms, bound_by = (epoch_shapes["dse"]["bound_ms"],
                          epoch_shapes["dse"]["bound_by"])
    plain_ms = time_cuda(
        lambda: epoch_run_reference(state0, xs, sim, tables, **kw), 1)[0]
    say("4", f"epoch_step split kernel, DSE: {ms:.4f} ms, "
             f"{lanes * T_INTERVALS / (ms * 1e-3):.4g} lane-intervals/s, "
             f"{bound_ms / ms:.1%} of its bound; warp kernel {warp_ms:.4f} "
             f"ms; plain version {plain_ms:.2f} ms once; card: {card}")
    # The same DSE through the entry point again, now warm (host clock),
    # then once under the profiler: what sets its pace besides the kernel.
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        sweep_batch(dse_traces, sim, device=dev, **grid)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    say("4", f"DSE sweep_batch warm: median {np.median(warm):.4f} s of 3 "
             f"(host clock; kernel share {ms * 1e-3 / np.median(warm):.1%})")
    stages = sweep_host_stages(sim_mod, ops, dse_traces, sim, dev, grid)
    say("4", "DSE sweep_batch warm, host stages (each ended by a "
             "synchronize; median of 3): " + ", ".join(
                 f"{k} {v:.3f} ms" for k, v in stages.items()))
    prof = device_breakdown(lambda: sweep_batch(dse_traces, sim, device=dev,
                                                **grid),
                            "DSE sweep_batch warm", top=8, phase="4")
    if prof is not None:
        wall, kern_us = prof
        mine = sum(v for k, v in kern_us.items() if "epoch_" in k) / 1e6
        say("4", f"DSE sweep_batch warm, profiled: the epoch_step kernels "
                 f"{mine * 1e3:.4f} ms on the device = {mine / wall:.1%} of "
                 f"the call's wall time; the other "
                 f"{len(kern_us) - sum('epoch_' in k for k in kern_us)} "
                 f"kernels {(sum(kern_us.values()) / 1e6 - mine) * 1e3:.4f} "
                 f"ms; host-side rest {(wall - sum(kern_us.values()) / 1e6) * 1e3:.4f} ms")

    # Every noc_step call of the main path against the plain version on
    # its own inputs (the DSE's plain run is also the plain time) and
    # against the warp kernel, bit for bit.
    if [c[0] for c in noc_calls] != ["fig13", "fig13", "noc-dse"]:
        fail(f"recorded noc_run calls {[c[0] for c in noc_calls]}, expected "
             f"fig13 x2 and noc-dse")
    noc_labels = ("fig13-prowaves", "fig13-resipi", "dse")
    noc_preps, noc_kw = {}, {}
    for label, (name, args, kw, got) in zip(noc_labels, noc_calls):
        want = []
        t_plain = time_cuda(
            lambda: want.append(reference_noc_run(*args, **kw)), 1)[0]
        err = noc_compare(got, want[0], f"main path {name}")
        noc_err = max(noc_err, err)
        batched = args[0].dim() == 3
        prep = nops.prepare(args[0] if batched else args[0][None], *args[1:],
                            **kw)
        noc_bitwise(got if batched else tuple(o[None] for o in got),
                    nops.run_prepared(prep, kernel="warp"),
                    f"main path {label}")
        noc_preps[label], noc_kw[label] = prep, kw
        say("4", f"main path noc_step {label} call == plain version on its "
                 f"own inputs (max abs err {err:.3g}; plain {t_plain:.1f} "
                 f"ms) and == warp kernel bitwise")
    noc_plain_ms = t_plain                                 # the DSE call
    # Kernel times: median of 5 launches after warm-up, CUDA events, on
    # inputs prepared once (routing, defaults) as the wrapper prepares them,
    # both designs in turns.
    noc_shapes = {}
    for label, prep in noc_preps.items():
        row = {}
        for kern in ("node", "warp", "node", "warp"):
            run = lambda: nops.run_prepared(prep, kernel=kern)  # noqa: E731
            time_cuda(run, 2)
            row.setdefault(kern, []).append(float(np.median(time_cuda(run, 5))))
        b_runs, t_cyc, _ = prep["arrivals"].shape
        nbytes, n_ops = noc_work(prep, noc_kw[label].get("t_mask")
                                 is not None, nops.MAX_IN_DEGREE)
        bound, by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                        (n_ops / F32_FLOPS_PER_S * 1e3, "operations"))
        noc_shapes[label] = {"runs": b_runs, "cycles": t_cyc,
                             "ms": row["node"][0], "warp_ms": row["warp"][0],
                             "ms_again": row["node"][1],
                             "warp_ms_again": row["warp"][1],
                             "bound_ms": bound, "bound_by": by}
        say("4", f"noc_step {label} launch ({b_runs} run(s) x {t_cyc} "
                 f"cycles): node {row['node'][0]:.4f} ms (again "
                 f"{row['node'][1]:.4f}), warp {row['warp'][0]:.4f} ms (again "
                 f"{row['warp'][1]:.4f}) (CUDA events, median of 5 each); "
                 f"bound {bound:.4f} ms by {by}; card: {card}")
    prep = noc_preps["dse"]
    nb, nt, nr = prep["arrivals"].shape
    nbytes, nops_count = noc_work(prep, noc_kw["dse"].get("t_mask")
                                  is not None, nops.MAX_IN_DEGREE)
    live = int((prep["mask"] != 0).sum())
    noc_bound_ms = noc_shapes["dse"]["bound_ms"]
    noc_bound_by = noc_shapes["dse"]["bound_by"]
    noc_dse_ms = noc_shapes["dse"]["ms"]
    say("4", f"noc_step node kernel, DSE: {noc_dse_ms:.4f} ms, "
             f"{nb * nt / (noc_dse_ms * 1e-3):.4g} run-cycles/s; warp kernel "
             f"{noc_shapes['dse']['warp_ms']:.4f} ms; plain version "
             f"{noc_plain_ms:.2f} ms once; bound {noc_bound_ms:.4f} ms by "
             f"{noc_bound_by} ({nbytes / 1e9:.3f} GB, "
             f"{nops_count / 1e9:.2f} GFLOP; {live} live of {nb * nr} "
             f"node lanes); card: {card}")
    noc_cycle_probe(nops, prep, runs, noc_ab_libs, card)
    del noc_calls, noc_arr, noc_preps, noc_kw, prep

    # --- 5. LLM serving (second main path) -----------------------------------
    llm = serve_llms(dev, card, fops, sops, llm_err)

    # --- 6. kernels line ----------------------------------------------------
    def ran(name):
        return "+".join(sorted(k.split(":")[1] for k in variants
                               if k.startswith(name + ":")))

    print(json.dumps({"kernels": [{
        "name": ops.NAME, "route": "cuda", "variant": ran(ops.NAME),
        "source": "src/repro_torch/kernels/epoch_step/csrc/epoch_step.cu",
        "replaces": "src/repro/kernels/epoch_step/kernel.py:48",
        "launches": stats["epoch_step_launches"],
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "warp_ms": warp_ms, "shapes": epoch_shapes}, {
        "name": nops.NAME, "route": "cuda", "variant": ran(nops.NAME),
        "source": "src/repro_torch/kernels/noc_step/csrc/noc_step.cu",
        "replaces": "src/repro/kernels/noc_step/kernel.py:32",
        "launches": noc_launches, "max_abs_err": noc_err, "ms": noc_dse_ms,
        "plain_ms": noc_plain_ms, "bound_ms": noc_bound_ms,
        "bound_by": noc_bound_by, "library_ms": None,
        "warp_ms": noc_shapes["dse"]["warp_ms"], "shapes": noc_shapes}]
        + llm}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
