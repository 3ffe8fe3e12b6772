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
     design of the two simulator kernels (epoch_step "split", "wide" and
     "warp", noc_step "node" and "warp"), naming any instantiation that
     spills;
  2. epoch_step against plain on the card at the Table-1 widths, T = 100,
     every design on each case (the wrapper runs "split"; "warp" and
     "wide" are forced on the same inputs): clean, destination matrices, a ragged t_mask
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
     (float32 and bfloat16, causal and not, head dims 16-256, S 1-2049;
     d_state 16-128, chunks 32-128, one and two groups, ragged L, initial
     states), each through its wrapper, which picks the tensor-core
     (`wgmma`) or SIMT kernel by dtype and shape; each case prints the
     kernel that ran (read from the launch counters);
  3. the paper through the port's own generator (the threefry twin, so the
     reference's traces at the seeds of its scripts): Fig. 11 (8 PARSEC
     apps x 4 architectures), Fig. 10 (L_m), Fig. 12 (settle times) and
     Fig. 13 (residency maps, seed 5), each held to the reference's
     numbers (FIG11_REFERENCE to the printed digit, FIG10_REFERENCE_LM,
     FIG12_REFERENCE, Fig. 13's maxima and drained totals);
  4. two full-size DSEs: RESIPI `sweep_batch` over 8 PARSEC apps with
     destination matrices x a 64 x 64 (l_m x buffer_sat) grid at T = 100
     (32 768 lanes), and one `noc_run` over 512 flit-level runs (mesh radix
     {4, 8} x g {1..4} x W {2, 16} x 32 loads, padded to 68 nodes, 8192
     cycles); then the main path's kernel variants are read (19
     epoch_step:split, 3 noc_step:node), every kernel call of phases 3 and
     4 is held against the plain version on its own inputs and each
     noc_step call against the warp kernel bit for bit; every design of
     each simulator kernel is timed on the same inputs, per launch shape
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
  5. streaming, session ticks, fault sweeps and the configurations past
     128 chiplets / nodes, a main path of its own (`stream_phase`): the 8
     apps of Fig. 11 concatenated to 800 intervals and streamed per arch
     through `SimSession` in 64-interval chunks, held bit for bit to
     one-shot `simulate`; 8 `session_tick`s of 256 lanes x 32 intervals
     with per-lane destination matrices and one shared fault frame, lanes
     0, 1 and 255 held bit for bit to standalone sessions; `sweep_faults`
     with 64 frames over one trace with l_m zipped in; RESIPI at 144 and
     256 chiplets (clean, destination matrices, a fault frame) and
     RESIPI_ALL at 256 through `simulate` ("wide"), and `noc_run` on
     12 x 12 and 16 x 16 meshes ("node"); its variant counts checked, every
     kernel call held against plain, then the warm host ms of a
     `step_chunk` and of a tick, the tick's device idle share (profiler),
     each new launch shape's device time, plain time and bound, and the
     evidence for `ops.variant`'s choice (GRID_DEFAULT), with and without
     destination matrices: "wide" against "split" at 4, 8 and 16
     chiplets with 8 and 512 lanes, and against "warp" at 24, 64 and 128
     chiplets at 256, 1024 and 32 768 lanes, on the same inputs, failing
     where the design picked takes more than GRID_SLACK times the other's
     time;
  6. LLM serving, the third main path, through `get_model(cfg)`,
     `prefill` and `decode_step`: (a) zamba2-7b at full width and depth
     (81 layers, 6.75 B parameters drawn on the card from a seeded
     generator, float32 as the reference keeps them), a batch of 4 prompts
     x 2048 tokens (max_len 2064), then 16 greedy decode steps; (b)
     mamba2-130m, 8 x 2048, then 16 steps. Every ssd_scan and
     flash_attention launch of those runs is held against its plain
     version on its own inputs (inline; flash also at FLASH_REL_RMS_TOL
     relative RMS, in every main path), the launches are counted (81 + 13
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
  7. the topology and placement DSE, a main path of its own
     (`topology_phase`), every launch with one topology per lane: (a) the
     reference's walkthrough scan (canneal, 16 intervals, 16-256 chiplets,
     RESIPI; one "wide" launch of 7 lanes), held to its printed digits
     (WALK_REFERENCE), and the same grid under PROWAVES and AWGR (plain
     loop); (b) `sweep_topology_batch` of the 8 PARSEC apps with
     destination matrices at 256 chiplets x n_chiplets {16..256} x
     gateways {1..4} (224 lanes), RESIPI and RESIPI_ALL, lane (app 0, 256,
     4) against an unpadded `simulate`; (c) the 8 apps at 16 chiplets x
     {4, 8, 12, 16} x {1..4} x 64 l_m (8192 lanes, "split"); (d)
     `sweep_workload` over one spec of each family zipped with 4-64
     chiplets; (e) `sweep_placement` over 64 random placements and the
     host `search_placement` (8 generations, one launch each), held to the
     reference host engine's best placement and score (SEARCH_REFERENCE).
     Each RESIPI / RESIPI_ALL sweep is one epoch_step launch; every launch
     is held against the padded plain loop; then per launch shape its
     device time, the plain loop's, the bound, the warm host ms and the
     host stages (and at 64 chiplets the unpadded "warp" launch beside the
     padded "wide" one);
  8. the device placement search, a main path of its own
     (`search_phase`), every generation one "+topo" launch whose lanes are
     every chain's candidates, and every generation loop run under
     `torch.cuda.set_sync_debug_mode("error")`: (a) the reference
     walkthrough's search (dedup, 24 intervals, 8 generations of 12), (b)
     its island search (4 islands, one l_m each) and (c) the resilience
     form (three blocked routers, `init` repaired off them), each held to
     the reference device engine's placements, accepted flags and printed
     scores (SEARCH_DEVICE_REFERENCE, ISLAND_REFERENCE,
     RESILIENCE_REFERENCE); (d) 64 islands zipped with 64 l_m values x
     32 x 16 generations at 100 intervals (2048 lanes a launch, "split");
     (e) 8 islands x 12 x 8 at 256 chiplets with a destination matrix
     ("wide"). Each search must make `generations` launches and one
     `search_dispatches`; every launch is held against the padded plain
     loop; then per launch shape its device time (CUDA-graph replays),
     the plain loop's and the bound, the warm host ms per search and per
     generation, candidate evaluations per second, the device idle share
     of a profiled warm (d), and (a) beside the host engine;
  9. serving and resilience, a main path of its own (`serve_phase`): (a)
     the reference's two serving walkthroughs on the card
     (`repro_torch.serve.cases`: the `ResilienceRuntime` fault-storm
     recovery and the 2-lane `SessionServer` under the same storm), held
     to STORM_WALK_REFERENCE and SERVER_WALK_REFERENCE (heal chunk / tick,
     moved gateways, PCM nJ, stall cycles, placements, submit signals,
     every counter of `metrics()`), every completed session's
     `replay_standalone` equal to its summary; (b) the launcher
     (`repro_torch.launch.serve.main`) with its defaults and with a storm
     and the healer, held to LAUNCH_REFERENCE; (c) a `SessionServer` of
     256 lanes x 32 intervals serving 1024 sessions of the 8 PARSEC apps
     (a quarter with destination matrices) through a router storm healed
     by the device search, until drained. Each serve dispatch must be one
     epoch_step "split" launch and each heal `generations` "split+topo"
     ones; the first launch of each kind is held to the plain loop (a
     tick with a dead gateway slot is a kind of its own), 16 of (c)'s
     sessions replay exactly, half of them served through the storm and
     across the heal; then (c)'s served intervals per second end to end
     (submissions included) and the tick layer's alone, host ms per tick
     by stage (pack, dispatch = launch +
     read-back, outcomes and rollback, heal), p50/p99 dispatch wall, the
     device idle share of 4 profiled ticks, the heals' ms and the tick
     launch's device time, plain time and bound;
  10. Pareto co-design, a main path of its own (`pareto_phase`): (a) the
     reference's walkthrough (`search_codesign` over 64 / 144 / 256
     chiplets, 8 PARSEC apps at 12 intervals, 4 islands x 6 x 6, one
     "wide+topo" launch of 576 lanes a generation) on the device engine
     and on the host engine, and its front re-scored by
     `rescore_front_host`; (b) a DSE-size co-design (100 intervals with
     destination matrices, 8 islands x 8 x 10, 1536 lanes a launch) and
     its re-scoring. (a) and (b) are held to the reference device engine
     (PARETO_WALK_REFERENCE, PARETO_DSE_REFERENCE: front entries exact,
     objectives and hypervolume at 1e-6, archive-size history and
     evaluations exact, every generation's decisions; a decision that
     parts must be a near-tie under NEAR_TIE, printed with its gap), the
     host search to the reference host engine
     (PARETO_WALK_HOST_REFERENCE); each device search must make
     `generations` launches and one `search_dispatches`, its loop under
     `set_sync_debug_mode("error")`; every launch of (a) and the first
     and last of (b) are held against the padded plain loop; then per
     launch shape the device time, the plain loop's and the bound, the
     warm host ms per search and per generation by stage, candidate
     evaluations per second, the device idle share of a profiled warm
     (b), and (b)'s launch on its 64-chiplet lanes against its
     256-chiplet lanes;
  11. fleet and caching, a main path of its own (`fleet_phase`): (a)
     `sweep_workload` over the fleet launcher's default 64-point grid
     sharded over 4 emulated devices of the card (one "+topo" launch a
     block), bitwise the one-device call, every block's launch held
     against the padded plain loop; (b) `python -m
     repro_torch.launch.fleet` as one process, a 2-process gloo group and
     `--shard 0:2` / `1:2`, every point equal; (c) `laned_all_reduce` over
     a 1-rank NCCL group at lanes 1, 2 and 4, the bits of one
     `all_reduce`; (d) a cold and a warm worker sharing a fresh
     REPRO_CACHE_DIR, the warm one building nothing. It prints the points
     per second of (a) and (b) and (d)'s first-call times;
  12. the remaining LLM families, run right after phase 6, each run a
     main path of its own (`llm_families_phase`, FAMILY_RUNS): (a)
     phi4-mini-3.8b at full width and depth (dense, 4 x 2048 tokens, 16
     decode steps), (b) grok-1-314b at full width, 2 of its 64 layers (MoE,
     2 x 2048, 8 steps; tokens per expert and drop fractions printed), (c)
     pixtral-12b at full width and depth (VLM, 2 x (256 image embeddings +
     1792 tokens), 16 steps; flash at head dim 160), (d)
     seamless-m4t-large-v2 in full (encoder-decoder, 4 x 2048 frames
     through the non-causal flash path, a 1536-token decoder prompt, 16
     steps), (e) the smoke configs of stablelm-3b, starcoder2-7b,
     command-r-plus-104b and kimi-k2 (2 x 40, 3 steps); parameters drawn on
     the card from LLM_SEED in float32, one model at a time. Every flash
     launch is held against the plain version on its own inputs, the
     launches counted (one per decoder layer, plus one per encoder layer
     for (d): 32, 2, 40, 12 + 12, 2 each) and all of them the tensor-core
     kernel, each prefill's logits held against the plain-op prefill in
     float32 compute; prefill and decode tokens/s, peak memory and the
     device breakdown of a prefill and a decode step per run;
     then the flash kernel at
     pixtral's shape [2, 2048, 32, 160] (kernel, SIMT kernel, plain,
     SDPA, bound) and the phase's seconds;
  13. training, run right after phase 12 (`train_phase`): (a)
     stablelm-3b at full size (32 layers, AdamW, batch 4 x 2048) and (b)
     mamba2-130m (batch 8 x 2048), from the twin key's weights (the
     reference launcher's), each run a main path of its own: one warm-up
     step whose every flash / SSD launch is held against the plain
     version, then 3 timed steps, each launching the kernel twice a layer
     (forward and rematerialization, all `wgmma`) with the plain VJP as
     the backward (`backward_plain`, once a layer); step ms, tokens/s,
     model FLOP/s against the bf16 peak, peak memory and one profiled
     step's idle share and top operations; (c) one step of stablelm-3b at
     full width on 2 layers and of mamba2-130m in float32 compute against
     the same step with the kernels' plain versions (loss 1e-5, every
     gradient leaf present and within 1e-4 relative RMS, the attention /
     SSM projection gradients nonzero; the plain step uses no kernel
     route, the kernel step both the kernel and `backward_plain`); (d)
     `launch.train.main` at smoke
     size with the lane controller live, a checkpoint at step 2 resumed
     against the uninterrupted run, and the laned step over a 2-process
     gloo group on the card at lane widths 1, 2 and 4;
  14. the dry run, its op analysis and the H100 roofline
     (`analysis_phase`): (a) every (arch, shape) pair of the ten LLM
     configs on both production meshes, one trace a pair on `meta`
     tensors under this machine's torch (`launch.dryrun.run_pairs` in
     DRYRUN_JOBS worker processes), a line per record, failing on any
     `error`, and the H100 roofline of the 16 x 16 records (data-sheet
     peaks, `core.constants.H100`) written to build/analysis/ and printed;
     (b) phase 13's two training steps at phase 13's shapes on one device,
     analysed on `meta` and on the card's tensors under the same counter
     (FLOPs equal, bytes within ANALYSIS_BYTES_RTOL, the kernel calls
     credited equal to the launch counters), their one-device bound beside
     phase 13's measured step; (c) EXAMPLES, the two examples, as child
     processes on the card (exit 0, every section header printed);
  15. a `kernels` JSON line (launches on the main paths, error against
     plain, times, the bound and the kernel variant that ran) for all four
     kernels; the simulator kernels' entries add the first design's time
     in the same run (`warp_ms`), the times per launch shape (`shapes`,
     phases 5's, 7's-11's among them) and the launches per main path;
     flash's adds phase 12's launches and its shape at pixtral's prefill;
     flash's and SSD's add phase 13's training launches and runs.

Phases 3 and 4 are the first main path: the launch counters are zeroed
before phase 3 and read after the last DSE, before any check or timing.
Phase 5 is the second, zeroed before its streaming and read after its last
`noc_run`. Each LLM run of phase 6 is a main path of its own, with the
counters zeroed just before its prefill and read just after its last
decode step, and so is each run of phase 12. Phase 7 is zeroed before
its walkthrough scan and read after its placement search; phase 8 before
its search (a) and after (e); phase 13 before each run's first timed
step and after its last; phase 9 before its walkthroughs and after
(c) drains; phase 10 before its walkthrough search and after (b)'s
re-scoring; phase 11, the last, just before and just after (a)'s sharded
sweep (the launcher's child
processes count their own launches, printed from their JSON). Phase 14
drives no main path: its launches analyse a step, and the kernels line
takes phase 13's.
`python3 chip_smoke.py --epoch-grid` builds epoch_step alone and times
the whole design grid (GRID_FULL: 4-16 chiplets at 1-512 lanes, 17-128 at
8-32 768, with and without destination matrices), the evidence for
`ops.MIN_LANES`. `python3 chip_smoke.py --rows-ab [--src DIR]` builds
epoch_step alone and times, on the unpadded fault-free launch shapes of
the main paths (ROWS_AB_SHAPES), the instantiations without topology rows
(the launch constants) against those with rows that hold the same
constants, in turns, and prints each build's ptxas report of epoch_step;
`--src DIR` takes the port from DIR (another checkout's `src`) instead,
where a tree without topology rows times the constants alone.
`python3 chip_smoke.py --search` builds epoch_step alone and runs phase 8,
`python3 chip_smoke.py --serve` builds epoch_step alone and runs phase 9,
`python3 chip_smoke.py --pareto` builds epoch_step alone and runs phase
10, `python3 chip_smoke.py --fleet` builds epoch_step alone and runs phase
11, `python3 chip_smoke.py --llm-families` builds flash_attention alone and
runs phase 12, `python3 chip_smoke.py --train` builds flash_attention and
ssd_scan and runs phase 13, `python3 chip_smoke.py --dryrun` builds
flash_attention, ssd_scan and epoch_step and runs phase 14 (without phase
13's measured steps).

The last line is {"ok": true, "device": {...}}. Without a card, or without
the rest of the repository beside this file, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import re
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

T_INTERVALS = 100
RTOL = ATOL = 1e-6
# The card's data-sheet peaks (`repro_torch.core.constants.H100`: HBM3
# bandwidth, float32 on the CUDA cores, dense bf16 on the tensor cores),
# bound by `main` once the port's sources are on the path.
H100 = None
# Float operations of the epoch_step kernel, counted from its source per
# lane-interval (memory-gateway latency, reductions, power), per chiplet
# (loads, M/D/1 terms, controller), per chiplet pair when destination
# matrices are on and per gateway slot (old and new Eq. 4 kappas and the
# switch test). Of a pair's six operations, four (w = ext * dest, the recv
# sum, w * w, the fan-in sum) depend on the trace and its matrix alone, so
# the least work counts them once per matrix; two (the destination leg's
# product and sum) depend on the lane's g, so they count per lane.
OPS_PER_LANE, OPS_PER_CHIPLET, OPS_PER_SLOT = 90, 80, 12
OPS_PER_PAIR_MATRIX, OPS_PER_PAIR_LANE = 4, 2
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
# The epoch_step design grid: "wide" against the design that fills the
# card with lanes ("split" at C <= 16, "warp" at 17-128), per (chiplets,
# destination matrices, lanes), 100 intervals. The default run times points
# either side of ops.MIN_LANES; `--epoch-grid` times the whole grid alone.
# The design ops.variant picks must take at most GRID_SLACK times the
# other's time.
GRID_DEFAULT = ([(c, d, n) for c in (4, 8, 16) for d in (False, True)
                 for n in (8, 512)]
                + [(c, d, n) for c in (24, 64, 128) for d in (False, True)
                   for n in (256, 1024, 32768)])
GRID_FULL = ([(c, d, n) for c in (4, 5, 8, 12, 16) for d in (False, True)
              for n in (1, 8, 16, 32, 64, 128, 256, 512)]
             + [(c, d, n) for c in (17, 24, 32, 48, 64, 96, 128)
                for d in (False, True)
                for n in (8, 64, 256, 512, 1024, 2048, 4096, 32768)])
GRID_SLACK = 1.25
# Turns per design at each grid point, in alternation; the gate reads the
# median of each design's turns, so one turn that a passing disturbance of
# the card slows (one of two turns once read 0.2035 ms where the other and
# every earlier run read ~0.055) does not decide it.
GRID_TURNS = 3
# Lanes up to which the grid holds both designs to the plain version (past
# it, to each other: the plain version at 128 chiplets x 32 768 lanes with
# destination matrices would take minutes).
GRID_PLAIN_LANES = 512
# A/B builds of noc_step.cu for the per-cycle breakdown: the node kernel
# without its zero-numerator guard on space / want, the warp kernel with
# it; each is the checked-out source with one expression replaced (both
# stay bitwise equal to the kernels as built).
NOC_AB = {
    "node-unguarded": ("fminf(1.f, fdiv_guarded(space, fmaxf(want, 1e-9f)))",
                       "fminf(1.f, space / fmaxf(want, 1e-9f))"),
    "warp-guarded": ("fminf(1.f, space / fmaxf(want, 1e-9f))",
                     "fminf(1.f, fdiv_guarded(space, fmaxf(want, 1e-9f)))"),
    "node-1024": ("if (threads <= kMaxNodes)", "if (false)")}
DSE_RADIX, DSE_G, DSE_W = (4, 8), (1, 2, 3, 4), (2, 16)
DSE_LOADS = np.linspace(0.02, 0.64, 32)
DSE_PAD = 8 * 8 + 4                           # mesh radix 8 plus 4 sinks
# Flash's and SSD's bf16 main-path launches run their products on the
# tensor cores (SSD's float32 factors split into bf16 terms), so their
# bound is at H100.peak_bf16_flops; SSD's bound at the float32 peak (what
# its SIMT kernel's arithmetic is held to) is printed beside it, so the row
# reads the same work whatever implements it.
# LLM serving (phase 6): (arch, batch, prompt tokens, decode steps).
LLM_RUNS = (("zamba2-7b", 4, 2048, 16), ("mamba2-130m", 8, 2048, 16))
LLM_SEED = 2026
# Each flash launch of a main path is also held to this relative RMS
# against the plain version on its inputs: late causal rows average many
# keys, their outputs are a few hundredths in size, and the absolute
# bound alone would pass a normalisation error there. On an H100 the bf16
# launches of phases 6, 12 and 13 read 1.2e-3 to 2.2e-3 (one rounding of
# P and one of the output, 2^-9 relative each).
FLASH_REL_RMS_TOL = 5e-3
# Bound of the whole prefill's logits against the same prefill with the
# plain ops, in relative RMS, with float32 compute. In bf16 these
# random-weight models at full depth are dominated by rounding noise: every
# layer adds some to the residual stream and it persists, so on an H100
# the plain bf16 prefill lands tens of percent from the float32 one, and
# two bf16 prefills whose floats differ in the last bits part by about as
# much (phase 6 prints both); no bf16 bound can hold there. In float32 the
# kernel and plain prefills part by under 1e-3 at the logits.
PREFILL_F32_REL_TOL = 5e-3
# Phase 5: streaming chunks, the session tick's shape, the fault sweep's
# frame count, and the flit cases past 128 nodes.
STREAM_CHUNK = 64
TICK_LANES, TICK_CHUNK, TICK_COUNT = 256, 32, 8
SWEEP_FRAMES = 64
NOC_WIDE_CYCLES = 2048
# The reference's Figs. 10-12 at the seeds their scripts use (the JAX
# package on the CPU; the port's generator draws the same traces): Fig. 11
# ReSiPI against PROWAVES in latency / power / energy to the printed digit,
# Fig. 10's L_m, Fig. 12's settle times and gateway peak.
FIG11_REFERENCE = {"latency": "33.6%", "power": "27.6%", "energy": "51.1%"}
FIG10_REFERENCE_LM = "0.0060"
FIG12_REFERENCE = {"resipi_settle": [3, 30], "prowaves_settle": [2, 30],
                   "max_gateways_used": 18}
# Phase 7, the topology and placement DSE. (a) The reference's walkthrough
# scan (examples/noc_reconfig_demo.py:76-94: canneal, 16 intervals from
# PRNGKey(1) at 256 chiplets, RESIPI): latency, power and mean gateways per
# chiplet count at the digits it prints, from the JAX package on the CPU.
WALK_COUNTS = (16, 36, 64, 100, 144, 196, 256)
WALK_REFERENCE = {16: ("5475.80", "8470", "49.6"),
                  36: ("4201.31", "18631", "111.6"),
                  64: ("3209.66", "32525", "196.2"),
                  100: ("2465.18", "50345", "304.9"),
                  144: ("1904.23", "72555", "440.2"),
                  196: ("1510.85", "98414", "597.9"),
                  256: ("1211.01", "128693", "782.4")}
# (b) The topology DSE at 256 chiplets: 8 apps x these points (crossed).
TOPO_C, TOPO_G = (16, 36, 64, 100, 144, 196, 256), (1, 2, 3, 4)
# (c) The topology x knob DSE at 4-16 chiplets: 8 apps x these points
# crossed with KNOB_LM l_m values (zipped into 1024 points).
SPLIT_C, SPLIT_G, KNOB_LM = (4, 8, 12, 16), (1, 2, 3, 4), 64
# (d) sweep_workload: one spec of each family, zipped with these counts.
WORKLOAD_C = (4, 8, 16, 16, 32, 32, 64, 64)
# (e) sweep_placement over seeded random placements on the Table-1 system,
# and the host search with the walkthrough's settings
# (noc_reconfig_demo.py:111-114: dedup, 24 intervals from PRNGKey(2),
# 8 generations of 12, seed 0), held to the reference host engine's best
# placement and score (the JAX package on the CPU).
PLACEMENT_COUNT = 64
SEARCH_GENERATIONS, SEARCH_POPULATION = 8, 12
SEARCH_REFERENCE = {"best_placement": ((2, 1), (0, 2), (3, 3), (2, 0)),
                    "best_score": 23.296194076538086,
                    "default_score": 23.787277221679688}
# Phase 8, the device placement search, held to the reference's device
# engine (the JAX package on the CPU, jax 0.9.0): (a) the walkthrough's
# search (noc_reconfig_demo.py:111-115, the same inputs as phase 7 (e));
# (b) its island search (:147-151: dedup, 24 intervals from PRNGKey(3),
# ISLAND_LM, 8 x 12, seed 0); (c) the resilience form: (a)'s trace with
# RESILIENCE_BLOCKED failed and (a)'s best placement repaired off them as
# `init`, 8 x 12, seed 1. Scores at the 3 digits the walkthrough prints,
# and as floats for the relative gap printed beside them.
SEARCH_DEVICE_REFERENCE = {
    "best_placement": ((1, 2), (3, 1), (1, 1), (1, 3)),
    "incumbent_placement": ((1, 2), (3, 1), (1, 1), (1, 3)),
    "default_placement": ((1, 0), (2, 3), (0, 2), (3, 1)),
    "best_score": 23.327125549316406, "default_score": 23.787277221679688,
    "accepted": (True,) * 8}
ISLAND_LM = (0.008, 0.0152, 0.024, 0.032)
ISLAND_REFERENCE = {
    "best_placements": (((1, 0), (2, 3), (0, 2), (3, 1)),
                        ((1, 1), (2, 3), (3, 1), (0, 1)),
                        ((2, 1), (1, 3), (1, 1), (3, 1)),
                        ((1, 1), (2, 3), (2, 1), (1, 2))),
    "best_scores": (18.459196090698242, 22.59000015258789,
                    142.43789672851562, 143.79649353027344),
    "default_scores": (18.459196090698242, 23.013578414916992,
                       143.4962158203125, 145.13145446777344),
    "accepted": ((True,) * 8,) * 4}
RESILIENCE_BLOCKED = ((1, 2), (3, 1), (2, 2))
RESILIENCE_REFERENCE = {
    "init": ((2, 1), (0, 2), (1, 3), (1, 1)),
    "best_placement": ((2, 1), (0, 2), (2, 3), (3, 0)),
    "incumbent_placement": ((2, 1), (0, 2), (2, 3), (3, 0)),
    "default_placement": ((2, 1), (0, 2), (1, 0), (2, 3)),
    "best_score": 23.38286590576172, "default_score": 23.550085067749023,
    "accepted": (True,) * 8}
# (d) the full-width island DSE (a best floorplan per operating point):
# dedup, 100 intervals from PRNGKey(5), DSE_ISLANDS islands zipped with as
# many l_m points over [0.004, 0.032], population 32, 16 generations: 2048
# lanes a launch. (e) past 16 chiplets: 256 chiplets, a trace with its
# destination matrix (dedup, 100 intervals from PRNGKey(6)), 8 islands x
# 12 x 8 generations.
DSE_ISLANDS, DSE_POPULATION, DSE_GENERATIONS = 64, 32, 16
WIDE_SEARCH_C, WIDE_SEARCH_ISLANDS = 256, 8
# Phase 9, serving and resilience, held to the reference (the JAX package
# on the CPU, jax 0.9.0). (a) examples/noc_reconfig_demo.py's two
# walkthroughs (`serve.cases`): the fault-storm recovery (:237, latency
# and baseline per chunk at the printed digits, each heal as (chunk, moved
# gateways, PCM nJ, stall cycles)) and the session server (:300, each
# submission's (signal, reason), per tick (in flight, queue depth,
# degraded, breach, latency at the printed digits), each heal as (tick,
# moved gateways, PCM nJ, new placement), and every counter of metrics()).
STORM_WALK_REFERENCE = {
    "victims": ((1, 0), (2, 3)),
    "latency": ("18.10", "18.10", "18.41", "17.91", "18.84", "70.39",
                "28.17", "19.21"),
    "baseline": ("18.10", "18.10", "18.18", "18.11", "18.30", "18.30",
                 "18.30", "18.52"),
    "breach": (False,) * 5 + (True, True, False),
    "heals": ((6, 6, 12.0, 100),),
    "placement": ((2, 0), (1, 3), (3, 2), (0, 2)),
    "bill": (12.0, 100, 1)}
SERVER_WALK_REFERENCE = {
    "submits": (("accept", ""), ("throttle", ""), ("accept", ""),
                ("throttle", ""), ("throttle", ""), ("throttle", ""),
                ("shed", "shed_queue_full"), ("shed", "shed_queue_full")),
    "ticks": ((2, 0, False, False, "18.37"), (2, 3, False, False, "17.95"),
              (2, 3, True, False, "18.26"), (2, 3, True, True, "31.93"),
              (0, 3, True, True, "22.22"), (1, 1, True, False, "18.56"),
              (2, 0, True, False, "18.58"), (2, 0, False, False, "18.96"),
              (2, 0, False, True, "34.36"), (2, 0, False, False, "18.59"),
              (1, 0, False, False, "18.33"), (1, 0, False, False, "19.68"),
              (0, 0, False, False, "19.71")),
    "heals": ((4, 4, 8.0, ((2, 1), (1, 3), (0, 2), (3, 1))),),
    "metrics": {"submitted": 8, "admitted": 5, "completed": 5,
                "shed_queue_full": 3, "shed_memory": 0, "shed_priority": 0,
                "displaced": 1, "deadline_expired": 0, "idle_evicted": 0,
                "retries": 0, "retry_exhausted": 0, "dispatches": 18,
                "coalesced_dispatches": 5, "served_chunks": 34,
                "degraded_ticks": 5, "heals": 1, "ticks": 13,
                "queue_depth": 0, "queued_intervals": 0,
                "sessions_in_flight": 0, "degraded": False,
                "availability": "77%", "baseline_latency": "19.0208",
                "replacements": 1, "total_pcm_nj": 8.0,
                "total_stall_cycles": 100}}
# (b) `python -m repro.launch.serve` (seed 0) with its defaults and with a
# storm and the healer: every counter it prints (drain = the ticks of
# `drain()`).
LAUNCH_RUNS = {"defaults": [],
               "storm": ["--storm-at", "6", "--heal", "--arrival-rate", "4",
                         "--deadline", "6", "--lanes", "4"]}
LAUNCH_REFERENCE = {
    "defaults": {"submitted": 58, "admitted": 58, "completed": 58,
                 "ticks": 26, "drain": 2, "served_chunks": 141,
                 "dispatches": 25, "coalesced_dispatches": 0,
                 "degraded_ticks": 0, "shed_queue_full": 0,
                 "shed_memory": 0, "shed_priority": 0, "displaced": 0,
                 "deadline_expired": 0, "idle_evicted": 0, "retries": 0,
                 "heals": 0},
    "storm": {"submitted": 100, "admitted": 65, "completed": 59,
              "ticks": 29, "drain": 5, "served_chunks": 148,
              "dispatches": 42, "coalesced_dispatches": 13,
              "degraded_ticks": 13, "shed_queue_full": 12,
              "shed_memory": 0, "shed_priority": 15, "displaced": 10,
              "deadline_expired": 14, "idle_evicted": 0, "retries": 0,
              "heals": 0, "availability": "93%"}}
# (c) a server at the size a DSE user runs it: SERVE_LANES lanes x
# SERVE_CHUNK intervals (phase 5's tick shape), queue SERVE_QUEUE,
# SERVE_SESSIONS sessions (`serve.cases.dse_traces`) arriving
# SERVE_PER_TICK a tick, routers under two live gateways dead from the
# SERVE_STORM_DISPATCH-th dispatch, the healer on; SERVE_PROFILED ticks
# from tick SERVE_PROFILE_AT under the profiler; SERVE_REPLAYS completed
# sessions replayed (half with destination matrices; half served through
# the storm and across the heal).
SERVE_LANES, SERVE_CHUNK, SERVE_QUEUE = 256, 32, 512
SERVE_SESSIONS, SERVE_PER_TICK, SERVE_STORM_DISPATCH = 1024, 64, 16
SERVE_PROFILE_AT, SERVE_PROFILED, SERVE_REPLAYS = 12, 4, 16
SERVE_SUMMARY_KEYS = ("mean_latency", "mean_power_mw", "mean_energy",
                      "mean_gateways", "mean_wavelengths", "saturated_frac",
                      "total_reconfig_nj", "valid_intervals")
# Phase 10, Pareto co-design (`pareto_phase`), RESIPI over 64 / 144 / 256
# chiplets and the 8 PARSEC apps, traces at 256 chiplets from the keys
# split(prng_key(seed), 8): (a) the reference's walkthrough
# (examples/noc_reconfig_demo.py:465-478: 12 intervals from seed 5,
# PARETO_WALK); (b) a DSE-size co-design at the settings of
# benchmarks/bench_pareto.py (100 intervals from seed 20 with destination
# matrices, PARETO_DSE). Their reference values below are the JAX package's
# on the CPU (jax 0.9.0) on the reference's own traces: each front entry as
# (n_chiplets, island, L_m, placement, latency, power mW, energy), the
# archive size after each (point, generation), the hypervolume against 2x
# the front's maxima, and (device engine) every generation's decisions per
# point: "ib" the argmin candidate of each island, "improved" the elitist
# update, "accepted" the Metropolis move (K characters a generation).
# tests/test_torch_pareto.py re-derives every one from the reference.
PARETO_COUNTS = (64, 144, 256)
PARETO_APPS = ("blackscholes", "swaptions", "streamcluster", "facesim",
               "fluidanimate", "bodytrack", "canneal", "dedup")
PARETO_TRACES = {"a": (12, 5, False), "b": (100, 20, True)}
PARETO_RUNS = {
    "a": dict(islands=4, generations=6, population=6, archive=24,
              migrate_every=3,
              knob_grids={"l_m": [0.008, 0.0152, 0.024, 0.032]}, seed=0),
    "b": dict(islands=8, generations=10, population=8, archive=32,
              migrate_every=4,
              knob_grids={"l_m": [float(v) for v in
                                  np.linspace(0.004, 0.032, 8)]}, seed=0)}
# A decision may part from the reference's only on a near-tie: the two
# values it compares within this relative gap (ROADMAP queue 3, P9).
NEAR_TIE = 1e-6
PARETO_WALK_REFERENCE = {
    "front": (
        (256, 0, 0.008, ((1, 0), (2, 3), (0, 2), (3, 1)),
         722.7926025390625, 132179.265625, 101424672.0),
        (256, 1, 0.0152, ((1, 0), (2, 3), (0, 2), (3, 1)),
         724.7828369140625, 103211.0625, 80024656.0),
        (256, 2, 0.024, ((1, 1), (2, 3), (1, 0), (1, 3)),
         729.3093872070312, 86676.4453125, 66683080.0),
        (256, 2, 0.024, ((1, 0), (2, 3), (0, 2), (3, 1)),
         729.4989013671875, 84363.015625, 64998420.0),
        (256, 3, 0.032, ((1, 2), (3, 1), (1, 0), (2, 3)),
         734.8092651367188, 77932.0625, 59754476.0),
        (256, 3, 0.032, ((1, 0), (2, 3), (0, 2), (3, 1)),
         735.1102905273438, 75636.859375, 58073136.0),
        (144, 0, 0.008, ((1, 0), (2, 3), (0, 2), (3, 1)),
         1170.3427734375, 74418.34375, 92167424.0),
        (144, 1, 0.0152, ((2, 1), (0, 2), (3, 3), (1, 0)),
         1172.007080078125, 59600.921875, 74315712.0),
        (144, 1, 0.0152, ((1, 0), (2, 3), (0, 2), (3, 1)),
         1172.049560546875, 58310.4765625, 72801672.0),
        (144, 2, 0.024, ((2, 1), (0, 2), (3, 2), (2, 0)),
         1175.1719970703125, 49021.1171875, 60632272.0),
        (144, 2, 0.024, ((1, 0), (2, 3), (0, 2), (3, 1)),
         1175.385986328125, 47715.390625, 59100856.0),
        (144, 3, 0.032, ((1, 1), (2, 3), (3, 1), (0, 0)),
         1180.988525390625, 44094.9453125, 54246548.0),
        (144, 3, 0.032, ((1, 0), (2, 3), (0, 2), (3, 1)),
         1181.3028564453125, 42798.80859375, 52717616.0),
        (64, 0, 0.008, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2152.85205078125, 33262.796875, 75388920.0),
        (64, 1, 0.0152, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2154.275390625, 25990.421875, 59199736.0),
        (64, 2, 0.024, ((1, 1), (2, 3), (3, 1), (0, 1)),
         2156.47900390625, 21887.73828125, 49335944.0),
        (64, 2, 0.024, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2156.7294921875, 21301.046875, 48072836.0),
        (64, 3, 0.032, ((1, 1), (2, 3), (3, 1), (1, 0)),
         2162.17919921875, 19707.1015625, 44171976.0),
        (64, 3, 0.032, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2162.49951171875, 19124.62890625, 42912168.0)),
    "candidate_evals": 3456,
    "archive_size": (
        (5, 6, 6, 6, 6, 6),
        (12, 13, 13, 13, 13, 13),
        (19, 19, 19, 19, 19, 19)),
    "hypervolume": 1.2997289824957728e+17,
    "ib": (
        "0005 0002 0000 5000 0001 1000",
        "0005 0000 0003 4001 0000 0001",
        "0004 0000 0000 0002 5000 2000"),
    "improved": (
        "1111 0001 0000 0000 0000 0000",
        "1111 0000 0001 0000 0000 0000",
        "1111 0000 0000 0001 0000 0000"),
    "accepted": (
        "1111 1111 1111 1111 1111 1111",
        "1111 1111 1111 1111 1111 1111",
        "1111 1111 1111 1111 1111 1111"),
    "archive": (
        "66f4ca7f 680937b9 680937b9 680937b9 680937b9 680937b9",
        "0fe7ead8 0fe5b678 a992bdcc a992bdcc a992bdcc a992bdcc",
        "ea19ebd5 bda06664 bda06664 b18a1513 b18a1513 b18a1513")}
PARETO_WALK_HOST_REFERENCE = {
    "front": (
        (256, 0, 0.008, ((1, 0), (2, 3), (0, 2), (3, 1)),
         722.7926025390625, 132179.265625, 101424672.0),
        (256, 1, 0.0152, ((1, 2), (3, 1), (1, 0), (2, 3)),
         724.7553100585938, 105498.5703125, 81686424.0),
        (256, 1, 0.0152, ((1, 0), (2, 3), (0, 2), (3, 1)),
         724.7828369140625, 103211.0625, 80024656.0),
        (256, 2, 0.024, ((1, 2), (3, 1), (1, 0), (2, 3)),
         729.307861328125, 86676.453125, 66681208.0),
        (256, 2, 0.024, ((1, 0), (2, 3), (0, 2), (3, 1)),
         729.4989013671875, 84363.0234375, 64998420.0),
        (256, 3, 0.032, ((1, 2), (3, 1), (1, 0), (2, 3)),
         734.8092651367188, 77932.0625, 59754476.0),
        (256, 3, 0.032, ((1, 0), (2, 3), (0, 2), (3, 1)),
         735.1102905273438, 75636.859375, 58073136.0),
        (144, 0, 0.008, ((1, 0), (2, 3), (0, 2), (3, 1)),
         1170.3427734375, 74418.3515625, 92167424.0),
        (144, 1, 0.0152, ((1, 1), (2, 3), (3, 0), (0, 1)),
         1172.0194091796875, 59600.91796875, 74315864.0),
        (144, 1, 0.0152, ((1, 0), (2, 3), (0, 2), (3, 1)),
         1172.049560546875, 58310.47265625, 72801672.0),
        (144, 2, 0.024, ((1, 2), (3, 1), (1, 0), (2, 3)),
         1175.1898193359375, 49021.12109375, 60632948.0),
        (144, 2, 0.024, ((1, 0), (2, 3), (0, 2), (3, 1)),
         1175.385986328125, 47715.390625, 59100856.0),
        (144, 3, 0.032, ((2, 1), (0, 2), (2, 3), (1, 0)),
         1181.00048828125, 44094.9453125, 54247340.0),
        (144, 3, 0.032, ((1, 0), (2, 3), (0, 2), (3, 1)),
         1181.3028564453125, 42798.80859375, 52717612.0),
        (64, 0, 0.008, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2152.852294921875, 33262.796875, 75388920.0),
        (64, 1, 0.0152, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2154.275146484375, 25990.421875, 59199740.0),
        (64, 2, 0.024, ((2, 1), (1, 3), (1, 1), (3, 1)),
         2156.4990234375, 22025.224609375, 49665604.0),
        (64, 2, 0.024, ((1, 2), (3, 1), (0, 0), (2, 3)),
         2156.5166015625, 21887.740234375, 49337040.0),
        (64, 2, 0.024, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2156.7294921875, 21301.046875, 48072836.0),
        (64, 3, 0.032, ((1, 1), (2, 3), (3, 1), (0, 1)),
         2162.145263671875, 19707.103515625, 44170528.0),
        (64, 3, 0.032, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2162.49951171875, 19124.62890625, 42912168.0)),
    "candidate_evals": 3456,
    "archive_size": (
        (7, 6, 7, 7, 7, 7),
        (12, 12, 14, 14, 14, 14),
        (20, 20, 20, 20, 21, 21)),
    "hypervolume": 1.2997300700626538e+17,
    "archive": (
        "ce2d30cd c6b66585 4200f256 4200f256 4200f256 4200f256",
        "f3b907ee a93a131c 4b1b8b51 4b1b8b51 2ba13c9a 2ba13c9a",
        "5a1d94fe 5a1d94fe 5a1d94fe 9fb047cb 0d7c45b2 63c7f0cc")}
PARETO_DSE_REFERENCE = {
    "front": (
        (256, 4, 0.02, ((1, 1), (2, 3), (3, 1), (1, 0)),
         732.426025390625, 88971.4375, 69591792.0),
        (256, 4, 0.02, ((1, 0), (2, 3), (0, 2), (3, 1)),
         732.5690307617188, 86714.515625, 67941720.0),
        (256, 5, 0.024, ((2, 1), (0, 2), (2, 3), (2, 0)),
         733.6766357421875, 79293.375, 61752616.0),
        (256, 5, 0.024, ((1, 0), (2, 3), (0, 2), (3, 1)),
         733.9179077148438, 77023.1484375, 60096232.0),
        (256, 6, 0.028, ((1, 1), (2, 3), (3, 1), (1, 0)),
         735.3553466796875, 71869.15625, 55726696.0),
        (256, 6, 0.028, ((1, 0), (1, 3), (3, 1), (0, 2)),
         735.67578125, 69589.03125, 54063264.0),
        (256, 7, 0.032, ((1, 1), (2, 3), (3, 1), (0, 0)),
         737.5552978515625, 66144.984375, 51166640.0),
        (256, 7, 0.032, ((1, 0), (1, 3), (3, 1), (0, 2)),
         737.9462280273438, 63863.3828125, 49501208.0),
        (256, 7, 0.032, ((1, 0), (2, 3), (0, 2), (3, 1)),
         737.9483642578125, 63863.3828125, 49501192.0),
        (144, 3, 0.016, ((1, 0), (2, 3), (0, 2), (3, 1)),
         1187.606689453125, 56098.16796875, 71258400.0),
        (144, 4, 0.02, ((1, 1), (2, 3), (3, 1), (1, 0)),
         1188.263427734375, 50153.9609375, 63430012.0),
        (144, 4, 0.02, ((1, 0), (2, 3), (0, 2), (3, 1)),
         1188.4132080078125, 48879.7109375, 61918216.0),
        (144, 5, 0.024, ((1, 1), (2, 3), (3, 1), (1, 0)),
         1189.4013671875, 44708.4609375, 56260280.0),
        (144, 5, 0.024, ((1, 0), (2, 3), (0, 2), (3, 1)),
         1189.652587890625, 43426.921875, 54741264.0),
        (144, 6, 0.028, ((1, 1), (2, 3), (3, 1), (1, 0)),
         1190.867431640625, 40580.5625, 50798044.0),
        (144, 6, 0.028, ((1, 0), (1, 3), (3, 1), (0, 2)),
         1191.196044921875, 39292.484375, 49271592.0),
        (144, 7, 0.032, ((1, 2), (3, 1), (0, 2), (1, 3)),
         1192.9111328125, 37363.47265625, 46629512.0),
        (144, 7, 0.032, ((1, 0), (1, 3), (3, 1), (0, 2)),
         1193.3095703125, 36074.6015625, 45101828.0),
        (64, 2, 0.012, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2176.765869140625, 29281.0859375, 67148456.0),
        (64, 3, 0.016, ((2, 1), (0, 2), (3, 2), (2, 0)),
         2177.306396484375, 25649.962890625, 59024188.0),
        (64, 3, 0.016, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2177.38134765625, 25083.09375, 57792592.0),
        (64, 4, 0.02, ((1, 1), (2, 3), (3, 1), (0, 1)),
         2177.98046875, 22472.96875, 51559176.0),
        (64, 4, 0.02, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2178.18212890625, 21901.08203125, 50317128.0),
        (64, 5, 0.024, ((2, 1), (0, 2), (3, 3), (1, 0)),
         2178.983154296875, 20065.3359375, 45824024.0),
        (64, 5, 0.024, ((1, 0), (1, 3), (3, 1), (0, 2)),
         2179.2587890625, 19489.6640625, 44572888.0),
        (64, 5, 0.024, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2179.26171875, 19489.6640625, 44572884.0),
        (64, 6, 0.028, ((1, 2), (2, 0), (2, 3), (3, 1)),
         2180.20263671875, 18212.0546875, 41402192.0),
        (64, 6, 0.028, ((1, 0), (1, 3), (3, 1), (0, 2)),
         2180.5546875, 17632.9765625, 40143488.0),
        (64, 7, 0.032, ((1, 2), (2, 0), (2, 3), (2, 1)),
         2182.089111328125, 16771.9765625, 37986140.0),
        (64, 7, 0.032, ((1, 2), (2, 0), (2, 3), (0, 1)),
         2182.091796875, 16765.609375, 37971968.0),
        (64, 7, 0.032, ((1, 0), (1, 3), (3, 1), (0, 2)),
         2182.517333984375, 16185.8818359375, 36711880.0),
        (64, 7, 0.032, ((1, 0), (2, 3), (0, 2), (3, 1)),
         2182.51953125, 16185.8818359375, 36711876.0)),
    "candidate_evals": 15360,
    "archive_size": (
        (15, 14, 14, 14, 14, 14, 15, 15, 16, 16),
        (28, 30, 30, 30, 31, 30, 30, 29, 29, 29),
        (32, 32, 32, 32, 32, 32, 32, 32, 32, 32)),
    "hypervolume": 5.592381052925855e+16,
    "ib": (
        "00000003 00000005 00000000 00000000 60000015 40000003 40000600 "
        "30000000 60000005 20000000",
        "00000002 00000004 00000000 00000060 40000006 40000000 00000004 "
        "40000003 40000002 50000000",
        "00000002 00000000 00000006 00000000 30000052 00000006 00000000 "
        "50000000 70000001 00000002"),
    "improved": (
        "11111111 00000001 00000000 00000000 00000010 00000000 00000100 "
        "00000000 00000000 00000000",
        "11111111 00000001 00000000 00000010 00000000 00000000 00000000 "
        "00000000 00000000 00000000",
        "11111111 00000000 00000001 00000000 00000011 00000001 00000000 "
        "00000000 00000000 00000000"),
    "accepted": (
        "11111111 11111111 11111111 11111111 11111111 11111111 11111111 "
        "11111111 11111111 11111111",
        "11111111 11111111 11111111 11111111 11111111 11111111 11111111 "
        "11111111 11111111 11111111",
        "11111111 11111111 11111111 11111111 11111111 11111111 11111111 "
        "11111111 11111111 11111111"),
    "archive": (
        "9c406e86 67b18475 c3f99bf3 c3f99bf3 b7dcdd9d b7dcdd9d 23aa7230 "
        "23aa7230 a2338782 a2338782",
        "532f6a64 90095356 90095356 12916bad c5a541a6 e5d93cec 27ceddcf "
        "f48c50b5 1c67936f 9d4d77d9",
        "eb87144f f1c87086 2d1bdcef 8300cf22 425794d2 9dfe3ee7 5b9ee8bf "
        "5b9ee8bf 5b9ee8bf 5b9ee8bf")}


def codesign_decisions(s, threshold, u, temps) -> dict:
    """The per-generation decisions of a device co-design, as the
    reference's generation body takes them, from its scalarized scores s
    [T, GEN, K, P] (float32), Metropolis thresholds exp(-rel / temp) and
    uniform draws u [T, GEN, K] and temperatures [GEN]: "ib" the argmin
    candidate (first on ties), "improved" sb < the island's incumbent
    score, "accepted" delta < 0 or (temp > 0 and u < threshold); each
    [T, GEN, K]."""
    s = np.asarray(s, np.float32)
    ib = np.argmin(s, axis=-1)
    sb = np.take_along_axis(s, ib[..., None], axis=-1)[..., 0]
    best = np.minimum.accumulate(sb, axis=1)
    prev = np.concatenate([np.full_like(sb[:, :1], np.inf), best[:, :-1]],
                          axis=1)
    temps = np.asarray(temps, np.float32)[None, :, None]
    accepted = ((sb - s[..., 0]) < 0) | (
        (temps > 0) & (np.asarray(u, np.float32)
                       < np.asarray(threshold, np.float32)))
    return {"ib": ib, "improved": sb < prev, "accepted": accepted}


def pack_decisions(dec: dict) -> dict:
    """`codesign_decisions` as strings: per point, one group of K
    characters a generation (the argmin's digit, or 0 / 1)."""
    return {k: tuple(" ".join("".join(str(int(v)) for v in row)
                              for row in per_t) for per_t in a)
            for k, a in dec.items()}


def pareto_pin(res: dict, dec: Optional[dict] = None,
               prints=None) -> dict:
    """What phase 10 holds a co-design result to (the form of
    PARETO_WALK_REFERENCE): the front entries, candidate evaluations,
    archive-size history, hypervolume and, given `codesign_decisions`
    and the archive's fingerprint after each insert ([T][GEN]
    `archive_print`s), the packed decisions and fingerprints."""
    objs = np.array([[e["objectives"][k] for k in
                      ("latency", "power_mw", "energy")]
                     for e in res["front"]], np.float64)
    out = {"front": tuple(
               (e["topology"]["n_chiplets"], e["island"],
                e["knobs"].get("l_m"), e["placement"],
                *(float(v) for v in row))
               for e, row in zip(res["front"], objs)),
           "candidate_evals": int(res["candidate_evals"]),
           "archive_size": tuple(tuple(int(v) for v in row) for row in
                                 res["history"]["archive_size"]),
           "hypervolume": pareto_hypervolume(objs)}
    if dec is not None:
        out.update(pack_decisions(dec))
    if prints is not None:
        out["archive"] = tuple(" ".join(row) for row in prints)
    return out


def pareto_hypervolume(objs: np.ndarray) -> float:
    """The walkthrough's hypervolume: against 2x the front's maxima."""
    from repro_torch.core.pareto import hypervolume

    return hypervolume(objs, tuple(2.0 * objs.max(axis=0)))


def first_parting(got: dict, want: dict, s, threshold, u):
    """The first decision (point, generation, island order) where `got`
    (`pack_decisions`) parts from `want`, as (point, generation, island,
    kind, gap): gap is the relative gap of the two values the decision
    compares, from this run's s, threshold and u (an acceptance compares
    sb with s0 and u with the threshold: the nearer pair). None if no
    decision parts."""
    s = np.asarray(s, np.float64)

    def rel(a, b):
        return abs(a - b) / abs(b)

    for t in range(len(want["ib"])):
        g_ib, w_ib = got["ib"][t].split(), want["ib"][t].split()
        g_imp, w_imp = got["improved"][t].split(), want["improved"][t].split()
        g_acc, w_acc = got["accepted"][t].split(), want["accepted"][t].split()
        for gen in range(len(w_ib)):
            for k in range(len(w_ib[gen])):
                row = s[t, gen, k]
                sb = row[int(g_ib[gen][k])]
                if g_ib[gen][k] != w_ib[gen][k]:
                    return (t, gen, k, "argmin",
                            rel(sb, row[int(w_ib[gen][k])]))
                if g_imp[gen][k] != w_imp[gen][k]:
                    prev = min(s[t, j, k][int(g_ib[j][k])]
                               for j in range(gen)) if gen else np.inf
                    return (t, gen, k, "elitist update", rel(sb, prev))
                if g_acc[gen][k] != w_acc[gen][k]:
                    return (t, gen, k, "acceptance", min(
                        rel(sb, row[0]), rel(float(u[t, gen, k]),
                                             float(threshold[t, gen, k]))))
    return None


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


def epoch_work(n, t, c, g, b, dest: bool, frames: int = 0) -> tuple:
    """(bytes read once + written once, float ops) of one epoch_step call.
    Written per lane-interval: the six scalars the records need (latency,
    power, laser, reconfiguration energy, mean inter-chiplet latency,
    saturated) and g_eff, gw_load per chiplet; per lane the final g. Read:
    ext, intra, mem, t_mask, dest per trace; lane_trace, the five knobs and
    g0 per lane; the two selection-table rows. `frames` fault frames (one
    per trace, or one that every lane shares) add gw_ok and stuck_on
    [T, C, G] and drift_db [T] each to the reads, and g_desired per
    chiplet and the failed-slot count per lane-interval to the writes."""
    f = 4
    read = (2 * n * t * c + 2 * n * t + (n * c * c if dest else 0)) * f \
        + b * (4 + 5 * f + c * f) + 2 * g * f \
        + frames * (2 * t * c * g + t) * f
    written = b * t * (6 + 2 * c) * f + b * c * f \
        + (b * t * (1 + c) * f if frames else 0)
    ops = t * (b * (OPS_PER_LANE + c * OPS_PER_CHIPLET
                    + (c * c * OPS_PER_PAIR_LANE if dest else 0)
                    + c * g * OPS_PER_SLOT)
               + (n * c * c * OPS_PER_PAIR_MATRIX if dest else 0))
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


def epoch_design_grid(dev, card: str, points, phase: str) -> dict:
    """Time "wide" against the design ops.variant would otherwise run at
    each (chiplets, destination matrices, lanes) point: one trace of
    T_INTERVALS intervals, the lanes an l_m sweep over it, both designs in
    GRID_TURNS alternating turns (device time, CUDA-graph replays), both
    held to the plain version (up to GRID_PLAIN_LANES lanes) or to each
    other. Fails where the median turn of the design ops.variant picks
    takes more than GRID_SLACK times the other's."""
    from repro_torch import interop
    from repro_torch.core import simulator as S
    from repro_torch.kernels.epoch_step import cases as ecases
    from repro_torch.kernels.epoch_step import ops
    from repro_torch.kernels.epoch_step.ref import epoch_run_reference

    cfg = S.SimConfig().cfg
    rows = {}
    for c, dest, lanes_n in points:
        csim = S.SimConfig(cfg=cfg.with_topology(n_chiplets=c))
        rng = np.random.RandomState(c + lanes_n)
        tr = ecases.make_trace(rng, T_INTERVALS, c,
                               cfg.max_gateways_per_chiplet, dest=dest,
                               faults=False)
        state0, xs, tbl, kw = S.epoch_inputs(
            interop.trace_from_numpy(tr, dev), csim, device=dev,
            l_m=np.linspace(0.004, 0.03, lanes_n).astype(np.float32))
        other = "split" if c <= ops.SPLIT_MAX_CHIPLETS else "warp"
        row = {}
        for kern in (other, "wide") * GRID_TURNS:
            run = lambda: ops.launch(state0.ctl.g, xs, csim, tbl,  # noqa
                                     kernel=kern, **kw)
            row.setdefault(kern, []).append(time_graph(run))
        recs = {kern: ops._reassemble(state0, ops.launch(
            state0.ctl.g, xs, csim, tbl, kernel=kern, **kw), xs, csim,
            False)[1] for kern in (other, "wide")}
        label = f"{c} chiplets x {lanes_n} lanes{' (dest)' if dest else ''}"
        if lanes_n <= GRID_PLAIN_LANES:
            want = epoch_run_reference(state0, xs, csim, tbl, **kw)[1]
            for kern, got in recs.items():
                compare(got, want, f"{kern} at {label}")
            held = "both == plain at 1e-6"
        else:
            compare(recs["wide"], recs[other], f"wide vs {other} at {label}")
            held = f"wide == {other} at 1e-6"
        chosen = ops.variant(c, False, dest, lanes_n)
        ms = {k: float(np.median(v)) for k, v in row.items()}
        ratio = ms[chosen] / min(ms.values())
        rows[f"c{c}{'d' if dest else ''}x{lanes_n}"] = dict(
            row, chiplets=c, dest=dest, lanes=lanes_n, chosen=chosen,
            chosen_over_fastest=ratio)
        say(phase, f"design choice, {label} x {T_INTERVALS} intervals: "
                   + ", ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                               + " ms" for k, v in row.items())
                   + f" (device, in turns; {held}); ops.variant picks "
                     f"{chosen}, {ratio:.3f}x the faster; card: {card}")
        if ratio > GRID_SLACK:
            fail(f"ops.variant picks {chosen} at {label}, {ratio:.3f}x the "
                 f"faster design's time (slack {GRID_SLACK})")
        del state0, xs, tbl, kw, recs
        torch.cuda.empty_cache()
    return rows


# Unpadded launch shapes of the main paths that the instantiations with and
# without topology rows both take (no fault frames): (chiplets, destination
# matrices, lanes, intervals, arch): a Fig. 11 lane, the design grid's 4
# chiplets x 8 lanes with destination matrices (where the design choice
# runs both "split" and "wide"), a session tick, the Fig. 10 DSE, single
# lanes at 144 and 256 chiplets, and RESIPI_ALL at 256.
ROWS_AB_SHAPES = ((4, False, 1, 100, "resipi"), (4, True, 8, 100, "resipi"),
                  (4, False, 256, 32, "resipi"),
                  (4, False, 32768, 100, "resipi"),
                  (144, True, 1, 100, "resipi"), (256, True, 1, 100, "resipi"),
                  (256, False, 1, 100, "resipi_all"))
ROWS_AB_TURNS = 3


def kernel_times(fn, reps: int = 10) -> dict:
    """Information: device microseconds per call of each kernel that `fn`
    launches, from `reps` calls under torch.profiler (empty when the
    profiler records no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = e.key.replace("void ", "").replace(
            "(anonymous namespace)::", "").replace("at::native::", "") \
            .split("<")[0].split("(")[0]
        out[name] = out.get(name, 0.0) + us / reps
    return out


def epoch_rows_ab(dev, card: str) -> dict:
    """Device ms of each ROWS_AB_SHAPES launch (the design ops.variant
    picks; both "split" and "wide" at 4 chiplets x 8 lanes) through the
    launch constants and, where the port takes topology rows, through rows
    that hold the same constants (the two bit for bit equal), in turns
    (constants, rows, ... ROWS_AB_TURNS times each; CUDA-graph replays,
    median of 10 a turn)."""
    import inspect

    from repro_torch import backend, interop
    from repro_torch.core import simulator as S
    from repro_torch.core import topology
    from repro_torch.core.noc import uniform_mesh_mean_hops
    from repro_torch.kernels.epoch_step import cases as ecases
    from repro_torch.kernels.epoch_step import ops

    has_rows = "topo" in inspect.signature(ops.launch).parameters
    ops.build()
    entries = [(template_args(e), r, sp) for e, r, sp in
               ptxas_entries(backend.build_log(ops.NAME) or "")]
    say("ab", f"epoch_step ptxas (template args, registers, spill bytes): "
              f"{entries}")
    rows_out = {}
    for c, dest, lanes_n, t, arch in ROWS_AB_SHAPES:
        cfg = S.SimConfig().cfg.with_topology(n_chiplets=c)
        csim = S.SimConfig(cfg=cfg).with_arch(S.Arch(arch))
        rng = np.random.RandomState(c + lanes_n)
        tr = ecases.make_trace(rng, t, c, cfg.max_gateways_per_chiplet,
                               dest=dest, faults=False)
        state0, xs, tbl, kw = S.epoch_inputs(
            interop.trace_from_numpy(tr, dev), csim, device=dev,
            l_m=np.linspace(0.004, 0.03, lanes_n).astype(np.float32))
        f32 = dict(dtype=torch.float32, device=dev)
        topo = {"n_chiplets": torch.full((lanes_n,), c, dtype=torch.int32,
                                         device=dev),
                "src_hops": tbl["src_hops"].expand(lanes_n, -1).contiguous(),
                "gw_loss_db": tbl["gw_loss_db"].expand(lanes_n, -1)
                .contiguous(),
                "mesh_hops": torch.full(
                    (lanes_n,), float(np.float32(uniform_mesh_mean_hops(cfg))),
                    **f32),
                "mesh_x": torch.full((lanes_n,), topology.feed_width(cfg),
                                     **f32)}
        designs = ["split", "wide"] if (c, dest, lanes_n) == (4, True, 8) \
            else [ops.variant(c, False, dest, lanes_n)]
        for kern in designs:
            how = {"constants": {}}
            if has_rows:
                how["rows"] = {"topo": topo}
                a = ops.launch(state0.ctl.g, xs, csim, tbl, kernel=kern, **kw)
                b = ops.launch(state0.ctl.g, xs, csim, tbl, kernel=kern,
                               topo=topo, **kw)
                for k in ("scal", "g_eff", "gw_load", "g_final"):
                    if not torch.equal(a[k], b[k]):
                        fail(f"rows A/B {kern} at {c} chiplets: {k} differs "
                             f"between the constants and the rows")
            turns = {k: [] for k in how}
            for _ in range(ROWS_AB_TURNS):
                for k, extra in how.items():
                    turns[k].append(time_graph(
                        lambda: ops.launch(state0.ctl.g, xs,  # noqa: B023
                                           csim, tbl, kernel=kern,  # noqa
                                           **kw, **extra), reps=10))
            label = (f"{kern} {c}{'d' if dest else ''}x{lanes_n}x{t}"
                     f"{'' if arch == 'resipi' else ' ' + arch}")
            per = {k: kernel_times(lambda: ops.launch(  # noqa: B023
                state0.ctl.g, xs, csim, tbl, kernel=kern, **kw,  # noqa
                **extra)) for k, extra in how.items()}
            rows_out[label] = dict(turns, per_kernel_us=per)
            say("ab", f"{label}: " + "; ".join(
                f"{k} median {np.median(v):.4f} ms (turns "
                f"{', '.join(f'{x:.4f}' for x in v)}; per kernel "
                f"{', '.join(f'{n} {u:.2f} us' for n, u in per[k].items())})"
                for k, v in turns.items()) + f"; card: {card}")
        del state0, xs, tbl, kw
        torch.cuda.empty_cache()
    return {"rows_ab": rows_out, "has_rows": has_rows, "ptxas": entries}


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


def flash_work(*args, **kwargs) -> tuple:
    """`kernels.flash_attention.ops.work`: (bytes, flops) of one attention
    call, the formula the analysis credits (`launch.op_analysis`)."""
    from repro_torch.kernels.flash_attention.ops import work
    return work(*args, **kwargs)


def ssd_work(*args, **kwargs) -> tuple:
    """`kernels.ssd_scan.ops.work`: (bytes, float ops) of one intra-chunk
    call, the formula the analysis credits."""
    from repro_torch.kernels.ssd_scan.ops import work
    return work(*args, **kwargs)


def device_breakdown(fn, label: str, top: int = 6, phase: str = "6",
                     ops: int = 0):
    """Information: one call of `fn` under torch.profiler; prints its host
    wall time, the summed device time of its kernels, the device's busy
    share (kernels run one at a time on one stream) and the kernels that
    take the most device time, and with `ops` the PyTorch operators whose
    own kernels take the most. Returns (wall seconds, {kernel: device
    microseconds}), or None when the profiler recorded no device time. A
    failure of `fn` itself is raised, not reported as "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    raised = []

    def call():
        try:
            fn()
        except BaseException as e:       # the work's own failure
            raised.append(e)
            raise

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels, by_op = {}, {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if e.device_type != DeviceType.CUDA:
                if us > 0:
                    by_op[e.key] = by_op.get(e.key, 0.0) + us
                continue
            kernels[e.key] = kernels.get(e.key, 0.0) + us
    except Exception as e:                   # information only
        if raised:
            raise
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
    if ops:
        ranked = sorted(by_op.items(), key=lambda kv: -kv[1])[:ops]
        say(phase, f"{label}: operators by their kernels' device time: "
                   + "; ".join(f"{k} {v / 1e3:.3f} ms ({v / 1e6 / busy:.1%})"
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


def llm_checked_ops(fops, sops, errs: dict, first: dict):
    """Wrappers for the two kernel ops that hold every call against the
    plain version on its own inputs right after it (float32 outputs at
    the cases' bounds; a bf16 attention output at 3e-2 and, every
    attention output, at FLASH_REL_RMS_TOL relative RMS), and keep the
    first call's inputs (detached) for timing. `errs` gathers the largest
    absolute errors ("flash", "ssd"), the largest flash relative RMS
    ("flash_rel") and the smallest flash output RMS ("flash_rms")."""
    from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk

    kernel_flash, kernel_intra = fops.flash_attention, sops.ssd_intra_chunk

    def flash(q, k, v, *, causal=True):
        out = kernel_flash(q, k, v, causal=causal)
        with torch.no_grad():
            want = fops._plain(q, k, v, causal).float()
            err = float((out.float() - want).abs().max())
            rel = rel_rms(out, want)
            rms = float(want.double().pow(2).mean().sqrt())
        tol = 2e-5 if q.dtype == torch.float32 else 3e-2
        if not torch.allclose(out.float(), want, rtol=tol, atol=tol) \
                or rel > FLASH_REL_RMS_TOL:
            fail(f"main path flash_attention launch {tuple(q.shape)} "
                 f"{q.dtype} differs from plain (max abs err {err:.3g}, "
                 f"relative RMS {rel:.3g}, bound {FLASH_REL_RMS_TOL}; "
                 f"output RMS {rms:.3g})")
        errs["flash"] = max(errs.get("flash", 0.0), err)
        errs["flash_rel"] = max(errs.get("flash_rel", 0.0), rel)
        errs["flash_rms"] = min(errs.get("flash_rms", float("inf")), rms)
        first.setdefault("flash", (*(t.detach() for t in (q, k, v)),
                                   causal))
        return out

    def intra(x, dt, a, b_in, c_in):
        out = kernel_intra(x, dt, a, b_in, c_in)
        with torch.no_grad():
            want = reference_intra_chunk(x, dt, a, b_in, c_in)
        tol = 2e-4 if x.shape[2] >= 128 else 1e-4
        for name, u, w in zip(("y_intra", "states"), out, want):
            err = float((u.detach() - w).abs().max())
            if not torch.allclose(u.detach(), w, rtol=tol, atol=tol):
                fail(f"main path ssd_scan launch {tuple(x.shape)}: {name} "
                     f"differs from plain (max abs err {err:.3g})")
            errs["ssd"] = max(errs.get("ssd", 0.0), err)
        first.setdefault("ssd", tuple(t.detach() for t in
                                      (x, dt, a, b_in, c_in)))
        return out

    return flash, intra


def flash_errs_text(errs: dict) -> str:
    """The flash checks' readings, as `llm_checked_ops` gathered them."""
    return (f"max abs err {errs['flash']:.3g}, worst relative RMS "
            f"{errs['flash_rel']:.3g} (bound {FLASH_REL_RMS_TOL}), smallest "
            f"output RMS {errs['flash_rms']:.3g}")


def flash_times(fops, inputs: tuple, label: str, phase: str, card: str,
                backward: bool = False) -> dict:
    """The flash kernel at one launch shape of a main path, on the inputs
    it gave (q, k, v, causal), CUDA events, medians after warm-up: the
    kernel the main path ran, the SIMT kernel on the same inputs
    (information), the plain version, SDPA, and the bound; with
    `backward`, the backward as training runs it, the plain VJP
    (recompute + backward of the plain version for a unit cotangent),
    beside SDPA's backward (information). Prints one line."""
    q, k, v, causal = inputs
    ms = float(np.median(time_cuda(
        lambda: fops.launch(q, k, v, causal=causal), 7)[2:]))
    simt_ms = float(np.median(time_cuda(
        lambda: fops.launch(q, k, v, causal=causal, kernel="simt"), 7)[2:]))
    plain_ms = float(np.median(time_cuda(
        lambda: fops._plain(q, k, v, causal), 3)))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = float(np.median(time_cuda(
        lambda: sdpa(qt, kt, vt, is_causal=causal), 7)[2:]))
    b, s_len, h, d = q.shape
    nbytes, flops = flash_work(b, s_len, h, d, q.element_size(), causal)
    bound_ms, bound_by = max(
        (nbytes / H100.hbm_bytes_per_s * 1e3, "bytes"),
        (flops / H100.peak_bf16_flops * 1e3, "operations"))
    t = {"shape": [b, s_len, h, d], "dtype": str(q.dtype).split(".")[1],
         "causal": causal, "variant": fops.variant(q.dtype, d), "ms": ms,
         "simt_ms": simt_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
         "bound_ms": bound_ms, "bound_by": bound_by}
    text = ""
    if backward:
        t["backward_plain_ms"] = float(np.median(time_cuda(
            lambda: unit_vjp(lambda *a: fops._plain(*a, causal),
                             (q, k, v)), 4)[1:]))
        t["library_backward_ms"] = float(np.median(time_cuda(
            lambda: unit_vjp(lambda *a: sdpa(*a, is_causal=causal),
                             (qt, kt, vt)), 4)[1:]))
        text = (f"; backward (information): the plain VJP "
                f"{t['backward_plain_ms']:.3f} ms, SDPA's backward "
                f"{t['library_backward_ms']:.3f} ms")
    say(phase, f"{label}flash_attention {t['variant']} kernel at "
               f"{t['shape']} {q.dtype}{', causal' if causal else ''}: "
               f"median {ms:.4f} ms (SIMT kernel {simt_ms:.4f} ms); plain "
               f"{plain_ms:.3f} ms; SDPA {lib_ms:.4f} ms; bound "
               f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP "
               f"at the bf16 tensor-core peak, {nbytes / 1e9:.3f} GB), "
               f"{bound_ms / ms:.1%} of it{text}; card: {card}")
    return t


def ssd_times(sops, inputs: tuple, label: str, phase: str, card: str,
              backward: bool = False) -> dict:
    """`flash_times` for the SSD intra-chunk kernel (x, dt, a, B, C): no
    library call computes it; its bound at the float32 peak is printed
    beside the bf16 one."""
    from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk

    x, dt, a, b_in, c_in = inputs
    ms = float(np.median(time_cuda(lambda: sops.launch(*inputs), 7)[2:]))
    simt_ms = float(np.median(time_cuda(
        lambda: sops.launch(*inputs, kernel="simt"), 7)[2:]))
    plain_ms = float(np.median(time_cuda(
        lambda: reference_intra_chunk(*inputs), 3)))
    bsz, nc, cq, h, p = x.shape
    g, n = b_in.shape[3], b_in.shape[4]
    nbytes, n_ops = ssd_work(bsz, nc, cq, h, p, g, n, x.element_size())
    t_b = nbytes / H100.hbm_bytes_per_s * 1e3
    bound_ms, bound_by = max((t_b, "bytes"),
                             (n_ops / H100.peak_bf16_flops * 1e3,
                              "operations"))
    t = {"shape": [bsz, nc, cq, h, p, g, n],
         "dtype": str(x.dtype).split(".")[1],
         "variant": sops.variant(x.dtype, cq, p, n), "ms": ms,
         "simt_ms": simt_ms, "plain_ms": plain_ms, "library_ms": None,
         "bound_ms": bound_ms, "bound_by": bound_by,
         "bound_f32_peak_ms": max(t_b, n_ops / H100.peak_f32_flops * 1e3)}
    text = ""
    if backward:
        t["backward_plain_ms"] = float(np.median(time_cuda(
            lambda: unit_vjp(reference_intra_chunk, inputs), 4)[1:]))
        text = (f"; backward (information): the plain VJP "
                f"{t['backward_plain_ms']:.3f} ms")
    say(phase, f"{label}ssd_scan {t['variant']} kernel [B {bsz}, NC {nc}, "
               f"Q {cq}, H {h}, P {p}, G {g}, N {n}] {x.dtype}: median "
               f"{ms:.4f} ms (SIMT kernel {simt_ms:.4f} ms); plain "
               f"{plain_ms:.3f} ms; no library call; bound {bound_ms:.4f} "
               f"ms by {bound_by} ({nbytes / 1e9:.4f} GB, {n_ops / 1e9:.3f} "
               f"GFLOP at the bf16 tensor-core peak), {bound_ms / ms:.1%} "
               f"of it; at the float32 peak {t['bound_f32_peak_ms']:.4f} "
               f"ms{text}; card: {card}")
    return t


def unit_vjp(fn, args: tuple) -> None:
    """`fn`'s backward for a unit cotangent on every output, recomputed
    from detached copies of `args`."""
    leaves = [t.detach().requires_grad_() for t in args]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs],
                        allow_unused=True)


def prefill_against_plain(phase: str, name: str, model, params, inputs,
                          max_len: int, prefill_logits, plain_ops) -> float:
    """The whole prefill against the same prefill with the plain ops
    (`plain_ops`: (module, attribute, plain function) swapped in), on the
    card: held in float32 compute at PREFILL_F32_REL_TOL, shown in bf16
    beside the bf16 prefill's own distance from float32 (`prefill_logits`,
    the kernel bf16 prefill). Returns the float32 relative RMS."""
    from repro_torch.models import layers as L

    got = {(torch.bfloat16, False): prefill_logits.float()}
    for dtype, plain in ((torch.bfloat16, True), (torch.float32, False),
                         (torch.float32, True)):
        kept = [(m, a, getattr(m, a)) for m, a, _ in plain_ops]
        L.COMPUTE_DTYPE = dtype
        if plain:
            for m, a, fn in plain_ops:
                setattr(m, a, fn)
        try:
            _, lg = model.prefill(params, inputs, max_len)
        finally:
            for m, a, fn in kept:
                setattr(m, a, fn)
            L.COMPUTE_DTYPE = torch.bfloat16
        got[dtype, plain] = lg.float()
    f32_k, f32_p = got[torch.float32, False], got[torch.float32, True]
    rel = rel_rms(f32_k, f32_p)
    if not (torch.isfinite(f32_k).all() and rel <= PREFILL_F32_REL_TOL):
        fail(f"{name}: float32 prefill logits vs the plain-op prefill: "
             f"relative RMS {rel:.3g} beyond {PREFILL_F32_REL_TOL}")
    bf_k, bf_p = got[torch.bfloat16, False], got[torch.bfloat16, True]
    say(phase, f"{name}: prefill logits == plain-op prefill in float32 "
               f"compute (relative RMS {rel:.3g}, bound "
               f"{PREFILL_F32_REL_TOL}; max abs diff "
               f"{float((f32_k - f32_p).abs().max()):.3g} on logits of RMS "
               f"{float(f32_p.pow(2).mean().sqrt()):.3g}); in bf16 "
               f"(information) kernel vs plain {rel_rms(bf_k, bf_p):.3g}, "
               f"the plain bf16 prefill vs float32 "
               f"{rel_rms(bf_p, f32_p):.3g}, the kernel bf16 prefill vs "
               f"float32 {rel_rms(bf_k, f32_p):.3g}")
    return rel


def serving_speed(phase: str, name: str, model, params, inputs,
                  max_len: int, steps: int, real_vocab: int,
                  card: str) -> tuple:
    """Prefill and greedy decode on the host clock, synchronized, median
    of 3 warm runs, with the peak memory over them; then (information)
    the device breakdown of one prefill and one decode step. Returns
    (prefill s, decode s, peak GiB)."""
    batch, seq = inputs["tokens"].shape[0], max_len - steps
    prefill_s, decode_s = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caches, logits = model.prefill(params, inputs, max_len)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for _ in range(steps):
            nxt = logits[:, :real_vocab].argmax(-1, keepdim=True)
            logits, caches = model.decode_step(params, nxt, caches)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t0)
        del caches
    peak = torch.cuda.max_memory_allocated() / 2**30
    p_s, d_s = float(np.median(prefill_s)), float(np.median(decode_s))
    say(phase, f"{name}: prefill {batch * seq / p_s:.6g} tokens/s "
               f"({p_s:.4f} s median of 3), decode "
               f"{batch * steps / d_s:.6g} tokens/s ({d_s / steps * 1e3:.3f}"
               f" ms a step, median of 3 runs of {steps}); peak memory "
               f"{peak:.2f} GiB; card: {card}")

    caches = None

    def one_prefill():
        nonlocal caches, logits
        caches, logits = model.prefill(params, inputs, max_len)

    def one_step():
        nonlocal caches, logits
        nxt = logits[:, :real_vocab].argmax(-1, keepdim=True)
        logits, caches = model.decode_step(params, nxt, caches)

    device_breakdown(one_prefill, f"{name} prefill", phase=phase)
    device_breakdown(one_step, f"{name} decode step", phase=phase)
    return p_s, d_s, peak


def serve_llms(dev, card: str, fops, sops, llm_err: dict) -> list:
    """Phase 6: the LLM serving main paths (LLM_RUNS), then the two LLM
    kernels' timings; returns their rows of the `kernels` line."""
    from repro_torch import backend
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk
    from repro_torch.models import get_model
    from repro_torch.models.params import count_params, init_params

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
        say("6", f"{arch}: {count_params(model.spec()) / 1e9:.4g} B "
                 f"parameters drawn on the card in "
                 f"{time.perf_counter() - t0:.2f} s (float32, "
                 f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                 f"allocated)")
        max_len = prompt + steps
        errs: dict = {}
        first: dict = {}
        flash, intra = llm_checked_ops(fops, sops, errs, first)
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
        if "flash" in errs:
            say("6", f"{arch}: flash launches against plain: "
                     + flash_errs_text(errs))
        if prefill_logits.shape != (batch, cfg.vocab) or logits.shape != (
                batch, cfg.vocab):
            fail(f"{arch}: logits shape {tuple(logits.shape)}")
        for what, lg in (("prefill", prefill_logits), ("decode", logits)):
            if not torch.isfinite(lg.float()).all():
                fail(f"{arch}: {what} logits not finite")
        say("6", f"{arch}: prefill {batch} x {prompt} + {steps} greedy "
                 f"decode steps; launches {launches}, variants {variants} "
                 f"(expected); every "
                 f"launch == plain on its own inputs (max abs err "
                 + ", ".join(f"{k} {errs[k]:.3g}" for k in ("flash", "ssd")
                             if k in errs) + ")")

        del caches
        inputs = {"tokens": toks}
        prefill_against_plain(
            "6", arch, model, params, inputs, max_len, prefill_logits,
            ((fops, "flash_attention", fops._plain),
             (sops, "ssd_intra_chunk", reference_intra_chunk)))
        serving_speed("6", arch, model, params, inputs, max_len, steps,
                      cfg.real_vocab, card)

        if cfg.family == "hybrid":
            # Information only: prefill(S) against prefill(S - 1) and one
            # decode step (the reference's check, tests/test_models.py).
            caches, _ = model.prefill(params, {"tokens": toks[:, :-1]},
                                      max_len)
            step_logits, _ = model.decode_step(params, toks[:, -1:], caches)
            diff = step_logits.float() - prefill_logits.float()
            say("6", f"{arch}: decode-vs-prefill consistency (information): "
                     f"max abs diff {float(diff.abs().max()):.4g}, relative "
                     f"RMS {rel_rms(step_logits, prefill_logits):.4g}")
            del caches
        timing_inputs.setdefault("flash", first.get("flash"))
        timing_inputs.setdefault(("ssd", arch), first["ssd"])
        del params, logits, prefill_logits
        torch.cuda.empty_cache()

    # Kernel times at the main-path shapes (`flash_times`, `ssd_times`).
    t = flash_times(fops, timing_inputs["flash"], "", "6", card)
    rows = [{
        "name": fops.NAME, "route": "cuda", "variant": t["variant"],
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
        "launches": launches_total.get(fops.NAME, 0),
        "max_abs_err": llm_err["flash"],
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "simt_ms")}}]
    ssd = [ssd_times(sops, timing_inputs["ssd", arch], f"{arch} layer: ",
                     "6", card) for arch, *_ in LLM_RUNS]
    t = ssd[0]                                         # zamba2-7b's layer
    rows.append({
        "name": sops.NAME, "route": "cuda", "variant": t["variant"],
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:29",
        "launches": launches_total.get(sops.NAME, 0),
        "max_abs_err": llm_err["ssd"],
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "simt_ms", "bound_f32_peak_ms")}})
    return rows


# Phase 12: the remaining LLM families, each run a main path of its own:
# (label, arch, smoke size, layers kept (None: all), batch, text tokens,
# image embeddings or encoder frames a row, decode steps).
FAMILY_RUNS = (
    ("a", "phi4-mini-3.8b", False, None, 4, 2048, 0, 16),
    ("b", "grok-1-314b", False, 2, 2, 2048, 0, 8),
    ("c", "pixtral-12b", False, None, 2, 1792, 256, 16),
    ("d", "seamless-m4t-large-v2", False, None, 4, 1536, 2048, 16),
    ("e", "stablelm-3b", True, None, 2, 40, 0, 3),
    ("e", "starcoder2-7b", True, None, 2, 40, 0, 3),
    ("e", "command-r-plus-104b", True, None, 2, 40, 0, 3),
    ("e", "kimi-k2-1t-a32b", True, None, 2, 40, 0, 3),
)
# The flash launch timed for phase 12's row of the kernels line: pixtral's
# prefill, [B, S, H, d] bf16 causal.
FAMILY_FLASH_SHAPE = (2, 2048, 32, 160)


def family_flash_launches(cfg, frames: int) -> int:
    """Flash launches of one prefill: one per decoder layer (prefill into
    the cache always takes the flash path), plus one per encoder layer when
    the encoder's frames outnumber `flash_block_q`."""
    enc = cfg.encoder_layers if frames > cfg.flash_block_q else 0
    return cfg.decoder_layers + enc


def llm_families_phase(dev, card: str, fops, sops) -> dict:
    """Phase 12: serve the dense, MoE, VLM and encoder-decoder families
    (FAMILY_RUNS) through `get_model`, `prefill` and `decode_step`, every
    flash launch held against the plain version on its own inputs and
    counted, each full-size prefill's logits against the plain-op prefill
    in float32 compute; then the flash kernel's times at pixtral's shape.
    Returns the flash row's additions to the kernels line."""
    import dataclasses as dc
    from repro_torch import backend
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import count_params, init_params

    t_phase = time.perf_counter()
    kernel_flash = fops.flash_attention
    kernel_moe = MOE.moe_block
    launches_by_run: dict = {}
    max_err = 0.0
    timing_inputs = None
    for label, arch, smoke, depth, batch, text, extra, steps in FAMILY_RUNS:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        if depth is not None:
            cfg = dc.replace(cfg, n_layers=depth)
        name = f"({label}) {arch}" + (" smoke" if smoke else "") + (
            f", {depth} of {get_config(arch).n_layers} layers"
            if depth else "")
        model = get_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(LLM_SEED)
        t0 = time.perf_counter()
        params = init_params(model.spec(), gen, dev)
        inputs = {"tokens": torch.randint(0, cfg.real_vocab, (batch, text),
                                          device=dev, generator=gen)}
        if cfg.family == "vlm":
            inputs["image_embeds"] = torch.randn(
                (batch, extra, cfg.d_model), device=dev, generator=gen)
        if cfg.family == "encdec":
            inputs["frames"] = torch.randn((batch, extra, cfg.d_model),
                                           device=dev, generator=gen)
        torch.cuda.synchronize()
        say("12", f"{name}: {count_params(model.spec()) / 1e9:.4g} B "
                  f"parameters drawn on the card in "
                  f"{time.perf_counter() - t0:.2f} s (float32, "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                  f"allocated)")
        seq = text + (extra if cfg.family == "vlm" else 0)
        max_len = seq + steps
        errs: dict = {}
        first: dict = {}
        moe_stats: list = []
        flash, _ = llm_checked_ops(fops, sops, errs, first)

        def recorded_moe(p, x, c):
            y, stats = kernel_moe(p, x, c)
            moe_stats.append((x.shape[1], stats))
            return y, stats

        fops.flash_attention, MOE.moe_block = flash, recorded_moe
        try:
            backend.reset_counters()              # main path starts here
            caches, logits = model.prefill(params, inputs, max_len)
            prefill_logits = logits
            for _ in range(steps):
                nxt = logits[:, :cfg.real_vocab].argmax(-1, keepdim=True)
                logits, caches = model.decode_step(params, nxt, caches)
            torch.cuda.synchronize()
            launches = dict(backend.COUNTERS["launches"])  # ... ends here
            variants = dict(backend.COUNTERS["variants"])
        finally:
            fops.flash_attention, MOE.moe_block = kernel_flash, kernel_moe
        n_flash = family_flash_launches(cfg, extra if cfg.family == "encdec"
                                        else 0)
        if launches != {fops.NAME: n_flash}:
            fail(f"{name}: main path launched {launches}, expected "
                 f"{{'{fops.NAME}': {n_flash}}}")
        if variants != {f"{fops.NAME}:wgmma": n_flash}:
            fail(f"{name}: main path launched the variants {variants}, "
                 f"expected every one the tensor-core kernel")
        launches_by_run[name] = n_flash
        max_err = max(max_err, errs.get("flash", 0.0))
        for what, lg in (("prefill", prefill_logits), ("decode", logits)):
            if lg.shape != (batch, cfg.vocab) or not torch.isfinite(
                    lg.float()).all():
                fail(f"{name}: {what} logits {tuple(lg.shape)} malformed "
                     f"or not finite")
        if isinstance(caches, tuple):                 # encdec
            kv, (mem_k, _) = caches
            if mem_k.shape != (cfg.decoder_layers, batch, extra,
                               cfg.n_kv_heads, cfg.resolved_head_dim) or \
                    kv.length.tolist() != [seq + steps] * cfg.decoder_layers:
                fail(f"{name}: encdec caches malformed")
        elif int(caches.length) != seq + steps:
            fail(f"{name}: cache length {int(caches.length)}, expected "
                 f"{seq + steps}")
        say("12", f"{name}: prefill {batch} x {seq}"
                  + (f" ({extra} image embeddings + {text} tokens)"
                     if cfg.family == "vlm" else "")
                  + (f" tokens over {extra} encoder frames"
                     if cfg.family == "encdec" else "")
                  + f" + {steps} greedy decode steps; launches {launches}, "
                  f"all wgmma (expected); every launch == plain on its own "
                  f"inputs ({flash_errs_text(errs)})")
        if cfg.moe is not None:
            pre = [st for n, st in moe_stats if n > 1]
            dec = [st for n, st in moe_stats if n == 1]
            tpe = sum(st["tokens_per_expert"] for st in pre)
            dec_drop = float(sum(st["drop_frac"] for st in dec)) / max(
                len(dec), 1)
            say("12", f"{name}: MoE prefill tokens_per_expert summed over "
                      f"{len(pre)} layers {[int(x) for x in tpe.tolist()]}, "
                      f"drop_frac per layer "
                      f"{[round(float(st['drop_frac']), 4) for st in pre]}; "
                      f"decode drop_frac mean over {len(dec)} layer steps "
                      f"{dec_drop:.4f}")
        del caches

        prefill_against_plain("12", name, model, params, inputs, max_len,
                              prefill_logits,
                              ((fops, "flash_attention", fops._plain),))
        serving_speed("12", name, model, params, inputs, max_len, steps,
                      cfg.real_vocab, card)
        if arch == "pixtral-12b":
            timing_inputs = first["flash"]
        del params, logits, prefill_logits, first, inputs
        torch.cuda.empty_cache()

    # The flash kernel at pixtral's prefill shape (`flash_times`).
    q = timing_inputs[0]
    if tuple(q.shape) != FAMILY_FLASH_SHAPE or q.dtype != torch.bfloat16:
        fail(f"pixtral's flash launch is {tuple(q.shape)} {q.dtype}, not "
             f"{FAMILY_FLASH_SHAPE} bf16")
    shape = flash_times(fops, timing_inputs, "pixtral-12b prefill: ", "12",
                        card)
    phase_s = time.perf_counter() - t_phase
    say("12", f"LLM families phase: {phase_s:.1f} s; flash launches per "
              f"run {json.dumps(launches_by_run)}")
    return {"launches": sum(launches_by_run.values()),
            "launches_by_run": launches_by_run, "max_abs_err": max_err,
            "shape": shape, "seconds": phase_s}


# Phase 13: training, each run a main path of its own: (label, arch, batch,
# sequence length), full size, TRAIN_STEPS timed steps after one warm-up.
TRAIN_RUNS = (("a", "stablelm-3b", 4, 2048), ("b", "mamba2-130m", 8, 2048))
TRAIN_STEPS = 3
# (c) kernel against plain in float32 compute: (arch, layers kept (None:
# all), batch, sequence length); loss and gradient-leaf bounds.
TRAIN_PLAIN_RUNS = (("stablelm-3b", 2, 2, 2048), ("mamba2-130m", None, 4,
                                                  2048))
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4
# A leaf whose plain-op gradient is below this share of the whole
# gradient's norm is held absolutely, to the bound times this share.
TRAIN_LEAF_FLOOR = 1e-4
# (d) the launcher at smoke size, and the laned step over a 2-process gloo
# group on the card.
TRAIN_LAUNCH = ["--arch", "mamba2-130m", "--smoke", "--batch", "4", "--seq",
                "64", "--log-every", "1", "--epoch-steps", "2"]
LANED_CHILD = r"""
import sys
import torch, torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import get_model
from repro_torch.random import prng_key
from repro_torch.train.laned_sync import compile_lane_variants
from repro_torch.train.train_step import init_train_state
from repro_torch import backend
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
dev = torch.device("cuda")
model = get_model(get_smoke_config("mamba2-130m"))
batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
    model.cfg, DataConfig(global_batch=8, seq_len=64)).host_slice(0).items()}
steps = compile_lane_variants(model, dist.group.WORLD, None, None,
                              {"total_steps": 10, "lr": 1e-2, "warmup": 1})
out = {}
for lanes in sorted(steps):
    state = init_train_state(model, prng_key(0, device=dev))
    for _ in range(2):
        state, metrics = steps[lanes](state, batch)
    torch.cuda.synchronize()
    out[lanes] = (float(metrics["loss"]), torch.cat(
        [p.reshape(-1) for p in (state["params"]["layers"]["mamba"]
                                 ["in_proj"],
                                 state["params"]["embed"]["embedding"])]))
same = all(torch.equal(out[w][1], out[1][1]) and out[w][0] == out[1][0]
           for w in out)
dist.destroy_process_group()
print("RESULT", same, out[1][0], backend.COUNTERS["launches"])
"""


def train_model_flops(cfg, count: int, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 per matmul parameter (every
    parameter but the embedding table) and token, plus three times the
    forward's attention (causal pairs) or SSD intra-chunk operations;
    rematerialization and the plain backward's recomputation not
    counted."""
    tokens = batch * seq
    flops = 6.0 * (count - cfg.vocab * cfg.d_model) * tokens
    if cfg.family == "ssm":
        s = cfg.ssm
        h = s.expand * cfg.d_model // s.head_dim
        nc = seq // s.chunk_len
        flops += 3.0 * cfg.n_layers * ssd_work(
            batch, nc, s.chunk_len, h, s.head_dim, s.n_groups, s.d_state,
            2)[1]
    else:
        flops += 3.0 * cfg.n_layers * flash_work(
            batch, seq, cfg.n_heads, cfg.resolved_head_dim, 2)[1]
    return flops


def rel_leaf_distances(got: list, want: list) -> list:
    total = float(torch.sqrt(sum(w.double().pow(2).sum() for w in want)))
    return [float((g.double() - w.double()).norm()
                  / max(float(w.double().norm()), TRAIN_LEAF_FLOOR * total))
            for g, w in zip(got, want)]


def train_phase(dev, card: str, fops, sops) -> dict:
    """Phase 13: training. (a) stablelm-3b and (b) mamba2-130m at full size
    (TRAIN_RUNS; the twin key's weights, the reference launcher's), each
    run a main path of its own: one warm-up step whose every kernel launch
    is held against the plain version, then TRAIN_STEPS timed steps
    (counters zeroed just before the first, read just after the last):
    flash / SSD launches twice a layer a step (forward and
    rematerialization, the tensor-core kernel), the backward the plain
    VJP once a layer (`backward_plain`); step ms, tokens/s, model FLOP/s
    against the bf16 peak, peak memory, one profiled step's idle share
    and top operations. (c) one step's loss and every gradient leaf with
    the kernels against the same step with their plain versions, float32
    compute (TRAIN_PLAIN_RUNS). (d) at smoke size: `launch.train.main`
    with the lane controller live, a checkpoint at step 2 resumed against
    the uninterrupted run (bit for bit, or as close as two uninterrupted
    runs), and the laned step over a 2-process gloo group on the card at
    lane widths 1, 2 and 4 (equal parameters). Returns the flash and SSD
    rows' additions to the kernels line."""
    import contextlib
    import dataclasses as dc
    import io
    import os
    import tempfile

    from repro_torch import backend
    from repro_torch import random as trandom
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk
    from repro_torch.launch import train as launch_train
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.models.params import (count_params, init_params,
                                           tree_leaves)
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              value_and_grad)

    t_phase = time.perf_counter()
    kernel_flash, kernel_intra = fops.flash_attention, sops.ssd_intra_chunk
    out = {"flash_attention": {"launches": 0, "runs": {}},
           "ssd_scan": {"launches": 0, "runs": {}}}
    short = {fops.NAME: "flash", sops.NAME: "ssd"}
    errs: dict = {}
    first: dict = {}        # each kernel's first training inputs, timed
    checked_flash, checked_intra = llm_checked_ops(fops, sops, errs, first)

    # --- (a), (b): full-size training runs ---------------------------------
    for label, arch, batch, seq in TRAIN_RUNS:
        cfg = get_config(arch)
        model = get_model(cfg)
        kname = sops.NAME if cfg.family == "ssm" else fops.NAME
        n_params = count_params(model.spec())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = init_train_state(model, trandom.prng_key(0, device=dev))
        torch.cuda.synchronize()
        say("13", f"({label}) {arch}: {n_params / 1e9:.4g} B parameters "
                  f"drawn on the card from the twin key prng_key(0) in "
                  f"{time.perf_counter() - t0:.2f} s (the reference's "
                  f"init_params bit for bit, in slices of the counter; "
                  f"draw peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                  f" GiB; train state "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f}"
                  f" GiB: float32 params, {cfg.optimizer} state)")
        data = SyntheticLM(cfg, DataConfig(global_batch=batch, seq_len=seq))

        def batch_at(step):
            return {k: torch.as_tensor(v, device=dev)
                    for k, v in data.host_slice(step).items()}

        step_fn = make_train_step(model)
        fops.flash_attention, sops.ssd_intra_chunk = checked_flash, \
            checked_intra
        try:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_at(0))
            warm_loss = float(metrics["loss"])
            warm_s = time.perf_counter() - t0
        finally:
            fops.flash_attention, sops.ssd_intra_chunk = kernel_flash, \
                kernel_intra
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times, skipped = [], [], []
        backend.reset_counters()                   # main path starts here
        for step in range(1, 1 + TRAIN_STEPS):
            b = batch_at(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
            skipped.append(int(metrics["skipped"]))
        launches = dict(backend.COUNTERS["launches"])  # ... ends here
        variants = dict(backend.COUNTERS["variants"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = cfg.n_layers * TRAIN_STEPS
        want_launches = {kname: 2 * n}
        want_variants = {f"{kname}:wgmma": 2 * n,
                         f"{kname}:backward_plain": n}
        if launches != want_launches or variants != want_variants:
            fail(f"({label}) {arch}: {TRAIN_STEPS} steps launched "
                 f"{launches}, variants {variants}; expected "
                 f"{want_launches}, {want_variants}")
        if not all(np.isfinite([warm_loss] + losses)) or any(skipped) \
                or not np.isfinite(float(metrics["grad_norm"])):
            fail(f"({label}) {arch}: losses {[warm_loss] + losses}, "
                 f"skipped {skipped}, grad norm "
                 f"{float(metrics['grad_norm'])}")
        step_s = float(np.median(times))
        flops = train_model_flops(cfg, n_params, batch, seq)
        say("13", f"({label}) {arch}: batch {batch} x {seq}, "
                  f"{cfg.optimizer}; warm-up step {warm_s:.2f} s (loss "
                  f"{warm_loss:.4f}; every kernel launch == plain: "
                  + (flash_errs_text(errs) if kname == fops.NAME else
                     f"max abs err {errs['ssd']:.3g}") + f"); {TRAIN_STEPS} "
                  f"timed steps, losses {[round(x, 4) for x in losses]}; "
                  f"per step {launches[kname] // TRAIN_STEPS} {kname} "
                  f"launches (forward + rematerialization, all wgmma) and "
                  f"{variants[f'{kname}:backward_plain'] // TRAIN_STEPS} "
                  f"backward_plain backward passes (expected)")
        say("13", f"({label}) {arch}: step {step_s * 1e3:.1f} ms (median of "
                  f"{TRAIN_STEPS}, host clock to float(loss); "
                  f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), "
                  f"{batch * seq / step_s:.6g} tokens/s, model "
                  f"{flops / step_s / 1e12:.1f} TFLOP/s = "
                  f"{flops / step_s / H100.peak_bf16_flops:.1%} of the "
                  f"{H100.peak_bf16_flops / 1e12:.0f} TFLOP/s dense bf16 "
                  f"peak "
                  f"({flops / 1e12:.2f} TFLOP a step: 6 N T + 3 x "
                  f"attention/SSD forward), peak memory {peak:.2f} GiB; "
                  f"card: {card}")

        def one_step():
            nonlocal state
            state, m = step_fn(state, batch_at(1 + TRAIN_STEPS))
            float(m["loss"])

        prof = device_breakdown(one_step, f"({label}) {arch} train step",
                                top=8, phase="13", ops=12)
        out[kname]["launches"] += launches[kname]
        out[kname]["runs"][arch] = {
            "batch": batch, "seq": seq, "step_ms": step_s * 1e3,
            "tokens_per_s": batch * seq / step_s,
            "model_tflops_per_s": flops / step_s / 1e12,
            "mfu": flops / step_s / H100.peak_bf16_flops, "peak_gib": peak,
            "launches_per_step": launches[kname] // TRAIN_STEPS,
            "backward_plain_per_step":
                variants[f"{kname}:backward_plain"] // TRAIN_STEPS,
            "idle": None if prof is None
            else 1 - sum(prof[1].values()) / 1e6 / prof[0]}
        del state, step_fn, metrics
        torch.cuda.empty_cache()
        times_of = flash_times if kname == fops.NAME else ssd_times
        out[kname]["shape"] = times_of(
            fops if kname == fops.NAME else sops, first[short[kname]],
            f"({label}) {arch} training: ", "13", card, backward=True)
    for kname, key in short.items():
        out[kname]["max_abs_err"] = errs[key]

    # --- (c): kernels against their plain versions, float32 compute -------
    for arch, layers, batch, seq in TRAIN_PLAIN_RUNS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dc.replace(cfg, n_layers=layers)
        model = get_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(LLM_SEED)
        params = init_params(model.spec(), gen, dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
            cfg, DataConfig(global_batch=batch, seq_len=seq))
            .host_slice(0).items()}
        kept = L.COMPUTE_DTYPE
        L.COMPUTE_DTYPE = torch.float32
        try:
            backend.reset_counters()
            loss_k, _, grads_k = value_and_grad(model, params, b)
            variants = dict(backend.COUNTERS["variants"])
            fops.flash_attention, sops.ssd_intra_chunk = fops._plain, \
                reference_intra_chunk
            backend.reset_counters()
            loss_p, _, grads_p = value_and_grad(model, params, b)
            plain_counts = (dict(backend.COUNTERS["launches"]),
                            dict(backend.COUNTERS["variants"]))
        finally:
            L.COMPUTE_DTYPE = kept
            fops.flash_attention, sops.ssd_intra_chunk = kernel_flash, \
                kernel_intra
        if plain_counts != ({}, {}):
            fail(f"(c) {arch}: the plain-op step went through a kernel "
                 f"route: launches, variants {plain_counts}")
        kname = sops.NAME if cfg.family == "ssm" else fops.NAME
        forward = sum(v for k, v in variants.items()
                      if k.startswith(f"{kname}:")
                      and k != f"{kname}:backward_plain")
        if not forward or not variants.get(f"{kname}:backward_plain"):
            fail(f"(c) {arch}: the kernel step's routes {variants} lack "
                 f"the {kname} kernel or its plain backward")
        leaves_k, leaves_p = tree_leaves(grads_k), tree_leaves(grads_p)
        missing = sum(g is None for g in leaves_k)
        rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        dists = rel_leaf_distances(leaves_k, leaves_p) if not missing \
            else []
        named = (("layers", "attn") if cfg.family != "ssm"
                 else ("layers", "mamba"))
        proj = grads_k[named[0]][named[1]]
        keys = ("wq", "wk", "wv", "wo") if cfg.family != "ssm" \
            else ("in_proj", "out_proj", "conv_w")
        zero = [k for k in keys if not bool(proj[k].abs().max() > 0)]
        name = f"{arch}" + (f", {layers} of {get_config(arch).n_layers} "
                            f"layers" if layers else "")
        if missing or zero or rel_loss > TRAIN_LOSS_RTOL \
                or max(dists) > TRAIN_GRAD_RTOL:
            fail(f"(c) {name}: kernel step against plain step: loss "
                 f"relative {rel_loss:.3g} (bound {TRAIN_LOSS_RTOL}), "
                 f"{missing} leaves without a gradient, zero projection "
                 f"gradients {zero}, worst leaf {max(dists or [0]):.3g} "
                 f"(bound {TRAIN_GRAD_RTOL})")
        say("13", f"(c) {name}, batch {batch} x {seq}, float32 compute: "
                  f"loss {float(loss_k):.6f} against the plain-op step's "
                  f"{float(loss_p):.6f} (relative {rel_loss:.3g}, bound "
                  f"{TRAIN_LOSS_RTOL}); all {len(leaves_k)} gradient leaves "
                  f"present, worst leaf relative RMS {max(dists):.3g} "
                  f"(bound {TRAIN_GRAD_RTOL}), {', '.join(keys)} nonzero; "
                  f"kernel routes {variants}")
        del params, grads_k, grads_p
        torch.cuda.empty_cache()

    # --- (d): the launcher, resume, the laned step -------------------------
    def launch(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            losses = launch_train.main(TRAIN_LAUNCH + list(extra))
        return losses, buf.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        full, log = launch("--steps", "4")
        again, _ = launch("--steps", "4")
        head, _ = launch("--steps", "2", "--ckpt-dir", tmp,
                         "--ckpt-every", "2")
        rest, log_c = launch("--steps", "4", "--ckpt-dir", tmp,
                             "--ckpt-every", "2", "--resume")
    if "[lanes] mean width" not in log or "[lanes] epoch" not in log:
        fail(f"(d) the launcher ran no lane-controller epoch:\n{log}")
    if "[train] resumed from step 2" not in log_c:
        fail(f"(d) the launcher did not resume:\n{log_c}")
    resumed = head + rest
    if resumed == full:
        verdict = "bit for bit"
    elif again != full and max(abs(a - b) for a, b in zip(resumed, full)) \
            <= max(abs(a - b) for a, b in zip(again, full)):
        spread = max(abs(a - b) for a, b in zip(again, full))
        verdict = (f"not bit for bit, but as close as two uninterrupted "
                   f"runs are to each other (the card's run-to-run "
                   f"difference {spread:.3g})")
    else:
        fail(f"(d) resumed losses {resumed} against the uninterrupted "
             f"{full} (a second uninterrupted run: {again})")
    lanes = [x for x in log.splitlines() if x.startswith("[lanes]")]
    say("13", f"(d) launch.train.main (mamba2-130m smoke, 4 steps): losses "
              f"{[round(x, 4) for x in full]}; lane controller: "
              + "; ".join(lanes) + f"; a checkpoint at step 2 resumed: "
              f"steps 2-3 {verdict} the uninterrupted run's")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, "-c", LANED_CHILD, str(r),
                               str(port)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    results = []
    for p in procs:
        try:
            text = p.communicate(timeout=600)[0]
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        line = [x for x in text.splitlines() if x.startswith("RESULT")]
        if p.returncode != 0 or not line or line[0].split()[1] != "True":
            fail(f"(d) laned step over a 2-process gloo group: rank exit "
                 f"{p.returncode}:\n{text[-3000:]}")
        results.append(line[0])
    say("13", f"(d) make_laned_train_step over a 2-process gloo group on "
              f"the card, lane widths 1, 2, 4, two steps each: parameters "
              f"equal across widths on both ranks ({'; '.join(results)})")
    phase_s = time.perf_counter() - t_phase
    say("13", f"training phase: {phase_s:.1f} s")
    out["seconds"] = phase_s
    return out


# Phase 14, the analysis on the card: (a) the whole dry run in this many
# worker processes; (b) bytes of the step analysed on the card's tensors
# within this relative distance of the same step on `meta`.
DRYRUN_JOBS = 6
ANALYSIS_BYTES_RTOL = 0.01
EXAMPLES = ("torch_serve_batch.py", "torch_noc_reconfig_demo.py")


def analysis_phase(dev, card: str, p13: Optional[dict] = None) -> dict:
    """Phase 14: the port's dry run and roofline on this machine's torch.
    (a) every (arch, shape) pair x both production meshes from one trace a
    pair on `meta` tensors (`launch.dryrun.run_pairs`, DRYRUN_JOBS worker
    processes), one line per record; any `error` fails; the H100 roofline
    of the 16 x 16 records written to build/analysis/ and printed. (b)
    phase 13's two training steps at phase 13's shapes (TRAIN_RUNS) on a
    one-device mesh, analysed once on `meta` and once on the card's tensors
    under the same counter: the FLOPs must be equal, the bytes within
    ANALYSIS_BYTES_RTOL, and the kernel calls credited on the card equal to
    the launch counters; the one-device roofline bound printed beside
    phase 13's measured step (information). (c) the two examples as child
    processes on the card: each must exit 0 and print every section
    header."""
    import importlib.util
    import os

    from repro_torch import backend
    from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import op_analysis as OA
    from repro_torch.models import get_model
    from repro_torch.models.params import tree_map
    from repro_torch.train.train_step import (abstract_train_state,
                                              make_train_step)

    t_phase = time.perf_counter()
    out = {}
    # --- (a) the whole dry run ---------------------------------------------
    t0 = time.perf_counter()
    pairs = [(a, s.name) for a in ARCH_NAMES for s in SHAPES]
    data, errors = {}, []
    for (arch, shape), recs in zip(pairs, dryrun.run_pairs(
            pairs, jobs=DRYRUN_JOBS)):
        for rec in recs:
            data[f"{arch}|{shape}|{rec['mesh']}"] = rec
            say("14", f"(a) {arch} x {shape} x {rec['mesh']}: "
                      f"{dryrun.describe(rec)}")
            if rec["status"] == "error":
                errors.append(f"{arch} x {shape} x {rec['mesh']}: "
                              f"{rec['error']}")
    if errors:
        fail("phase 14 (a) dry-run records in error:\n" + "\n".join(errors))
    counts = {k: sum(r["status"] == k for r in data.values())
              for k in ("ok", "skipped")}
    dry_s = time.perf_counter() - t0
    dry_path = dryrun.OUT
    dry_path.parent.mkdir(parents=True, exist_ok=True)
    dry_path.write_text(json.dumps(data, indent=1))
    rows = roofline.main(["--dryrun", str(dry_path)])
    say("14", f"(a) {len(data)} records ({counts['ok']} ok, "
              f"{counts['skipped']} skipped, 0 errors) under torch "
              f"{torch.__version__} in {dry_s:.1f} s; the H100 roofline of "
              f"the {len(rows)} 16x16 records (data-sheet peaks of an H100 "
              f"SXM5 80GB at 700 W: {H100.peak_bf16_flops / 1e12:.0f} "
              f"TFLOP/s bf16, {H100.hbm_bytes_per_s / 1e12:.2f} TB/s HBM, "
              f"NVLink {H100.nvlink_bytes_per_s / 1e9:.0f} GB/s within "
              f"{H100.nvlink_domain}, InfiniBand "
              f"{H100.ib_bytes_per_s / 1e9:.0f} GB/s past it) is in "
              f"{dry_path.parent / 'roofline.md'}; card: {card}")
    for r in rows:
        say("14", f"(a) roofline {r['arch']} {r['shape']}: compute "
                  f"{r['t_compute_s']:.3e} s, memory {r['t_memory_s']:.3e} "
                  f"s, collective {r['t_collective_s']:.3e} s, "
                  f"{r['dominant']}-bound, useful {r['useful_ratio']:.3f}, "
                  f"RF {r['roofline_fraction']:.4f}, peak "
                  f"{r['peak_gib']:.2f} GiB/device")
    out["dryrun"] = {"records": len(data), **counts, "seconds": dry_s,
                     "roofline": rows}

    # --- (b) the analysis against the card ---------------------------------
    out["steps"] = {}
    for label, arch, batch, seq in TRAIN_RUNS:
        model = get_model(get_config(arch))
        step = make_train_step(model)
        host = SyntheticLM(model.cfg, DataConfig(
            global_batch=batch, seq_len=seq)).host_slice(0)
        meta_state = abstract_train_state(model)
        meta_batch = {k: torch.empty(v.shape, dtype=torch.int32,
                                     device="meta") for k, v in host.items()}
        t0 = time.perf_counter()
        on_meta = OA.trace(step, meta_state, meta_batch)
        meta_s = time.perf_counter() - t0
        del meta_state
        state = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                               device=dev),
                         abstract_train_state(model))
        card_batch = {k: torch.as_tensor(v, device=dev)
                      for k, v in host.items()}
        torch.cuda.synchronize()
        backend.reset_counters()
        t0 = time.perf_counter()
        on_dev = OA.trace(step, state, card_batch)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launched = dict(backend.COUNTERS["launches"])
        credited = {k: v["calls"] for k, v in on_dev.kernels.items()}
        del state, card_batch
        torch.cuda.empty_cache()
        rel = abs(on_dev.bytes - on_meta.bytes) / on_meta.bytes
        meta_calls = {k: v["calls"] for k, v in on_meta.kernels.items()}
        if on_dev.flops != on_meta.flops or rel > ANALYSIS_BYTES_RTOL \
                or credited != launched or credited != meta_calls:
            fail(f"phase 14 (b) {arch}: FLOPs on meta {on_meta.flops:.6g}, "
                 f"on the card {on_dev.flops:.6g}; bytes {on_meta.bytes:.6g}"
                 f" / {on_dev.bytes:.6g} (relative {rel:.3g}, bound "
                 f"{ANALYSIS_BYTES_RTOL}); kernel calls credited on the "
                 f"card {credited}, on meta {meta_calls}, launched "
                 f"{launched}")
        t_c = on_meta.flops / H100.peak_bf16_flops
        t_m = on_meta.bytes / H100.hbm_bytes_per_s
        bound_ms = max(t_c, t_m) * 1e3
        kname = "ssd_scan" if model.cfg.family == "ssm" \
            else "flash_attention"
        measured = None if p13 is None \
            else p13[kname]["runs"][arch]["step_ms"]
        say("14", f"(b) {arch}, batch {batch} x {seq}, one device: FLOPs "
                  f"{on_meta.flops:.6e} on meta == on the card's tensors; "
                  f"bytes {on_meta.bytes:.6e} on meta, {on_dev.bytes:.6e} on "
                  f"the card (relative {rel:.3g}, bound "
                  f"{ANALYSIS_BYTES_RTOL}); kernel calls credited {credited}"
                  f" == launched {launched} == meta's; traced in "
                  f"{meta_s:.2f} s on meta, {card_s:.2f} s on the card; "
                  f"peak live {on_meta.peak_live_bytes / 2**30:.2f} GiB "
                  f"(meta) / {on_dev.peak_live_bytes / 2**30:.2f} GiB "
                  f"(card)")
        say("14", f"(b) {arch}: roofline bound {bound_ms:.1f} ms a step "
                  f"(compute {t_c * 1e3:.1f} ms at the bf16 peak, memory "
                  f"{t_m * 1e3:.1f} ms at the HBM rate; data-sheet peaks) "
                  + (f"against phase 13's measured {measured:.1f} ms: "
                     f"{bound_ms / measured:.1%} of the bound reached"
                     if measured else "(phase 13 did not run: no measured "
                     "step)") + f"; card: {card}")
        out["steps"][arch] = {
            "flops": on_meta.flops, "bytes_meta": on_meta.bytes,
            "bytes_card": on_dev.bytes, "kernels": credited,
            "bound_ms": bound_ms, "compute_ms": t_c * 1e3,
            "memory_ms": t_m * 1e3, "measured_ms": measured}

    # --- (c) the two examples on the card ----------------------------------
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out["examples"] = {}
    for name in EXAMPLES:
        path = ROOT / "examples" / name
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        headers = getattr(mod, "SECTIONS", None) or (mod.HEADER,)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(path)], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
        sec = time.perf_counter() - t0
        missing = [h for h in headers if f"== {h} ==" not in proc.stdout]
        if proc.returncode != 0 or missing:
            fail(f"phase 14 (c) examples/{name}: exit {proc.returncode}, "
                 f"missing sections {missing}:\n{proc.stdout[-2000:]}\n"
                 f"{proc.stderr[-3000:]}")
        say("14", f"(c) examples/{name} on the card: exit 0 in {sec:.1f} s, "
                  f"all {len(headers)} section headers printed")
        out["examples"][name] = sec
    phase_s = time.perf_counter() - t_phase
    say("14", f"analysis phase: {phase_s:.1f} s")
    out["seconds"] = phase_s
    return out


def stream_phase(dev, card: str) -> dict:
    """Phase 5, a main path of its own at the Table-1 widths (counters
    zeroed before (a), read after (d)): (a) the 8 PARSEC apps of Fig. 11
    (twin, seed 1) concatenated to 800 intervals, streamed per arch
    through a `SimSession` in STREAM_CHUNK-interval chunks (the ragged
    last one padded) and held bit for bit to one-shot `simulate`; (b)
    `session_tick` over TICK_LANES lanes x TICK_CHUNK intervals for
    TICK_COUNT ticks with per-lane destination matrices and one shared
    fault frame (a gateway fault and a link flap), lanes 0, 1 and the last
    held bit for bit to standalone sessions; (c) `sweep_faults` with
    SWEEP_FRAMES frames over one trace with l_m zipped in; (d) the F1
    cases past 128 chiplets / nodes (`kernels/*/cases.py`: RESIPI at 144
    and 256 chiplets clean, with destination matrices and with a fault
    frame, RESIPI_ALL at 256; noc_run on 12 x 12 and 16 x 16 meshes). Then
    every kernel call of the path is held against its plain version on its
    own inputs, and the host and device times, bounds and the design
    choice around ops.MIN_LANES are measured. Returns the rows the `kernels`
    line adds."""
    from repro_torch import backend, figures, interop
    from repro_torch import random as trandom
    from repro_torch.core import faults, traffic
    from repro_torch.core import simulator as S
    from repro_torch.kernels.epoch_step import cases as ecases
    from repro_torch.kernels.epoch_step import ops
    from repro_torch.kernels.epoch_step.ref import epoch_run_reference
    from repro_torch.kernels.noc_step import cases as ncases
    from repro_torch.kernels.noc_step import ops as nops
    from repro_torch.kernels.noc_step.ref import reference_noc_run

    apps = traffic.APP_NAMES
    cfg = S.SimConfig().cfg
    g_slots = cfg.max_gateways_per_chiplet
    # Inputs (set-up, before the counters are zeroed).
    f11 = figures.fig11_traces(T_INTERVALS, seed=1, device=dev)
    stream = traffic.concat_traces([f11[a] for a in apps])
    keys = trandom.split(trandom.prng_key(17, device=dev), TICK_LANES)
    lanes = [list(traffic.chunk_trace(traffic.generate(
        traffic.ParsecSpec(apps[i % len(apps)], TICK_CHUNK * TICK_COUNT),
        keys[i], dest=True, device=dev), TICK_CHUNK))
        for i in range(TICK_LANES)]
    frame = faults.compile_faults(
        [faults.GatewayFault(chiplet=1, slot=0, start=4, end=20),
         faults.LinkFlap(chiplet=2, p_down=0.2, p_up=0.5)],
        cfg, TICK_CHUNK, seed=3)
    frame_t = interop.fault_frame_from_numpy(frame, dev)
    sweep_trace = traffic.generate(traffic.ParsecSpec("dedup", T_INTERVALS),
                                   23, dest=True, device=dev)
    frames = [faults.compile_faults(
        [faults.LinkFlap(chiplet=k % 4, p_down=0.1 + 0.005 * k),
         faults.GatewayFault(chiplet=(k + 1) % 4, slot=k % g_slots,
                             start=k % 50, end=k % 50 + 30),
         faults.PcmStuckCell(chiplet=(k + 2) % 4, slot=(k + 1) % g_slots,
                             mode="on" if k % 2 else "off"),
         faults.LossDrift(db_per_interval=0.001 * (k % 8))],
        cfg, T_INTERVALS, seed=k) for k in range(SWEEP_FRAMES)]
    sweep_lm = np.linspace(0.004, 0.03, SWEEP_FRAMES).astype(np.float32)
    wide = [(c, interop.trace_from_numpy(c.trace, dev))
            for c in ecases.wide_cases(T_INTERVALS)]
    noc_wide = ncases.kernel_cases(dev, NOC_WIDE_CYCLES,
                                   names=ncases.WIDE_NAMES)

    calls, noc_calls = [], []
    kernel_epoch_run, kernel_noc_run = ops.epoch_run, nops.noc_run
    part = ""

    def recorded_epoch_run(state, xs, sim, tables, **kw):
        out = kernel_epoch_run(state, xs, sim, tables, **kw)
        calls.append((part, state, xs, sim, tables, kw, out))
        return out

    def recorded_noc_run(*args, **kw):
        out = kernel_noc_run(*args, **kw)
        noc_calls.append((part, args, kw, out))
        return out

    ops.epoch_run, nops.noc_run = recorded_epoch_run, recorded_noc_run
    torch.cuda.synchronize()
    backend.reset_counters()                     # main path starts
    # (a) streaming, every arch
    part = "stream"
    n_chunks = 0
    for arch in S.Arch:
        sim = S.SimConfig().with_arch(arch)
        one = S.simulate(stream, sim, device=dev)
        sess = S.SimSession.init(sim, device=dev)
        recs = [sess.step_chunk(c)["records"]
                for c in traffic.chunk_trace(stream, STREAM_CHUNK, pad=True)]
        n_chunks = len(recs)
        total = 8 * T_INTERVALS
        for k, v in one["records"].items():
            if not torch.equal(torch.cat([r[k] for r in recs])[:total], v):
                fail(f"streaming {arch.value}: chunked {k} differs from "
                     f"one-shot simulate")
        if sess.intervals_seen != total:
            fail(f"streaming {arch.value}: {sess.intervals_seen} intervals "
                 f"seen, expected {total}")
    # (b) session ticks
    part = "tick"
    sim = S.SimConfig()
    states = S.init_session_states(sim, TICK_LANES, device=dev)
    tables = S.selection_tables_torch(sim.cfg, dev)
    watched = (0, 1, TICK_LANES - 1)
    solo = {k: S.SimSession.init(sim, device=dev) for k in watched}
    tick_batches = []
    for tick in range(TICK_COUNT):
        chunks = [lane[tick] for lane in lanes]
        batch = {k: torch.stack([c[k] for c in chunks])
                 for k in ("ext_load", "mem_load", "int_load", "ext_frac",
                           "dest")}
        batch["t_mask"] = torch.ones((TICK_LANES, TICK_CHUNK), device=dev)
        tick_batches.append(batch)
        kept = state_fields(states)
        kept = {k: v.clone() for k, v in kept.items()}
        new, recs, sums = S.session_tick(states, batch, tables, sim,
                                         frame=frame_t)
        for k, v in state_fields(states).items():
            if not torch.equal(v, kept[k]):
                fail(f"session_tick changed the carry it was given ({k})")
        states = new
        for k in watched:
            out = solo[k].step_chunk(faults.attach_faults(chunks[k], frame))
            for n, v in out["records"].items():
                if not torch.equal(recs[n][k], v):
                    fail(f"tick {tick} lane {k}: {n} differs from a "
                         f"standalone session")
            mine = S.summary_from_sums({n: v[k] for n, v in sums.items()},
                                       sim.cfg.n_chiplets)
            for n, v in out["summary"].items():
                if not torch.equal(mine[n], v):
                    fail(f"tick {tick} lane {k}: sums ({n}) differ from a "
                         f"standalone session")
    # (c) a fault-frame sweep
    part = "sweep_faults"
    swept = S.sweep_faults(sweep_trace, sim, frames, device=dev, l_m=sweep_lm)
    # (d) the F1 cases
    part = "f1"
    for case, trace in wide:
        S.simulate(trace, case.sim, device=dev)
    for case in noc_wide:
        nops.noc_run(*case.args, **case.kwargs)
    torch.cuda.synchronize()
    launches = dict(backend.COUNTERS["launches"])      # main path ends
    variants = dict(backend.COUNTERS["variants"])
    ops.epoch_run, nops.noc_run = kernel_epoch_run, kernel_noc_run

    kernel_archs = sum(a in S.KERNEL_ARCHS for a in S.Arch)
    want = {f"{ops.NAME}:split": kernel_archs * (n_chunks + 1)
            + TICK_COUNT * (1 + len(watched)) + 1,
            f"{ops.NAME}:wide": len(wide),
            f"{nops.NAME}:node": len(noc_wide)}
    if variants != want:
        fail(f"phase 5 main path kernel variants {variants}, expected "
             f"{want}")
    say("5", f"main path: {json.dumps(launches)} launches, variants "
             f"{json.dumps(variants)}: (a) {len(list(S.Arch))} archs x "
             f"{n_chunks} chunks of {STREAM_CHUNK} ({8 * T_INTERVALS} "
             f"intervals) == "
             f"one-shot simulate bitwise; (b) {TICK_COUNT} ticks of "
             f"{TICK_LANES} lanes x {TICK_CHUNK}, lanes {watched} == "
             f"standalone sessions bitwise (records and sums), the carry "
             f"passed in unchanged; (c) sweep_faults {SWEEP_FRAMES} frames; "
             f"(d) {len(wide)} simulate calls past 128 chiplets, "
             f"{len(noc_wide)} noc_run calls past 128 nodes")
    for k, v in swept["summary"].items():
        if v.shape != (SWEEP_FRAMES,) or not torch.isfinite(v).all():
            fail(f"sweep_faults summary {k} malformed")

    # Every kernel call of the path against the plain version.
    err, checked = 0.0, {}
    for name, state0, xs, csim, tbl, kw, (got_state, got) in calls:
        want_state, want_recs = epoch_run_reference(state0, xs, csim, tbl,
                                                    **kw)
        e = max(compare(got, want_recs, f"phase 5 {name}"),
                compare(state_fields(got_state), state_fields(want_state),
                        f"phase 5 {name} state"))
        err = max(err, e)
        n, m = checked.get(name, (0, 0.0))
        checked[name] = (n + 1, max(m, e))
    noc_err = 0.0
    for name, args, kw, got in noc_calls:
        noc_err = max(noc_err, noc_compare(got, reference_noc_run(*args,
                                                                  **kw),
                                           f"phase 5 {name}"))
    say("5", "every kernel call == plain version on its own inputs: "
             + ", ".join(f"{k} {n} call(s) max abs err {m:.3g}"
                         for k, (n, m) in checked.items())
             + f"; noc_run past 128 nodes max abs err {noc_err:.3g}")

    # Host times (warm, host clock, each call ended by a synchronize).
    def host_ms(fn, reps):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    chunk0 = next(iter(traffic.chunk_trace(stream, STREAM_CHUNK)))
    for arch in S.Arch:
        sess = S.SimSession.init(S.SimConfig().with_arch(arch), device=dev)
        sess.step_chunk(chunk0)
        say("5", f"(a) {arch.value}: warm step_chunk ({STREAM_CHUNK} "
                 f"intervals) {host_ms(lambda: sess.step_chunk(chunk0), 9):.3f}"
                 f" ms (host clock, median of 9); card: {card}")
    tick = lambda: S.session_tick(states, tick_batches[0], tables, sim,  # noqa
                                  frame=frame_t)
    tick()
    tick_ms = host_ms(tick, 9)
    prof = device_breakdown(tick, "(b) session_tick warm", top=6, phase="5")
    idle = None if prof is None else \
        1.0 - sum(prof[1].values()) / 1e6 / prof[0]
    say("5", f"(b) session_tick warm: {tick_ms:.3f} ms a tick ({TICK_LANES} "
             f"lanes x {TICK_CHUNK} intervals; host clock, median of 9); "
             f"device idle share "
             f"{'not measured' if idle is None else f'{idle:.1%}'} "
             f"(profiled tick); card: {card}")
    sweep_ms = host_ms(lambda: S.sweep_faults(sweep_trace, sim, frames,
                                              device=dev, l_m=sweep_lm), 3)
    say("5", f"(c) sweep_faults {SWEEP_FRAMES} frames x {T_INTERVALS} "
             f"intervals: {sweep_ms:.3f} ms (entry point, host clock, "
             f"median of 3); card: {card}")

    # Device time per launch shape, beside its bound and the plain time.
    shape_calls = {"tick": next(c for c in calls if c[0] == "tick"
                                and int(c[5]["lane_trace"].shape[0])
                                == TICK_LANES),
                   "sweep_faults": next(c for c in calls
                                        if c[0] == "sweep_faults")}
    for (case, _), c in zip(wide, [c for c in calls if c[0] == "f1"]):
        shape_calls[case.name] = c
    epoch_rows = {}
    for label, (_, state0, xs, csim, tbl, kw, _) in shape_calls.items():
        kern = ops.variant(xs[0].shape[2], kw["faulted"],
                           kw["dest"] is not None, state0.ctl.g.shape[0])
        run = lambda: ops.launch(state0.ctl.g, xs, csim, tbl,  # noqa: E731
                                 **kw)
        ms = time_graph(run)
        plain = time_cuda(lambda: epoch_run_reference(state0, xs, csim, tbl,
                                                      **kw), 1)[0]
        n_tr, t_len, c = xs[0].shape
        n_lanes = int(kw["lane_trace"].shape[0])
        shared = kw["faulted"] and xs[5].stride(0) == 0
        # One trace expanded over the lanes (sweep_faults) is read once.
        n_read = 1 if xs[0].stride(0) == 0 else n_tr
        nbytes, n_ops = epoch_work(
            n_read, t_len, c, csim.cfg.max_gateways_per_chiplet, n_lanes,
            dest=kw["dest"] is not None,
            frames=(1 if shared else n_tr) if kw["faulted"] else 0)
        bound, by = max((nbytes / H100.hbm_bytes_per_s * 1e3, "bytes"),
                        (n_ops / H100.peak_f32_flops * 1e3, "operations"))
        epoch_rows[label] = {"variant": kern, "lanes": n_lanes,
                             "intervals": t_len, "chiplets": c, "ms": ms,
                             "plain_ms": plain, "bound_ms": bound,
                             "bound_by": by}
        say("5", f"epoch_step {label} launch ({kern}; {n_lanes} lane(s) x "
                 f"{t_len} intervals x {c} chiplets): {ms:.4f} ms (device: "
                 f"CUDA-graph replays, median of 5); plain version "
                 f"{plain:.2f} ms once; bound {bound:.4f} ms by {by} "
                 f"({nbytes / 1e6:.2f} MB, {n_ops / 1e9:.4f} GFLOP); card: "
                 f"{card}")
    noc_rows = {}
    for name, args, kw, _ in noc_calls:
        prep = nops.prepare(args[0][None], *args[1:], **kw)
        run = lambda: nops.run_prepared(prep)  # noqa: E731
        time_cuda(run, 2)
        ms = float(np.median(time_cuda(run, 5)))
        plain = time_cuda(lambda: reference_noc_run(*args, **kw), 1)[0]
        nbytes, n_ops = noc_work(prep, kw.get("t_mask") is not None,
                                 nops.MAX_IN_DEGREE)
        bound, by = max((nbytes / H100.hbm_bytes_per_s * 1e3, "bytes"),
                        (n_ops / H100.peak_f32_flops * 1e3, "operations"))
        label = f"R{args[0].shape[-1]}"
        noc_rows[label] = {"variant": "node", "nodes": args[0].shape[-1],
                           "cycles": args[0].shape[0], "ms": ms,
                           "plain_ms": plain, "bound_ms": bound,
                           "bound_by": by}
        say("5", f"noc_step node launch, {args[0].shape[-1]} nodes x "
                 f"{args[0].shape[0]} cycles: {ms:.4f} ms (CUDA events, "
                 f"median of 5); plain version {plain:.1f} ms once; bound "
                 f"{bound:.4f} ms by {by}; card: {card}")

    # The evidence for ops.variant's choice, around its thresholds.
    choice = epoch_design_grid(dev, card, GRID_DEFAULT, "5")
    return {"epoch_launches": launches.get(ops.NAME, 0),
            "noc_launches": launches.get(nops.NAME, 0),
            "epoch_err": err, "noc_err": noc_err, "epoch_shapes": epoch_rows,
            "noc_shapes": noc_rows, "design_choice": choice,
            "variants": variants}


def padded_epoch_work(n, t, c, g, lane_c, lane_g, pair_c=None) -> tuple:
    """(bytes read once + written once, float ops) of one padded
    epoch_step call (one topology per lane): `epoch_work`'s terms, plus
    per lane its topology rows (chiplet count, the two table rows of g
    levels, mesh hops, mesh feed, controller power) and its destination
    matrix index, with one [C, C] matrix and its trace index per distinct
    (trace, chiplet count) pair read instead of one matrix per trace
    (`pair_c`: each matrix's chiplet count; None without destination
    matrices). The operations count each lane's real chiplets only
    (`lane_c`, with `lane_g` gateway slots), and each matrix's trace-only
    pair terms once, over its real chiplets: what this run's data
    needs."""
    f = 4
    b = len(lane_c)
    dest = pair_c is not None
    mats = len(pair_c) if dest else 0
    read = (2 * n * t * c + 2 * n * t + mats * c * c) * f + mats * 4 \
        + b * (4 + 5 * f + c * f) \
        + b * (4 + 2 * g * f + 3 * f + (4 if dest else 0))
    written = b * t * (6 + 2 * c) * f + b * c * f
    lane_c = np.asarray(lane_c, np.float64)
    lane_g = np.asarray(lane_g, np.float64)
    ops_ = t * float(np.sum(OPS_PER_LANE + lane_c * OPS_PER_CHIPLET
                            + (lane_c ** 2 * OPS_PER_PAIR_LANE if dest
                               else 0.0)
                            + lane_c * lane_g * OPS_PER_SLOT))
    if dest:
        ops_ += t * float(np.sum(np.asarray(pair_c, np.float64) ** 2)) \
            * OPS_PER_PAIR_MATRIX
    return read + written, ops_


def topo_host_stages(S, ops, batch, sim, dev, grid, zipped=False) -> dict:
    """Information: host-clock milliseconds of the stages of one warm
    padded entry-point call, as `simulator._topo_run` runs them, each ended
    by a synchronize (median of 3): the stages of `topology_inputs` (its
    `on_stage` hook: `_prepare_topology_sweep` with the padded tables a
    cache hit, the trace arrays with `dest` narrowed and renormalized once,
    the lanes' knobs and topology rows, each (trace, chiplet count) pair's
    destination matrix with the second renormalization, the initial
    state), the kernel wrapper's launch, `_reassemble` and the summaries;
    and `prepare` again with the padded-table caches cleared first
    (`prepare_tables_uncached`: the table build of a first call)."""
    from repro_torch.core import selection as tsel

    stages = {}

    def run(tables_cold: bool):
        if tables_cold:
            tsel.clear_padded_table_caches()
        torch.cuda.synchronize()
        marks = [("", time.perf_counter())]

        def mark(name):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))

        sim_p, state0, xs, kw, nreal = S.topology_inputs(
            batch, sim, device=dev, zipped=zipped, on_stage=mark, **grid)
        if tables_cold:
            stages.setdefault("prepare_tables_uncached", []).append(
                (marks[1][1] - marks[0][1]) * 1e3)
            return
        out = ops.launch(state0.ctl.g, xs, sim_p, None, **kw)
        mark("launch")
        _, recs = ops._reassemble(state0, out, xs, sim_p, False, kw["topo"])
        mark("_reassemble")
        S._summary_from_sums(S._record_sums(recs, xs[4][kw["lane_trace"]]),
                             nreal)
        mark("summaries")
        for (_, a), (name, b) in zip(marks, marks[1:]):
            stages.setdefault(name, []).append((b - a) * 1e3)

    for _ in range(3):
        run(False)
    for _ in range(3):
        run(True)
    return {k: float(np.median(v)) for k, v in stages.items()}


def topology_phase(dev, card: str) -> dict:
    """Phase 7, the topology and placement DSE, a main path of its own
    (counters zeroed before (a), read after (e)): (a) the reference's
    walkthrough scan (canneal, 16 intervals from prng_key(1) at 256
    chiplets, WALK_COUNTS under RESIPI: one padded launch of 7 lanes at
    C = 256), held to WALK_REFERENCE at the printed digits, then the same
    grid under PROWAVES and AWGR (the plain loop); (b) `sweep_topology_batch`
    over the 8 PARSEC apps with destination matrices at 256 chiplets, T =
    100, x TOPO_C x TOPO_G (28 points, 224 lanes), RESIPI and RESIPI_ALL;
    (c) the 8 apps at 16 chiplets x SPLIT_C x SPLIT_G x KNOB_LM l_m values
    zipped (1024 points, 8192 lanes: "split"); (d) `sweep_workload` over one
    spec of each family (32-128 intervals, destination matrices) zipped
    with WORKLOAD_C; (e) `sweep_placement` over PLACEMENT_COUNT seeded
    random placements on the Table-1 system, and the host
    `search_placement` with the walkthrough's settings, held to
    SEARCH_REFERENCE. Each RESIPI / RESIPI_ALL sweep must be one epoch_step
    launch; every launch is held against the padded plain loop (records,
    final state; padded chiplet columns exactly 0), and lane (app 0, 256
    chiplets, 4 gateways) of (b) against an unpadded `simulate`. Then per
    new launch shape its device time, the plain loop's, the bound, the warm
    host ms of the entry point and its host stages."""
    from repro_torch import backend
    from repro_torch import random as trandom
    from repro_torch.core import selection as tsel
    from repro_torch.core import topology, traffic
    from repro_torch.core import simulator as S
    from repro_torch.core.constants import NETWORK
    from repro_torch.kernels.epoch_step import ops
    from repro_torch.kernels.epoch_step.ref import epoch_run_reference

    Arch = S.Arch
    resipi = S.SimConfig()
    cfg256 = NETWORK.with_topology(n_chiplets=max(TOPO_C))
    cfg16 = NETWORK.with_topology(n_chiplets=max(SPLIT_C))
    # Inputs (set-up, before the counters are zeroed).
    walk = traffic.generate_trace("canneal", 16,
                                  trandom.prng_key(1, device=dev), cfg256,
                                  device=dev)
    dse = list(traffic.all_app_traces(T_INTERVALS, 21, cfg256, dest=True,
                                      device=dev).values())
    dse_grid = {"n_chiplets": [c for c in TOPO_C for _ in TOPO_G],
                "gateways_per_chiplet": [g for _ in TOPO_C for g in TOPO_G]}
    small = list(traffic.all_app_traces(T_INTERVALS, 31, cfg16, dest=True,
                                        device=dev).values())
    per_cg = [(c, g) for c in SPLIT_C for g in SPLIT_G]
    split_grid = {
        "n_chiplets": [c for c, _ in per_cg for _ in range(KNOB_LM)],
        "gateways_per_chiplet": [g for _, g in per_cg
                                 for _ in range(KNOB_LM)],
        "l_m": np.tile(np.linspace(0.004, 0.032, KNOB_LM, dtype=np.float32),
                       len(per_cg))}
    specs = [traffic.UniformSpec(n_intervals=32),
             traffic.HotspotSpec(n_intervals=48),
             traffic.PermutationSpec(pattern="transpose", n_intervals=64),
             traffic.PermutationSpec(pattern="tornado", n_intervals=80),
             traffic.PermutationSpec(pattern="bit_complement",
                                     n_intervals=96),
             traffic.PermutationSpec(pattern="neighbor", n_intervals=112),
             traffic.BurstySpec(n_intervals=128),
             traffic.ParsecSpec("dedup", T_INTERVALS)]
    rng = np.random.RandomState(7)
    routers = [tuple(int(v) for v in r)
               for r in topology.router_coords(NETWORK)]
    placements = [tsel.normalize_placement(
        [routers[i] for i in rng.choice(len(routers), 4, replace=False)],
        NETWORK, order="spread") for _ in range(PLACEMENT_COUNT)]
    place_tr = traffic.generate(traffic.ParsecSpec("dedup", T_INTERVALS), 41,
                                dest=True, device=dev)
    search_tr = traffic.generate_trace("dedup", 24,
                                       trandom.prng_key(2, device=dev),
                                       device=dev)

    calls, per_call = [], {}
    kernel_epoch_run = ops.epoch_run
    part = ""

    def recorded_epoch_run(state, xs, sim, tables, **kw):
        out = kernel_epoch_run(state, xs, sim, tables, **kw)
        calls.append((part, state, xs, sim, tables, kw, out))
        return out

    def counted(label, fn):
        before = backend.COUNTERS["launches"].get(ops.NAME, 0)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        per_call[label] = (backend.COUNTERS["launches"].get(ops.NAME, 0)
                           - before, (time.perf_counter() - t0) * 1e3)
        return out

    entry = {
        "walk-resipi": lambda: S.sweep_topology(
            walk, resipi, device=dev, n_chiplets=list(WALK_COUNTS)),
        "walk-prowaves": lambda: S.sweep_topology(
            walk, resipi.with_arch(Arch.PROWAVES), device=dev,
            n_chiplets=list(WALK_COUNTS)),
        "walk-awgr": lambda: S.sweep_topology(
            walk, resipi.with_arch(Arch.AWGR), device=dev,
            n_chiplets=list(WALK_COUNTS)),
        "dse-resipi": lambda: S.sweep_topology_batch(
            dse, resipi, device=dev, **dse_grid),
        "dse-resipi_all": lambda: S.sweep_topology_batch(
            dse, resipi.with_arch(Arch.RESIPI_ALL), device=dev, **dse_grid),
        "split-dse": lambda: S.sweep_topology_batch(
            small, resipi, device=dev, **split_grid),
        "workload": lambda: S.sweep_workload(
            specs, resipi, seed=5, dest=True, device=dev,
            n_chiplets=list(WORKLOAD_C)),
        "placement": lambda: S.sweep_placement(place_tr, resipi, placements,
                                               device=dev),
        "search": lambda: S.search_placement(
            search_tr, resipi, generations=SEARCH_GENERATIONS,
            population=SEARCH_POPULATION, seed=0, engine="host",
            device=dev)}
    ops.epoch_run = recorded_epoch_run
    torch.cuda.synchronize()
    backend.reset_counters()                     # main path starts
    outs = {}
    for label, fn in entry.items():
        part = label
        outs[label] = counted(label, fn)
    torch.cuda.synchronize()
    launches = dict(backend.COUNTERS["launches"])      # main path ends
    variants = dict(backend.COUNTERS["variants"])
    loop_runs = backend.COUNTERS["loop_runs"]
    ops.epoch_run = kernel_epoch_run

    want_launches = {k: (SEARCH_GENERATIONS if k == "search"
                         else 0 if k in ("walk-prowaves", "walk-awgr")
                         else 1) for k in entry}
    got_launches = {k: v[0] for k, v in per_call.items()}
    if got_launches != want_launches:
        fail(f"phase 7 epoch_step launches per call {got_launches}, "
             f"expected {want_launches}")
    want = {f"{ops.NAME}:wide+topo": 4,
            f"{ops.NAME}:split+topo": 2 + SEARCH_GENERATIONS}
    if variants != want:
        fail(f"phase 7 main path kernel variants {variants}, expected "
             f"{want}")
    say("7", f"main path: {json.dumps(launches)} launches, variants "
             f"{json.dumps(variants)}, {loop_runs} plain-loop runs "
             f"(PROWAVES and AWGR); epoch_step launches per call "
             f"{json.dumps(got_launches)}; host ms per call (first, cold "
             f"caches): " + ", ".join(f"{k} {v[1]:.1f}"
                                      for k, v in per_call.items())
             + f"; card: {card}")

    # (a) the reference's walkthrough at its printed digits.
    summ = outs["walk-resipi"]["summary"]
    for i, c in enumerate(WALK_COUNTS):
        got = (f"{float(summ['mean_latency'][i]):.2f}",
               f"{float(summ['mean_power_mw'][i]):.0f}",
               f"{float(summ['mean_gateways'][i]):.1f}")
        if got != WALK_REFERENCE[c]:
            fail(f"walkthrough at {c} chiplets: latency / power / mean GT "
                 f"{got}, the reference prints {WALK_REFERENCE[c]}")
    say("7", "(a) walkthrough scan (canneal, 16 intervals, 16-256 "
             "chiplets): latency / power mW / mean GT " + "; ".join(
                 f"{c}: {' / '.join(WALK_REFERENCE[c])}"
                 for c in WALK_COUNTS) + " == the reference's digits")
    for label in ("walk-prowaves", "walk-awgr"):
        for k, v in outs[label]["summary"].items():
            if v.shape != (len(WALK_COUNTS),) or not torch.isfinite(v).all():
                fail(f"{label} summary {k} malformed")
    # (b), (c), (d), (e): shapes and finite summaries.
    shapes = {"dse-resipi": (len(dse), len(TOPO_C) * len(TOPO_G)),
              "dse-resipi_all": (len(dse), len(TOPO_C) * len(TOPO_G)),
              "split-dse": (len(small), len(per_cg) * KNOB_LM),
              "workload": (len(specs),), "placement": (PLACEMENT_COUNT,)}
    for label, shape in shapes.items():
        for k, v in outs[label]["summary"].items():
            if tuple(v.shape) != shape or not torch.isfinite(v).all():
                fail(f"{label} summary {k}: shape {tuple(v.shape)}, "
                     f"expected {shape}, or not finite")
    res = outs["search"]
    if res["best_placement"] != SEARCH_REFERENCE["best_placement"] \
            or not np.isclose(res["best_score"],
                              SEARCH_REFERENCE["best_score"], rtol=1e-5) \
            or not np.isclose(res["default_score"],
                              SEARCH_REFERENCE["default_score"], rtol=1e-5):
        fail(f"host search: best {res['best_placement']} at "
             f"{res['best_score']!r} (default {res['default_score']!r}); "
             f"the reference's host engine: {SEARCH_REFERENCE}")
    say("7", f"(e) host search ({SEARCH_GENERATIONS} generations of "
             f"{SEARCH_POPULATION}, {got_launches['search']} epoch_step "
             f"launches, one a generation): best {res['best_placement']} at "
             f"{res['best_score']:.6f} (default {res['default_score']:.6f}) "
             f"== the reference host engine's "
             f"{SEARCH_REFERENCE['best_placement']} at "
             f"{SEARCH_REFERENCE['best_score']:.6f}")

    # Lane (app 0, 256 chiplets, 4 gateways) of (b) against an unpadded
    # simulate of that topology.
    k_last = len(TOPO_C) * len(TOPO_G) - 1
    single = S.simulate(dse[0], S.topology_point_config(
        resipi, n_chiplets=TOPO_C[-1], gateways_per_chiplet=TOPO_G[-1]),
        device=dev)
    lane = {part: {k: v[0, k_last] for k, v in
                   outs["dse-resipi"][part].items()}
            for part in ("records", "summary")}
    own_err = max(compare(lane["records"], single["records"],
                          "(b) lane (app 0, 256, 4) vs simulate"),
                  compare(lane["summary"], single["summary"],
                          "(b) lane (app 0, 256, 4) summary vs simulate"))

    # Every kernel call of the path against the padded plain loop.
    err, checked = 0.0, {}
    for name, state0, xs, csim, tbl, kw, (got_state, got) in calls:
        t0 = time.perf_counter()
        want_state, want_recs = epoch_run_reference(state0, xs, csim, tbl,
                                                    **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        e = max(compare(got, want_recs, f"phase 7 {name}"),
                compare(state_fields(got_state), state_fields(want_state),
                        f"phase 7 {name} state"))
        dead = kw["topo"]["chip_mask"][:, None, :] == 0
        for k in ("g", "gw_load", "wavelengths"):
            if bool((got[k].masked_select(dead) != 0).any()):
                fail(f"phase 7 {name}: a padded chiplet's {k} is not 0")
        err = max(err, e)
        n, m, s_ = checked.get(name, (0, 0.0, 0.0))
        checked[name] = (n + 1, max(m, e), s_ + plain_s)
    say("7", "every kernel call == the padded plain loop on its own inputs "
             "(padded columns exactly 0): " + ", ".join(
                 f"{k} {n} call(s) max abs err {m:.3g} (plain {s_:.1f} s)"
                 for k, (n, m, s_) in checked.items())
             + f"; (b) lane (app 0, 256 chiplets, 4 gateways) == unpadded "
               f"simulate (max abs err {own_err:.3g})")

    # Host times (warm, host clock, each call ended by a synchronize).
    def host_ms(fn, reps):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    warm = {label: host_ms(fn, 1 if label == "search" else 3)
            for label, fn in entry.items()}
    say("7", "warm host ms of each entry point (host clock, median of 3; "
             "the search once): " + ", ".join(f"{k} {v:.2f}"
                                              for k, v in warm.items())
             + f"; card: {card}")
    stage_rows, idle = {}, {}
    for label, batch, grid, zipped in (
            ("dse-resipi", dse, dse_grid, False),
            ("split-dse", small, split_grid, False)):
        stage_rows[label] = topo_host_stages(S, ops, batch, resipi, dev,
                                             grid, zipped)
        say("7", f"{label} warm host stages (each ended by a synchronize; "
                 f"median of 3): " + ", ".join(
                     f"{k} {v:.3f} ms" for k, v in stage_rows[label].items()))
        prof = device_breakdown(entry[label], f"{label} warm", top=4,
                                phase="7")
        idle[label] = None if prof is None else \
            1.0 - sum(prof[1].values()) / 1e6 / prof[0]
        say("7", f"{label} warm: device idle share "
                 f"{'not measured' if idle[label] is None else f'{idle[label]:.1%}'}"
                 f" of a profiled call; card: {card}")

    # Device time per launch shape, beside the plain loop's and the bound.
    shape_calls = {}
    for c in calls:
        key = c[0] if c[0] != "search" else "search-generation"
        shape_calls.setdefault(key, c)
    rows = {}
    for label, (_, state0, xs, csim, tbl, kw, _) in shape_calls.items():
        n_tr, t_len, c = xs[0].shape
        n_lanes = int(kw["lane_trace"].shape[0])
        dest = kw.get("dest") is not None
        kern = ops.variant(c, False, dest, n_lanes, padded=True)
        ms = time_graph(lambda: ops.launch(state0.ctl.g, xs,  # noqa: B023
                                           csim, tbl, **kw))
        plain = time_cuda(lambda: epoch_run_reference(  # noqa: B023
            state0, xs, csim, tbl, **kw), 1)[0]
        lane_c = kw["topo"]["n_chiplets"].cpu().numpy()
        lane_g = kw["topo"]["g_max"].cpu().numpy()
        mats = int(kw["dest"].shape[0]) if dest else 0
        pair_c = None
        if dest:
            pair_c = np.zeros(mats, np.int64)
            pair_c[kw["dest_index"].cpu().numpy()] = lane_c
        nbytes, n_ops = padded_epoch_work(
            n_tr, t_len, c, csim.cfg.max_gateways_per_chiplet, lane_c,
            lane_g, pair_c)
        bound, by = max((nbytes / H100.hbm_bytes_per_s * 1e3, "bytes"),
                        (n_ops / H100.peak_f32_flops * 1e3, "operations"))
        row = {"variant": kern + "+topo", "lanes": n_lanes,
               "intervals": t_len, "chiplets": c, "dest_matrices": mats,
               "ms": ms, "plain_ms": plain, "bound_ms": bound,
               "bound_by": by, "host_ms": warm.get(
                   label if label != "search-generation" else "search")}
        extra = ""
        if c > ops.SPLIT_MAX_CHIPLETS and c <= ops.WARP_MAX_CHIPLETS:
            # "warp" takes no topology rows: the unpadded warp launch at
            # the same lanes and width (every lane at c chiplets, each
            # lane's own matrix) beside the padded wide one.
            ukw = {k: v for k, v in kw.items()
                   if k not in ("topo", "dest_index", "pair_trace")}
            utbl = S.selection_tables_torch(csim.cfg, dev)
            row["unpadded_warp_ms"] = time_graph(
                lambda: ops.launch(state0.ctl.g, xs, csim,  # noqa: B023
                                   utbl, kernel="warp", **ukw))
            row["unpadded_wide_ms"] = time_graph(
                lambda: ops.launch(state0.ctl.g, xs, csim,  # noqa: B023
                                   utbl, kernel="wide", **ukw))
            extra = (f"; the unpadded launch at the same lanes and width: "
                     f"warp {row['unpadded_warp_ms']:.4f} ms, wide "
                     f"{row['unpadded_wide_ms']:.4f} ms")
        rows[label] = row
        say("7", f"epoch_step {label} launch ({kern}+topo; {n_lanes} "
                 f"lane(s) x {t_len} intervals x {c} chiplets"
                 f"{f', {mats} destination matrices' if dest else ''}): "
                 f"{ms:.4f} ms (device: CUDA-graph replays, median of 5); "
                 f"plain loop {plain:.2f} ms once; bound {bound:.4f} ms by "
                 f"{by} ({nbytes / 1e6:.2f} MB, {n_ops / 1e9:.4f} GFLOP)"
                 f"{extra}; card: {card}")
    return {"epoch_launches": launches.get(ops.NAME, 0), "epoch_err": err,
            "epoch_shapes": rows, "variants": variants,
            "host_stages": stage_rows, "warm_host_ms": warm,
            "idle_share": idle}


def search_phase(dev, card: str) -> dict:
    """Phase 8, the device placement search, a main path of its own
    (counters zeroed before (a), read after (e)): (a) the walkthrough's
    search, (b) its island search and (c) the resilience form, each held
    to the reference device engine's placements, accepted flags and
    printed scores (SEARCH_DEVICE_REFERENCE, ISLAND_REFERENCE,
    RESILIENCE_REFERENCE); (d) DSE_ISLANDS islands x DSE_POPULATION x
    DSE_GENERATIONS at 100 intervals ("split+topo", 2048 lanes a launch);
    (e) WIDE_SEARCH_ISLANDS islands at WIDE_SEARCH_C chiplets with a
    destination matrix ("wide+topo"). Every generation loop runs under
    `torch.cuda.set_sync_debug_mode("error")`; each search must make
    `generations` epoch_step launches and count one `search_dispatches`;
    every launch is held against the padded plain loop on its inputs.
    Then per launch shape its device time (CUDA-graph replays of one
    generation's launch), the plain loop's and the bound; the warm host ms
    per search and per generation, candidate evaluations per second, the
    device idle share of a profiled warm (d), and (a) beside the host
    engine on the same configuration."""
    from repro_torch import backend
    from repro_torch import random as trandom
    from repro_torch.core import search as tsearch
    from repro_torch.core import simulator as S
    from repro_torch.core import traffic
    from repro_torch.core.constants import NETWORK
    from repro_torch.kernels.epoch_step import ops
    from repro_torch.kernels.epoch_step.ref import epoch_run_reference

    resipi = S.SimConfig()
    cfg_wide = NETWORK.with_topology(n_chiplets=WIDE_SEARCH_C)
    sim_wide = S.SimConfig(cfg=cfg_wide)
    # Inputs (set-up, before the counters are zeroed).
    tr_a = traffic.generate_trace("dedup", 24,
                                  trandom.prng_key(2, device=dev),
                                  device=dev)
    tr_b = traffic.generate_trace("dedup", 24,
                                  trandom.prng_key(3, device=dev),
                                  device=dev)
    tr_d = traffic.generate_trace("dedup", T_INTERVALS,
                                  trandom.prng_key(5, device=dev),
                                  device=dev)
    tr_e = traffic.generate(traffic.ParsecSpec("dedup", T_INTERVALS),
                            trandom.prng_key(6, device=dev), cfg_wide,
                            dest=True, device=dev)
    init_c = tsearch.repair_placement(
        SEARCH_DEVICE_REFERENCE["best_placement"], RESILIENCE_BLOCKED,
        NETWORK)
    if init_c != RESILIENCE_REFERENCE["init"]:
        fail(f"(c) repair_placement gave {init_c}, the reference "
             f"{RESILIENCE_REFERENCE['init']}")
    dse_lm = np.linspace(0.004, 0.032, DSE_ISLANDS, dtype=np.float32)
    gens = {"a": SEARCH_GENERATIONS, "b": SEARCH_GENERATIONS,
            "c": SEARCH_GENERATIONS, "d": DSE_GENERATIONS,
            "e": SEARCH_GENERATIONS}
    entry = {
        "a": lambda: S.search_placement(
            tr_a, resipi, generations=gens["a"],
            population=SEARCH_POPULATION, seed=0, device=dev),
        "b": lambda: S.search_placement_islands(
            tr_b, resipi, generations=gens["b"],
            population=SEARCH_POPULATION, seed=0, l_m=list(ISLAND_LM),
            device=dev),
        "c": lambda: S.search_placement(
            tr_a, resipi, generations=gens["c"],
            population=SEARCH_POPULATION, seed=1, init=init_c,
            blocked_positions=RESILIENCE_BLOCKED, device=dev),
        "d": lambda: S.search_placement_islands(
            tr_d, resipi, generations=gens["d"], population=DSE_POPULATION,
            seed=0, l_m=dse_lm, device=dev),
        "e": lambda: S.search_placement_islands(
            tr_e, sim_wide, islands=WIDE_SEARCH_ISLANDS,
            generations=gens["e"], population=SEARCH_POPULATION, seed=0,
            device=dev)}
    lanes = {"a": SEARCH_POPULATION,
             "b": len(ISLAND_LM) * SEARCH_POPULATION,
             "c": SEARCH_POPULATION, "d": DSE_ISLANDS * DSE_POPULATION,
             "e": WIDE_SEARCH_ISLANDS * SEARCH_POPULATION}

    calls, per_call, loop_ms = [], {}, []
    kernel_epoch_run, real_core = ops.epoch_run, tsearch._search_core
    part = ""

    def recorded_epoch_run(state, xs, sim, tables, **kw):
        out = kernel_epoch_run(state, xs, sim, tables, **kw)
        calls.append((part, state, xs, sim, tables, kw, out))
        return out

    def checked_core(*args, **kw):
        # The generation loop: no host synchronization may happen inside.
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            return real_core(*args, **kw)
        finally:
            loop_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.set_sync_debug_mode(0)

    ops.epoch_run = recorded_epoch_run
    tsearch._search_core = checked_core
    torch.cuda.synchronize()
    S.reset_engine_stats()                       # main path starts
    outs = {}
    try:
        for label, fn in entry.items():
            part = label
            before = backend.COUNTERS["launches"].get(ops.NAME, 0)
            dispatches = S.engine_stats()["search_dispatches"]
            t0 = time.perf_counter()
            outs[label] = fn()
            torch.cuda.synchronize()
            per_call[label] = (
                backend.COUNTERS["launches"].get(ops.NAME, 0) - before,
                S.engine_stats()["search_dispatches"] - dispatches,
                (time.perf_counter() - t0) * 1e3, loop_ms[-1])
        torch.cuda.synchronize()
        launches = dict(backend.COUNTERS["launches"])   # main path ends
        variants = dict(backend.COUNTERS["variants"])
        loop_runs = backend.COUNTERS["loop_runs"]
    finally:
        ops.epoch_run = kernel_epoch_run
        tsearch._search_core = real_core

    got = {k: v[:2] for k, v in per_call.items()}
    want = {k: (g, 1) for k, g in gens.items()}
    if got != want:
        fail(f"phase 8 (epoch_step launches, search_dispatches) per search "
             f"{got}, expected {want}")
    want_variants = {f"{ops.NAME}:split+topo": sum(
                         g for k, g in gens.items() if k != "e"),
                     f"{ops.NAME}:wide+topo": gens["e"]}
    if variants != want_variants or loop_runs:
        fail(f"phase 8 main path kernel variants {variants} and "
             f"{loop_runs} plain-loop runs, expected {want_variants}, 0")
    say("8", f"main path: {json.dumps(launches)} launches, variants "
             f"{json.dumps(variants)}; per search (launches, dispatches): "
             f"{json.dumps(got)}; every generation loop ran under "
             f"set_sync_debug_mode('error'); host ms per search (first): "
             + ", ".join(f"{k} {v[2]:.1f} (loop {v[3]:.1f})"
                         for k, v in per_call.items()) + f"; card: {card}")

    # (a), (c): the reference's device engine at its printed digits.
    def held(label, res, ref):
        flags = tuple(h["accepted"] for h in res["history"])
        for key in ("best_placement", "incumbent_placement",
                    "default_placement"):
            if res[key] != ref[key]:
                fail(f"({label}) {key} {res[key]}, the reference's "
                     f"{ref[key]}")
        if flags != ref["accepted"]:
            fail(f"({label}) accepted flags {flags}, the reference's "
                 f"{ref['accepted']}")
        gaps = []
        for key in ("best_score", "default_score"):
            if f"{res[key]:.3f}" != f"{ref[key]:.3f}":
                fail(f"({label}) {key} {res[key]!r}, the reference prints "
                     f"{ref[key]:.3f}")
            gaps.append(abs(res[key] - ref[key]) / abs(ref[key]))
        say("8", f"({label}) best {res['best_placement']} at "
                 f"{res['best_score']:.3f} (default "
                 f"{res['default_placement']} {res['default_score']:.3f}), "
                 f"incumbent {res['incumbent_placement']}, accepted "
                 f"{sum(flags)}/{len(flags)} == the reference device "
                 f"engine's (relative gap of the scores {max(gaps):.2g})")

    held("a", outs["a"], SEARCH_DEVICE_REFERENCE)
    held("c", outs["c"], RESILIENCE_REFERENCE)
    if set(outs["c"]["best_placement"]) & set(RESILIENCE_BLOCKED):
        fail("(c) the best placement sits on a blocked router")
    res = outs["b"]
    if res["island_best_placements"] != list(
            ISLAND_REFERENCE["best_placements"]):
        fail(f"(b) island best placements {res['island_best_placements']}, "
             f"the reference's {ISLAND_REFERENCE['best_placements']}")
    for key, ref_key in (("island_best_scores", "best_scores"),
                         ("island_default_scores", "default_scores")):
        got_s = [f"{v:.3f}" for v in res[key]]
        want_s = [f"{v:.3f}" for v in ISLAND_REFERENCE[ref_key]]
        if got_s != want_s:
            fail(f"(b) {key} {got_s}, the reference prints {want_s}")
    flags = tuple(tuple(bool(v) for v in row)
                  for row in res["history"]["accepted"] > 0.5)
    if flags != ISLAND_REFERENCE["accepted"]:
        fail(f"(b) accepted flags {flags}")
    say("8", "(b) island search, best per L_m " + "; ".join(
        f"{lm}: {p} at {s:.3f}" for lm, p, s in zip(
            ISLAND_LM, res["island_best_placements"],
            res["island_best_scores"])) + " == the reference's")
    for label, k in (("d", DSE_ISLANDS), ("e", WIDE_SEARCH_ISLANDS)):
        res = outs[label]
        best, dflt = res["island_best_scores"], res["island_default_scores"]
        if best.shape != (k,) or not np.isfinite(best).all() \
                or not (best <= dflt).all() \
                or res["history"]["best_score"].shape != (k, gens[label]):
            fail(f"({label}) island results malformed: best {best}, "
                 f"default {dflt}")
        say("8", f"({label}) {k} islands: best score {res['best_score']:.4f}"
                 f" (island {res['best_island']}), improvement over the "
                 f"default per island {np.mean(1 - best / dflt):.2%} mean, "
                 f"{np.max(1 - best / dflt):.2%} max")

    # Every kernel call of the path against the padded plain loop.
    err, checked = 0.0, {}
    for name, state0, xs, csim, tbl, kw, (got_state, got_recs) in calls:
        want_state, want_recs = epoch_run_reference(state0, xs, csim, tbl,
                                                    **kw)
        e = max(compare(got_recs, want_recs, f"phase 8 ({name})"),
                compare(state_fields(got_state), state_fields(want_state),
                        f"phase 8 ({name}) state"))
        err = max(err, e)
        n, m = checked.get(name, (0, 0.0))
        checked[name] = (n + 1, max(m, e))
    say("8", "every kernel call == the padded plain loop on its own inputs: "
             + ", ".join(f"({k}) {n} call(s) max abs err {m:.3g}"
                         for k, (n, m) in checked.items()))

    # Host times (warm, host clock, each search ended by a synchronize).
    def host_ms(fn, reps):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    warm, per_gen = {}, {}
    tsearch._search_core = checked_core
    try:
        for label, fn in entry.items():
            loop_ms.clear()
            warm[label] = host_ms(fn, 3)
            per_gen[label] = float(np.median(loop_ms)) / gens[label]
    finally:
        tsearch._search_core = real_core
    evals = {k: gens[k] * lanes[k] / (warm[k] / 1e3) for k in entry}
    host_engine = host_ms(lambda: S.search_placement(
        tr_a, resipi, generations=gens["a"], population=SEARCH_POPULATION,
        seed=0, engine="host", device=dev), 3)
    say("8", "warm host ms per search (median of 3) / per generation (the "
             "generation loop's host time over the generations) / "
             "candidate evaluations per second: " + "; ".join(
                 f"({k}) {warm[k]:.2f} / {per_gen[k]:.3f} / {evals[k]:.0f}"
                 for k in entry)
             + f"; (a) through the host engine on the same configuration "
               f"{host_engine:.2f} ms ({host_engine / warm['a']:.2f}x the "
               f"device engine's); card: {card}")
    prof = device_breakdown(entry["d"], "(d) warm search", top=6, phase="8")
    idle = None if prof is None else \
        1.0 - sum(prof[1].values()) / 1e6 / prof[0]
    say("8", f"(d) warm search: device idle share "
             f"{'not measured' if idle is None else f'{idle:.1%}'} of a "
             f"profiled call; card: {card}")

    # Device time per launch shape: one generation's launch.
    rows = {}
    for label in entry:
        _, state0, xs, csim, tbl, kw, _ = next(c for c in calls
                                              if c[0] == label)
        n_tr, t_len, c = xs[0].shape
        n_lanes = int(kw["lane_trace"].shape[0])
        dest = kw.get("dest") is not None
        kern = ops.variant(c, False, dest, n_lanes, padded=True)
        ms = time_graph(lambda: ops.launch(state0.ctl.g, xs,  # noqa: B023
                                           csim, tbl, **kw))
        plain = time_cuda(lambda: epoch_run_reference(  # noqa: B023
            state0, xs, csim, tbl, **kw), 1)[0]
        g_slots = csim.cfg.max_gateways_per_chiplet
        nbytes, n_ops = padded_epoch_work(
            n_tr, t_len, c, g_slots, [c] * n_lanes, [g_slots] * n_lanes,
            [c] if dest else None)
        bound, by = max((nbytes / H100.hbm_bytes_per_s * 1e3, "bytes"),
                        (n_ops / H100.peak_f32_flops * 1e3, "operations"))
        rows[f"search-{label}"] = {
            "variant": kern + "+topo", "lanes": n_lanes,
            "intervals": t_len, "chiplets": c,
            "dest_matrices": int(dest), "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by,
            "host_ms_per_generation": per_gen[label],
            "host_ms_per_search": warm[label],
            "evaluations_per_s": evals[label]}
        say("8", f"epoch_step ({label}) generation launch ({kern}+topo; "
                 f"{n_lanes} lanes x {t_len} intervals x {c} chiplets"
                 f"{', a destination matrix' if dest else ''}): {ms:.4f} ms "
                 f"(device: CUDA-graph replays, median of 5); plain loop "
                 f"{plain:.2f} ms once; bound {bound:.4f} ms by {by} "
                 f"({nbytes / 1e6:.3f} MB, {n_ops / 1e9:.5f} GFLOP); "
                 f"card: {card}")
    return {"epoch_launches": launches.get(ops.NAME, 0), "epoch_err": err,
            "epoch_shapes": rows, "variants": variants,
            "warm_host_ms": warm, "host_engine_ms": host_engine,
            "idle_share": idle}


def serve_phase(dev, card: str) -> dict:
    """Phase 9, serving and resilience, a main path of its own (counters
    zeroed before (a), read after (c)): (a) the reference's two serving
    walkthroughs on the card (`serve.cases`), held to
    STORM_WALK_REFERENCE and SERVER_WALK_REFERENCE; (b) the launcher
    (`repro_torch.launch.serve.main`) with LAUNCH_RUNS, held to
    LAUNCH_REFERENCE; (c) a `SessionServer` at a DSE user's size
    (SERVE_LANES x SERVE_CHUNK, SERVE_SESSIONS sessions of the 8 PARSEC
    apps, a quarter with destination matrices, a router storm healed by
    the device search) run until drained. Every serve dispatch must be one
    epoch_step launch ("split"), every heal `generations` "split+topo"
    ones; the first launch of each kind (walkthrough, launcher, (c)'s
    plain and destination ticks, each before the storm and under it with
    a dead gateway slot, a heal generation) is held to the plain loop;
    every completed session of (a) and SERVE_REPLAYS of (c) replay
    exactly, half of (c)'s served through the dead-gateway frames and
    across the heal's placement change. Then (c)'s served intervals per
    second end to end (submissions and ticks) and the tick layer's alone,
    host ms per tick by stage, p50/p99 dispatch wall, the device idle share of
    SERVE_PROFILED profiled ticks and the heals' ms, and the tick launch's
    device time, plain time and bound."""
    from repro_torch import backend
    from repro_torch.core import simulator as S
    from repro_torch.kernels.epoch_step import ops
    from repro_torch.kernels.epoch_step.ref import epoch_run_reference
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import cases
    from repro_torch.serve.engine import replay_standalone
    from repro_torch.serve.policies import ServerPolicy
    from repro_torch.serve.scheduler import SessionRequest

    # Inputs (set-up, before the counters are zeroed): (c)'s sessions,
    # drawn on the host as a client would (the launcher in (b) draws its
    # traces on the card and the server copies them to the host at feed).
    t_phase = time.perf_counter()
    dse = cases.dse_traces(SERVE_SESSIONS, "cpu")
    gen_s = time.perf_counter() - t_phase

    calls, seen = [], set()
    kernel_epoch_run = ops.epoch_run
    part = ""

    def recorded_epoch_run(state, xs, sim, tables, **kw):
        kind = (part, kw.get("topo") is not None,
                kw.get("dest") is not None, bool(kw.get("faulted")))
        # A tick's fault frame is shared by its lanes: whether lane 0's
        # has a dead gateway slot (the storm before its heal) makes a kind
        # of its own, read (one synchronize) until both are recorded.
        dead = kind[3] and not kind[1] and not (
            kind + (False,) in seen and kind + (True,) in seen) \
            and bool((xs[5][0] < 0.5).any())
        out = kernel_epoch_run(state, xs, sim, tables, **kw)
        kind += (dead,)
        if kind not in seen:                  # the first of each kind
            seen.add(kind)
            calls.append((kind, state, xs, sim, tables, kw, out))
        return out

    policy = ServerPolicy(lanes=SERVE_LANES, chunk_intervals=SERVE_CHUNK,
                          queue_capacity=SERVE_QUEUE)
    stage = dict.fromkeys(("pack", "dispatch", "settle", "heal"), 0.0)
    served, launch_deltas, heal_ms, rows = [0.0], [], [], []
    dest_dispatches = [0]

    def timed(name, fn):
        def inner(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t
                stage[name] += dt
                if name == "heal":
                    heal_ms.append(dt * 1e3)
        return inner

    ops.epoch_run = recorded_epoch_run
    torch.cuda.synchronize()
    S.reset_engine_stats()                       # main path starts
    try:
        # (a) the walkthroughs
        part = "walkthrough"
        storm = cases.fault_storm_recovery(dev)
        walk = cases.session_server(dev)
        # (b) the launcher
        part = "launcher"
        launched = {}
        for name, argv in LAUNCH_RUNS.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                server = launch_serve.main(argv + ["--device", dev.type])
            launched[name] = (server, buf.getvalue().splitlines())
        # (c) the DSE-size server, run until drained
        part = "dse"
        big = cases.dse_server(policy, dev,
                               storm_dispatch=SERVE_STORM_DISPATCH)
        real_launch, real_settle = big._launch, big._settle

        def counted_launch(packed):
            before = backend.COUNTERS["launches"].get(ops.NAME, 0)
            out = real_launch(packed)
            launch_deltas.append(
                backend.COUNTERS["launches"].get(ops.NAME, 0) - before)
            dest_dispatches[0] += "dest" in packed["batch"]
            return out

        def counted_settle(packed, out, now):
            served[0] += float(
                out["sums"]["valid_intervals"][packed["ready"]].sum())
            return real_settle(packed, out, now)

        big._pack = timed("pack", big._pack)
        big._launch = timed("dispatch", counted_launch)
        big._settle = timed("settle", counted_settle)
        big._heal = timed("heal", big._heal)
        submitted = 0

        def step(profiled=False):
            nonlocal submitted
            t_a = time.perf_counter()
            for tr, pr in dse[submitted:submitted + SERVE_PER_TICK]:
                big.submit(SessionRequest(trace=tr, priority=pr))
            submitted = min(submitted + SERVE_PER_TICK, len(dse))
            t_b = time.perf_counter()
            before, s0 = dict(stage), served[0]
            big.tick()
            rows.append(dict({k: stage[k] - before[k] for k in stage},
                             submit=t_b - t_a,
                             tick=time.perf_counter() - t_b,
                             served=served[0] - s0, profiled=profiled))

        prof, prof_s = None, 0.0
        t_run = time.perf_counter()
        while submitted < len(dse) or len(big.queue) \
                or big.sessions_in_flight:
            if big.tick_count == SERVE_PROFILE_AT and prof is None:
                t_prof = time.perf_counter()
                prof = device_breakdown(
                    lambda: [step(True) for _ in range(SERVE_PROFILED)],
                    f"(c) {SERVE_PROFILED} ticks from tick "
                    f"{SERVE_PROFILE_AT}", top=6, phase="9") or False
                prof_s = time.perf_counter() - t_prof
            else:
                step()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
        launches = dict(backend.COUNTERS["launches"])   # main path ends
        variants = dict(backend.COUNTERS["variants"])
        loop_runs = backend.COUNTERS["loop_runs"]
    finally:
        ops.epoch_run = kernel_epoch_run

    # (a) against the reference's numbers.
    ev = storm["events"]
    got = {"victims": storm["victims"],
           "latency": tuple(f"{e['latency']:.2f}" for e in ev),
           "baseline": tuple(f"{e['baseline']:.2f}" for e in ev),
           "breach": tuple(e["breach"] for e in ev),
           "heals": tuple((i, e["healed"]["moved_gateways"],
                           e["healed"]["pcm_nj"],
                           e["healed"]["stall_cycles"])
                          for i, e in enumerate(ev) if e["healed"]),
           "placement": storm["placement"],
           "bill": (storm["total_pcm_nj"], storm["total_stall_cycles"],
                    storm["replacements"])}
    if got != STORM_WALK_REFERENCE:
        fail(f"(a) fault-storm walkthrough {got}, the reference's "
             f"{STORM_WALK_REFERENCE}")
    server = walk["server"]
    m = server.metrics()
    got_m = {k: m[k] for k in SERVER_WALK_REFERENCE["metrics"]}
    got_m["availability"] = f"{m['availability']:.0%}"
    got_m["baseline_latency"] = f"{m['baseline_latency']:.4f}"
    got = {"submits": tuple(walk["submits"]),
           "ticks": tuple((e["in_flight"], e["queue_depth"], e["degraded"],
                           e["breach"], f"{e['latency']:.2f}")
                          for e in server.events),
           "heals": tuple((e["tick"], e["healed"]["moved_gateways"],
                           e["healed"]["pcm_nj"],
                           e["healed"]["new_placement"])
                          for e in server.events if e["healed"]),
           "metrics": got_m}
    if got != SERVER_WALK_REFERENCE:
        fail(f"(a) session-server walkthrough {got}, the reference's "
             f"{SERVER_WALK_REFERENCE}")

    def replayed(srv, sessions, what):
        for sess in sessions:
            ref = replay_standalone(srv.sim, sess, device=dev)
            mine = sess.summary()
            bad = [k for k in SERVE_SUMMARY_KEYS if float(ref[k]) != mine[k]]
            if bad:
                fail(f"{what}: session {sess.id}'s replay differs in {bad}")
        return len(sessions)

    n_walk = replayed(server, server.completed, "(a) walkthrough")
    say("9", f"(a) fault-storm walkthrough: heal at chunk 6, 6 gateways "
             f"moved off {list(storm['victims'])} (12 nJ, 100 stall "
             f"cycles), placement {storm['placement']}; session-server "
             f"walkthrough: submits, {len(server.events)} ticks, heal at "
             f"tick 4 (4 gateways, 8 nJ) and every counter == the "
             f"reference's; {n_walk}/{n_walk} completed sessions replay "
             f"exactly on the card")

    # (b) the launcher's counters.
    for name, (srv, lines) in launched.items():
        mm = srv.metrics()
        want = LAUNCH_REFERENCE[name]
        got = {k: mm[k] for k in want if k in mm}
        got["drain"] = int(lines[0].split("(+")[1].split(" drain")[0])
        if "availability" in want:
            got["availability"] = f"{mm['availability']:.0%}"
        if got != want:
            fail(f"(b) launcher {name}: {got}, the reference's {want}")
        say("9", f"(b) launcher {name} == the reference's counters: "
                 + " | ".join(line.split("; chunk wall")[0]
                              for line in lines[:3])
                 + f"; dispatch wall p50 {mm['p50_chunk_s'] * 1e3:.3f} ms "
                   f"p99 {mm['p99_chunk_s'] * 1e3:.3f} ms; card: {card}")

    # (c) the DSE-size server.
    mc = big.metrics()
    if set(launch_deltas) != {1} or len(launch_deltas) != mc["dispatches"]:
        fail(f"(c) epoch_step launches per dispatch "
             f"{sorted(set(launch_deltas))} over {len(launch_deltas)} "
             f"dispatches (expected 1 each)")
    if mc["submitted"] != SERVE_SESSIONS or mc["completed"] \
            != mc["admitted"] or mc["admitted"] + mc["shed_queue_full"] \
            + mc["shed_memory"] + mc["shed_priority"] != SERVE_SESSIONS:
        fail(f"(c) sessions lost: {mc}")
    if mc["heals"] < 1 or set(big.placement) & set(
            big.fault_env.failed_positions(big.hw_intervals - 1)):
        fail(f"(c) the storm was not healed: {mc['heals']} heals, "
             f"placement {big.placement}")
    def spans_heal(sess):
        """Served through dead-gateway frames and across a placement
        change: the storm and the heal both in one session."""
        log = sess.served_log
        return len({tuple(e["placement"]) for e in log}) > 1 and any(
            e["frame"] is not None and np.min(e["frame"]["gw_ok"]) < 0.5
            for e in log)

    quarter, sample = SERVE_REPLAYS // 4, []
    for routed in (False, True):
        group = [s for s in big.completed
                 if (s.served_log[0]["chunk"].get("dest") is not None)
                 == routed]
        span = [s for s in group if spans_heal(s)]
        rest = [s for s in group if not spans_heal(s)]
        if len(span) < quarter or len(rest) < quarter:
            fail(f"(c) {len(span)} {'destination' if routed else 'plain'} "
                 f"sessions span the storm and the heal, {len(rest)} do "
                 f"not (need {quarter} of each to replay)")
        sample += span[:quarter] + rest[:quarter]
    n_big = replayed(big, sample, "(c)")
    # Serve launches: (a)'s chunks and dispatches, (b)'s and (c)'s
    # dispatches; search launches: `generations` a heal ((a)'s storm and
    # (b), (c) heal with the default 8, (a)'s server with 4).
    gens = big.resilience.search_generations
    heals_all = 2 + mc["heals"] + sum(s.metrics()["heals"]
                                      for s, _ in launched.values())
    dispatches = (len(storm["events"]) + m["dispatches"]
                  + sum(s.metrics()["dispatches"]
                        for s, _ in launched.values()) + mc["dispatches"])
    want_variants = {f"{ops.NAME}:split": dispatches,
                     f"{ops.NAME}:split+topo": 4 + gens * (heals_all - 1)}
    if variants != want_variants or loop_runs:
        fail(f"phase 9 main path kernel variants {variants} and "
             f"{loop_runs} plain-loop runs, expected {want_variants}, 0")

    # The first launch of each kind against the plain loop.
    err, checked = 0.0, []
    for kind, state0, xs, csim, tbl, kw, (got_state, got_recs) in calls:
        want_state, want_recs = epoch_run_reference(state0, xs, csim, tbl,
                                                    **kw)
        label = f"{kind[0]}{'+topo' if kind[1] else ''}" \
                f"{'+dest' if kind[2] else ''}{'+faults' if kind[3] else ''}" \
                f"{'+dead' if kind[4] else ''}"
        e = max(compare(got_recs, want_recs, f"phase 9 ({label})"),
                compare(state_fields(got_state), state_fields(want_state),
                        f"phase 9 ({label}) state"))
        err = max(err, e)
        checked.append(f"{label} {int(kw['lane_trace'].shape[0])} lanes "
                       f"{e:.3g}")
    say("9", f"main path: {json.dumps(launches)} launches, variants "
             f"{json.dumps(variants)} ({dispatches} serve dispatches, "
             f"{heals_all} heals); (c) one epoch_step launch per dispatch "
             f"over {len(launch_deltas)} dispatches; the first launch of "
             f"each kind == the plain loop (max abs err): "
             + "; ".join(checked))

    keep = [r for r in rows if not r["profiled"]]
    n_ticks = len(keep)
    tick_s = sum(r["tick"] for r in keep)
    per = {k: sum(r[k] for r in keep) / n_ticks * 1e3
           for k in ("pack", "dispatch", "settle", "heal", "submit",
                     "tick")}
    per["rest"] = per["tick"] - sum(per[k] for k in ("pack", "dispatch",
                                                     "settle", "heal"))
    submit_s = sum(r["submit"] for r in keep)
    n_served = sum(r["served"] for r in keep)
    # End to end, as a client sees it: admission (`submit` validates,
    # chunks and copies each trace) and the ticks; the tick-only rate is
    # the tick layer's own.
    rate = n_served / (submit_s + tick_s)
    tick_rate = n_served / tick_s
    idle = None if not prof else \
        1.0 - sum(prof[1].values()) / 1e6 / prof[0]
    say("9", f"(c) {SERVE_SESSIONS} sessions "
             f"({sum('dest' in tr for tr, _ in dse)} with destination "
             f"matrices) on {SERVE_LANES} lanes x "
             f"{SERVE_CHUNK}: {mc['completed']} completed over "
             f"{mc['ticks']} ticks, {mc['dispatches']} dispatches "
             f"({dest_dispatches[0]} of them with destination matrices, "
             f"{mc['coalesced_dispatches']} coalesced), "
             f"{mc['served_chunks']} chunks, shed {mc['shed_queue_full']} / "
             f"{mc['shed_memory']} / {mc['shed_priority']}, availability "
             f"{mc['availability']:.1%}; {n_big} sessions ({2 * quarter} "
             f"with destination matrices; {2 * quarter} served through the "
             f"storm and across the heal) replay exactly; traces drawn in "
             f"{gen_s:.2f} s (set-up); card: {card}")
    say("9", f"(c) served {rate:.4g} intervals/s end to end over "
             f"{n_ticks} unprofiled ticks ({n_served:.0f} intervals in "
             f"{(submit_s + tick_s) * 1e3:.1f} ms: submissions "
             f"{submit_s * 1e3:.1f}, ticks {tick_s * 1e3:.1f}); the tick "
             f"layer alone {tick_rate:.4g} intervals/s; whole run with "
             f"the profiled window {run_s:.2f} s, of which "
             f"the profiler's call {prof_s:.2f} s; host ms "
             f"per tick: pack {per['pack']:.3f}, dispatch (launch + "
             f"read-back) {per['dispatch']:.3f}, outcomes and rollback "
             f"{per['settle']:.3f}, heal {per['heal']:.3f}, rest "
             f"{per['rest']:.3f}, total {per['tick']:.3f} (submissions "
             f"{per['submit']:.3f} beside it); dispatch wall p50 "
             f"{mc['p50_chunk_s'] * 1e3:.3f} ms p99 "
             f"{mc['p99_chunk_s'] * 1e3:.3f} ms; device idle "
             f"{'not measured' if idle is None else f'{idle:.1%}'} of "
             f"{SERVE_PROFILED} profiled ticks; {mc['heals']} heals "
             f"({', '.join(f'{x:.1f}' for x in heal_ms)} ms; placement "
             f"{big.placement}, {mc['total_pcm_nj']:.0f} nJ); card: {card}")

    # The serve tick's launch: device time, plain time, bound.
    shape_rows = {}
    for kind, state0, xs, csim, tbl, kw, _ in calls:
        if kind[0] != "dse" or kind[1] or kind[4]:   # dead: same shape
            continue
        label = "serve-tick" + ("-dest" if kind[2] else "") \
            + ("-faults" if kind[3] else "")
        n_tr, t_len, c = xs[0].shape
        n_lanes = int(kw["lane_trace"].shape[0])
        kern = ops.variant(c, kind[3], kind[2], n_lanes)
        ms = time_graph(lambda: ops.launch(state0.ctl.g, xs,  # noqa: B023
                                           csim, tbl, **kw))
        plain = time_cuda(lambda: epoch_run_reference(  # noqa: B023
            state0, xs, csim, tbl, **kw), 1)[0]
        nbytes, n_ops = epoch_work(n_tr, t_len, c,
                                   csim.cfg.max_gateways_per_chiplet,
                                   n_lanes, kind[2], 1 if kind[3] else 0)
        bound, by = max((nbytes / H100.hbm_bytes_per_s * 1e3, "bytes"),
                        (n_ops / H100.peak_f32_flops * 1e3, "operations"))
        shape_rows[label] = {
            "variant": kern, "lanes": n_lanes, "intervals": t_len,
            "chiplets": c, "dest_matrices": int(kind[2]),
            "fault_frame": int(kind[3]),
            "dispatches": dest_dispatches[0] if kind[2]
            else mc["dispatches"] - dest_dispatches[0],
            "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by,
            "host_ms_per_tick": per["tick"],
            "dispatch_wall_p50_ms": mc["p50_chunk_s"] * 1e3,
            "dispatch_wall_p99_ms": mc["p99_chunk_s"] * 1e3}
        say("9", f"epoch_step {label} launch ({kern}; {n_lanes} lanes x "
                 f"{t_len} intervals x {c} chiplets): {ms:.4f} ms (device: "
                 f"CUDA-graph replays, median of 5); plain loop "
                 f"{plain:.2f} ms once; bound {bound:.4f} ms by {by} "
                 f"({nbytes / 1e6:.3f} MB, {n_ops / 1e9:.5f} GFLOP); card: "
                 f"{card}")
    say("9", f"phase 9 took {time.perf_counter() - t_phase:.1f} s (drawing "
             f"(c)'s traces {gen_s:.1f} s, (c)'s run {run_s:.1f} s)")
    return {"epoch_launches": launches.get(ops.NAME, 0), "epoch_err": err,
            "epoch_shapes": shape_rows, "variants": variants,
            "served_intervals_per_s": rate,
            "tick_served_intervals_per_s": tick_rate,
            "host_ms_per_tick": per,
            "idle_share": idle, "heal_ms": heal_ms,
            "dispatch_wall_ms": (mc["p50_chunk_s"] * 1e3,
                                 mc["p99_chunk_s"] * 1e3)}


def archive_print(topo, island, pos, valid) -> str:
    """A fingerprint of an archive's members (point, island, placement of
    every valid row, in sorted order), 8 hex digits."""
    ids = sorted((int(t), int(k), tuple(int(v) for v in np.ravel(p)))
                 for t, k, p, ok in zip(np.asarray(topo), np.asarray(island),
                                        np.asarray(pos), np.asarray(valid))
                 if ok)
    return f"{zlib.crc32(repr(ids).encode()):08x}"


def replay_archive(inserts, capacity: int, g: int, want: list, insert):
    """An archive replayed on the host, insert by insert, from what a
    search offered it (`inserts`: per insert (objectives [N, 3] float32,
    placements [N, g, 2], points [N], islands [N]) as numpy), with the
    search's own insert function (`insert(arch, *batch)`, numpy dicts in
    and out), against the reference's fingerprint after each insert
    (`want`, flat). Where the two part, the one near-tie that explains it
    is found: a single comparison between two offered designs flipped
    (one design's objective moved to the other's value, or one float32
    step either side of it; or its eviction key moved past the other's)
    such that the insert then gives the reference's members. A design
    offers the same objectives every time (identical lanes), so the moved
    value holds for that design from then on, as the reference's value
    does there; each later parting is found in turn. Returns (plain,
    flipped, partings): the archive replayed as is, the archive replayed
    with the flips (the second with its size after each insert under
    "sizes") and per parting (insert index, kind, relative gap of the two
    values compared in this run), the gap None where no single flip
    within 1e-5 explains it."""
    from repro_torch.core.pareto import _empty_archive_np

    moved = {}                          # design -> its moved objectives
    plain = arch = _empty_archive_np(capacity, g)
    partings, sizes = [], []
    for i, batch in enumerate(inserts):
        plain = insert(plain, *batch)
        new = insert(arch, *_moved_batch(batch, moved))
        if archive_print(new["topo"], new["island"], new["pos"],
                         new["valid"]) != want[i]:
            found = _near_tie_flip(arch, batch, moved, want[i], insert)
            if found is None:
                partings.append((i, "archive", None))
            else:
                kind, gap, design, vec, new = found
                moved[design] = vec
                partings.append((i, kind, gap))
        arch = new
        sizes.append(int(np.sum(arch["valid"])))
    return plain, dict(arch, sizes=np.asarray(sizes)), partings


def archive_front(arch: dict) -> list:
    """The valid rows of an archive (a result's "archive", or
    `replay_archive`'s) as (point, island, placement, objectives)."""
    if "objectives" in arch:
        arch = {"obj": arch["objectives"], "topo": arch["topology_index"],
                "island": arch["island"], "valid": arch["valid"],
                "pos": np.asarray(arch["placements"])}
    return [(int(t), int(k), tuple(tuple(int(v) for v in xy) for xy in p),
             tuple(float(np.float32(v)) for v in o))
            for t, k, p, o, ok in zip(arch["topo"], arch["island"],
                                      arch["pos"], arch["obj"],
                                      arch["valid"]) if ok]


def _designs(topo, island, pos) -> list:
    return [(int(t), int(k), tuple(int(v) for v in np.ravel(p)))
            for t, k, p in zip(topo, island, pos)]


def _moved_batch(batch, moved: dict) -> tuple:
    """`batch` with the moved designs' objectives."""
    cobj, cpos, point, island = batch
    if moved:
        cobj = np.array(cobj, np.float32)
        for i, d in enumerate(_designs(point, island, cpos)):
            if d in moved:
                cobj[i] = moved[d]
    return cobj, cpos, point, island


def _near_tie_flip(arch, batch, moved: dict, target: str, insert):
    """The single near-tie flip (`replay_archive`) with the smallest gap
    that makes this insert give the members fingerprinted `target`:
    (kind, gap, design moved, its moved objectives, the resulting
    archive), or None."""
    cobj, cpos, point, island = _moved_batch(batch, moved)
    n_arch = len(arch["valid"])
    designs = _designs(arch["topo"], arch["island"], arch["pos"]) \
        + _designs(point, island, cpos)
    obj = np.concatenate([arch["obj"], cobj]).astype(np.float64)
    valid = np.concatenate([arch["valid"],
                            np.all(np.isfinite(cobj), axis=1)])
    keys = np.sum(np.log(np.maximum(obj, 1e-12)), axis=1)
    trials = []
    rows = np.nonzero(valid)[0]
    for a in rows:
        for b in rows:
            if designs[a] == designs[b]:
                continue
            for m in range(3):
                gap = abs(obj[a, m] - obj[b, m]) / abs(obj[b, m])
                if gap < 1e-5:
                    ref = np.float32(obj[b, m])
                    for v in (np.nextafter(ref, np.float32(-np.inf)), ref,
                              np.nextafter(ref, np.float32(np.inf))):
                        if v != np.float32(obj[a, m]):
                            vec = obj[a].astype(np.float32)
                            vec[m] = v
                            trials.append((gap, "dominance test", a, vec))
            kgap = abs(keys[a] - keys[b])
            if kgap < 1e-5:
                for sign in (-1.0, 1.0):
                    vec = obj[a].astype(np.float32)
                    vec[0] = np.float32(obj[a, 0]
                                        * np.exp(sign * (kgap + 1e-6)))
                    trials.append((kgap, "eviction rank", a, vec))
    for gap, kind, a, vec in sorted(trials, key=lambda x: x[0]):
        trial_moved = dict(moved)
        trial_moved[designs[a]] = vec
        pre = dict(arch, obj=np.array(arch["obj"], np.float32))
        for i, d in enumerate(designs[:n_arch]):
            if d in trial_moved and arch["valid"][i]:
                pre["obj"][i] = trial_moved[d]
        trial = insert(pre, *_moved_batch(batch, trial_moved))
        if archive_print(trial["topo"], trial["island"], trial["pos"],
                         trial["valid"]) == target:
            return kind, gap, designs[a], vec, trial
    return None


def trail_inserts(objs, cands) -> list:
    """The device engine's archive inserts from its trail (objectives
    [T, GEN, K, P, 3], candidates [T, GEN, K, P, g, 2]), in its order:
    point-major, then generation, lanes island-major."""
    n_t, n_g, n_k, n_p = objs.shape[:4]
    island = np.repeat(np.arange(n_k), n_p)
    return [(objs[t, gen].reshape(-1, 3),
             cands[t, gen].reshape(n_k * n_p, -1, 2),
             np.full(n_k * n_p, t), island)
            for t in range(n_t) for gen in range(n_g)]


def device_archive_insert(capacity: int):
    """The device engine's `_archive_insert` on CPU tensors, numpy in and
    out (for `replay_archive`)."""
    from repro_torch.core import pareto as tpar

    def insert(arch, cobj, cpos, point, island):
        t = {k: torch.as_tensor(np.asarray(v)) for k, v in arch.items()}
        t.update({k: t[k].long() for k in ("pos", "topo", "island")})
        out = tpar._archive_insert(
            t, torch.as_tensor(np.asarray(cobj, np.float32)),
            torch.as_tensor(np.asarray(cpos)), torch.as_tensor(point),
            torch.as_tensor(island), capacity=capacity)
        return {k: v.numpy() for k, v in out.items()}

    return insert


def pareto_phase(dev, card: str) -> dict:
    """Phase 10, Pareto co-design, a main path of its own (counters zeroed
    before (a), read after (b)'s re-scoring): (a) the reference's
    walkthrough on the device engine and on the host engine, its front
    re-scored by `rescore_front_host`; (b) the DSE-size co-design
    (PARETO_RUNS["b"]: 1536 lanes x 100 intervals x 256 chiplets with
    destination matrices a launch) and its re-scoring. The traces are the
    port's own, from the reference's keys. Each device search must make
    `generations` "wide+topo" launches (every point's chains in each) and
    one `search_dispatches`, its generation loop run under
    `torch.cuda.set_sync_debug_mode("error")`; the host search one launch
    per point and generation. (a) and (b) are held to the reference device
    engine (PARETO_WALK_REFERENCE, PARETO_DSE_REFERENCE) and (a)'s host
    search to the reference host engine (PARETO_WALK_HOST_REFERENCE):
    front entries exact, objectives and hypervolume at RTOL, histories and
    evaluations exact; where a decision parts from the reference's, the
    first one is printed with the relative gap of the values it compares,
    and the phase fails unless that gap is under NEAR_TIE. Every front
    must be non-dominated and equal its re-scoring at RTOL. Every launch
    of (a) and the first and last of (b) are held against the padded
    plain loop. Then per launch shape the device time (CUDA-graph
    replays), the plain loop's and the bound; the warm host ms per search
    and per generation by stage; candidate evaluations per second; the
    device idle share of a profiled warm (b); and (b)'s launch on its
    64-chiplet lanes alone against its 256-chiplet lanes alone, padded
    and unpadded (what "wide" costs per padded chiplet)."""
    from repro_torch import backend
    from repro_torch import random as trandom
    from repro_torch.core import pareto as tpar
    from repro_torch.core import search as tsearch
    from repro_torch.core import simulator as S
    from repro_torch.core import traffic
    from repro_torch.core.constants import NETWORK
    from repro_torch.kernels.epoch_step import ops
    from repro_torch.kernels.epoch_step.ref import epoch_run_reference

    sim = S.SimConfig().with_arch(S.Arch.RESIPI)
    cfg = NETWORK.with_topology(n_chiplets=max(PARETO_COUNTS))
    traces = {}
    for label, (n_int, seed, dest) in PARETO_TRACES.items():
        keys = trandom.split(trandom.prng_key(seed, device=dev),
                             len(PARETO_APPS))
        traces[label] = [traffic.generate(traffic.ParsecSpec(a, n_int),
                                          keys[i], cfg, dest=dest,
                                          device=dev)
                         for i, a in enumerate(PARETO_APPS)]
    kw = {k: dict(v, n_chiplets=list(PARETO_COUNTS))
          for k, v in PARETO_RUNS.items()}
    n_pts = len(PARETO_COUNTS)
    res = {}
    entry = {
        "a": lambda: S.search_codesign(traces["a"], sim, device=dev,
                                       **kw["a"]),
        "a-host": lambda: S.search_codesign(traces["a"], sim, engine="host",
                                            device=dev, **kw["a"]),
        "a-rescore": lambda: S.rescore_front_host(res["a"], traces["a"],
                                                  sim, device=dev),
        "b": lambda: S.search_codesign(traces["b"], sim, device=dev,
                                       **kw["b"]),
        "b-rescore": lambda: S.rescore_front_host(res["b"], traces["b"],
                                                  sim, device=dev)}
    want_calls = {"a": (kw["a"]["generations"], 1),
                  "a-host": (n_pts * kw["a"]["generations"], 0),
                  "a-rescore": (1, 0), "b": (kw["b"]["generations"], 1),
                  "b-rescore": (1, 0)}

    calls, per_call, trails, loop_ms = [], {}, {}, []
    stages = {}
    kernel_epoch_run, real_core = ops.epoch_run, tpar._codesign_core
    real_launch = ops.launch
    part = ""

    def recorded_epoch_run(state, xs, csim, tables, **k):
        out = kernel_epoch_run(state, xs, csim, tables, **k)
        calls.append((part, state, xs, csim, tables, k, out))
        return out

    def timed_launch(*a, **k):
        t0 = time.perf_counter()
        try:
            return real_launch(*a, **k)
        finally:
            stages["launch"] = stages.get("launch", 0.0) \
                + time.perf_counter() - t0

    def checked_core(*args, **k):
        # The generation loop: no host synchronization may happen inside.
        marks = [time.perf_counter()]

        def on_stage(name):
            now = time.perf_counter()
            stages[name] = stages.get(name, 0.0) + now - marks[0]
            marks[0] = now

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            out = real_core(*args, on_stage=on_stage, **k)
        finally:
            loop_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.set_sync_debug_mode(0)
        trails[part] = out[1]
        return out

    host_inserts = []
    real_insert_np = tpar._archive_insert_np

    def recorded_insert_np(arch, cobj, cpos, ctopo, cisland, capacity):
        host_inserts.append((np.asarray(cobj, np.float32), cpos, ctopo,
                             cisland))
        return real_insert_np(arch, cobj, cpos, ctopo, cisland, capacity)

    ops.epoch_run = recorded_epoch_run
    tpar._codesign_core = checked_core
    tpar._archive_insert_np = recorded_insert_np
    torch.cuda.synchronize()
    S.reset_engine_stats()                       # main path starts
    try:
        for label, fn in entry.items():
            part = label
            before = backend.COUNTERS["launches"].get(ops.NAME, 0)
            dispatches = S.engine_stats()["search_dispatches"]
            t0 = time.perf_counter()
            res[label] = fn()
            torch.cuda.synchronize()
            per_call[label] = (
                backend.COUNTERS["launches"].get(ops.NAME, 0) - before,
                S.engine_stats()["search_dispatches"] - dispatches,
                (time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        launches = dict(backend.COUNTERS["launches"])   # main path ends
        variants = dict(backend.COUNTERS["variants"])
        loop_runs = backend.COUNTERS["loop_runs"]
    finally:
        ops.epoch_run = kernel_epoch_run
        tpar._codesign_core = real_core
        tpar._archive_insert_np = real_insert_np

    got = {k: v[:2] for k, v in per_call.items()}
    if got != want_calls:
        fail(f"phase 10 (epoch_step launches, search_dispatches) per call "
             f"{got}, expected {want_calls}")
    want_variants = {f"{ops.NAME}:wide+topo": sum(
        v[0] for v in want_calls.values())}
    if variants != want_variants or loop_runs:
        fail(f"phase 10 main path kernel variants {variants} and "
             f"{loop_runs} plain-loop runs, expected {want_variants}, 0")
    say("10", f"main path: {json.dumps(launches)} launches, variants "
              f"{json.dumps(variants)}; per call (launches, dispatches): "
              f"{json.dumps(got)}; each device search's generation loop ran "
              f"under set_sync_debug_mode('error'); host ms per call "
              f"(first): " + ", ".join(f"{k} {v[2]:.1f}"
                                       for k, v in per_call.items())
         + f"; card: {card}")

    # The fronts against the reference's, decision by decision.
    temps = {k: tsearch._temperatures(np.float32(0.05), np.float32(0.7),
                                      kw[k]["generations"])
             for k in ("a", "b")}
    refs = {"a": PARETO_WALK_REFERENCE, "a-host": PARETO_WALK_HOST_REFERENCE,
            "b": PARETO_DSE_REFERENCE}
    partings = {}
    for label, ref in refs.items():
        run = label[0]
        pin = pareto_pin(res[label])
        objs = np.array([e[4:] for e in pin["front"]], np.float64)
        for i, row in enumerate(objs):
            if np.any(np.all(objs <= row, axis=1)
                      & np.any(objs < row, axis=1)):
                fail(f"({label}) front entry {pin['front'][i]} is "
                     f"dominated within the front")
        cap, gens = kw[run]["archive"], kw[run]["generations"]
        if label in trails:
            tr = {k: v.transpose(0, 1).cpu().numpy()
                  for k, v in trails[label].items()}
            dec = pack_decisions(codesign_decisions(
                tr["s"], tr["threshold"], tr["u"], temps[run]))
            first = first_parting(dec, ref, tr["s"], tr["threshold"],
                                  tr["u"])
            if first is not None:
                t, gen, k, kind, gap = first
                say("10", f"({label}) first decision that parts from the "
                          f"reference's: the {kind} at point {t} "
                          f"({PARETO_COUNTS[t]} chiplets), generation "
                          f"{gen}, island {k}, relative gap {gap:.3g} of "
                          f"the values it compares; the trajectories differ "
                          f"from there, so the front is not compared")
                if not gap < NEAR_TIE:
                    fail(f"({label}) the {kind} at point {t}, generation "
                         f"{gen}, island {k} parts from the reference's "
                         f"with a relative gap {gap:.3g} >= {NEAR_TIE}")
                partings[label] = [first]
                continue
            inserts = trail_inserts(tr["objs"], tr["cands"])
            insert = device_archive_insert(cap)
        else:
            inserts = host_inserts

            def insert(arch, *batch, cap=cap):
                return tpar._archive_insert_np(arch, *batch, cap)
        plain, flipped, found = replay_archive(
            inserts, cap, len(res[label]["archive"]["placements"][0]),
            [p for row in ref["archive"] for p in row.split()], insert)
        if sorted(archive_front(plain)) \
                != sorted(archive_front(res[label]["archive"])):
            fail(f"({label}) the archive replayed from what the search "
                 f"offered is not the search's")
        found = [(i // gens, i % gens, kind, gap) for i, kind, gap in found]
        for t, gen, kind, gap in found:
            say("10", f"({label}) the archive parts from the reference's at "
                      f"point {t} ({PARETO_COUNTS[t]} chiplets), generation "
                      f"{gen}: a {kind} on a relative gap "
                      + ("(no single flip explains it)" if gap is None
                         else f"{gap:.3g}")
                      + (" (every argmin, elitist and acceptance decision "
                         "equals the reference's)" if label in trails
                         else ""))
            if gap is None or not gap < NEAR_TIE:
                fail(f"({label}) the archive parts from the reference's at "
                     f"point {t}, generation {gen} with no near-tie under "
                     f"{NEAR_TIE}")
        lm = kw[run]["knob_grids"]["l_m"]
        front = sorted(((PARETO_COUNTS[t], k, lm[k], p) + o
                        for t, k, p, o in archive_front(flipped)),
                       key=lambda e: e[4:])
        sizes = tuple(tuple(int(v) for v in flipped["sizes"][i:i + gens])
                      for i in range(0, len(flipped["sizes"]), gens))
        partings[label] = found
        if len(front) != len(ref["front"]):
            fail(f"({label}) {len(front)} front entries, the reference's "
                 f"{len(ref['front'])}")
        worst = 0.0
        for g_e, w_e in zip(front, ref["front"]):
            gap = float(np.max(np.abs(np.array(g_e[4:]) - w_e[4:])
                               / np.abs(w_e[4:])))
            worst = max(worst, gap)
            if g_e[:4] != w_e[:4] or not gap <= RTOL:
                fail(f"({label}) front entry {g_e}, the reference's {w_e}")
        for key, val in (("candidate_evals", pin["candidate_evals"]),
                         ("archive_size", sizes)):
            if val != ref[key]:
                fail(f"({label}) {key} {val}, the reference's {ref[key]}")
        hv = pareto_hypervolume(np.array([e[4:] for e in front]))
        if not np.isclose(hv, ref["hypervolume"], rtol=RTOL, atol=0.0):
            fail(f"({label}) hypervolume {hv!r}, the reference's "
                 f"{ref['hypervolume']!r}")
        say("10", f"({label}) {len(front)} front points from "
                  f"{pin['candidate_evals']} candidate evaluations, archive "
                  f"sizes {sizes}, hypervolume {hv:.5g} (the reference's "
                  f"{ref['hypervolume']:.5g}) == the reference's: entries "
                  f"exact, objectives within {worst:.3g} relative"
                  + (f", after {len(found)} near-tie archive decision(s)"
                     if found else ""))
        if label != "a-host":
            print("chiplets |   L_m  | latency | power_mW |   energy | "
                  "placement (this run, then the reference)", flush=True)
            for g_e, w_e in list(zip(front, ref["front"]))[:8]:
                for e in (g_e, w_e):
                    print(f"{e[0]:8d} | {e[2]:6.4f} | {e[4]:7.2f} | "
                          f"{e[5]:8.0f} | {e[6]:8.3g} | {e[3]}", flush=True)
    for label in ("a", "b"):
        front = np.array([[e["objectives"][k] for k in
                           ("latency", "power_mw", "energy")]
                          for e in res[label]["front"]], np.float64)
        resc = res[f"{label}-rescore"]
        if resc.shape != front.shape or not np.allclose(
                resc, front, rtol=RTOL, atol=0.0):
            fail(f"({label}) rescore_front_host differs from the front by "
                 f"{np.max(np.abs(resc - front) / np.abs(front)):.3g}")
        say("10", f"({label}) rescore_front_host == the front within "
                  f"{np.max(np.abs(resc - front) / np.abs(front)):.3g} "
                  f"relative")

    # Kernel calls against the padded plain loop: every one of (a), the
    # first of the host search and of each re-scoring, (b)'s first and last.
    picked = []
    for label in entry:
        mine = [c for c in calls if c[0] == label]
        picked += mine if label == "a" else (
            [mine[0], mine[-1]] if label == "b" else mine[:1])
    err, checked = 0.0, {}
    for name, state0, xs, csim, tbl, k, (got_state, got_recs) in picked:
        want_state, want_recs = epoch_run_reference(state0, xs, csim, tbl,
                                                    **k)
        e = max(compare(got_recs, want_recs, f"phase 10 ({name})"),
                compare(state_fields(got_state), state_fields(want_state),
                        f"phase 10 ({name}) state"))
        err = max(err, e)
        n, m = checked.get(name, (0, 0.0))
        checked[name] = (n + 1, max(m, e))
    say("10", "kernel calls == the padded plain loop on their own inputs: "
              + ", ".join(f"({k}) {n} call(s) max abs err {m:.3g}"
                          for k, (n, m) in checked.items()))

    # Warm host time per search and per generation, by stage.
    def host_ms(fn, reps):
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    warm, per_gen, by_stage, evals = {}, {}, {}, {}
    tpar._codesign_core = checked_core
    ops.launch = timed_launch
    try:
        for label in ("a", "b", "a-host"):
            loop_ms.clear()
            stages.clear()
            reps = 3
            warm[label] = host_ms(entry[label], reps)
            gens = kw[label[0]]["generations"]
            evals[label] = res[label]["candidate_evals"] \
                / (warm[label] / 1e3)
            if label == "a-host":
                continue
            per_gen[label] = float(np.median(loop_ms)) / gens
            st = {k: v * 1e3 / reps / gens for k, v in stages.items()}
            st["archive"] = st.get("archive", 0.0) * gens
            st["copy out and set-up"] = warm[label] \
                - float(np.median(loop_ms))
            by_stage[label] = st
    finally:
        tpar._codesign_core = real_core
        ops.launch = real_launch
    for label in ("a", "b"):
        st = by_stage[label]
        say("10", f"({label}) warm host ms per search {warm[label]:.2f} "
                  f"(median of 3), per generation {per_gen[label]:.3f}; by "
                  f"stage, ms per generation: proposals "
                  f"{st.get('proposals', 0):.3f}, tables "
                  f"{st.get('tables', 0):.3f}, score "
                  f"{st.get('score', 0):.3f} (of it the launch call "
                  f"{st.get('launch', 0):.3f}), objectives and acceptance "
                  f"{st.get('acceptance', 0):.3f}; per search: archive "
                  f"replay {st['archive']:.3f}, copy out and set-up "
                  f"{st['copy out and set-up']:.3f}; "
                  f"{evals[label]:.0f} candidate evaluations per second; "
                  f"card: {card}")
    say("10", f"(a) through the host engine: warm {warm['a-host']:.2f} ms "
              f"({warm['a-host'] / warm['a']:.2f}x the device engine's), "
              f"{evals['a-host']:.0f} candidate evaluations per second; "
              f"card: {card}")
    prof = device_breakdown(entry["b"], "(b) warm co-design", top=6,
                            phase="10")
    idle = None if prof is None else \
        1.0 - sum(prof[1].values()) / 1e6 / prof[0]
    say("10", f"(b) warm co-design: device idle share "
              f"{'not measured' if idle is None else f'{idle:.1%}'} of a "
              f"profiled call; card: {card}")

    # Device time per launch shape: one generation's launch.
    def shape_row(state0, xs, csim, tbl, k):
        n_tr, t_len, c = xs[0].shape
        n_lanes = int(k["lane_trace"].shape[0])
        dest = k.get("dest") is not None
        kern = ops.variant(c, False, dest, n_lanes, padded=True)
        ms = time_graph(lambda: ops.launch(state0.ctl.g, xs, csim, tbl,
                                           **k))
        plain = time_cuda(lambda: epoch_run_reference(
            state0, xs, csim, tbl, **k), 1)[0]
        g_slots = csim.cfg.max_gateways_per_chiplet
        lane_c = k["topo"]["n_chiplets"].cpu().numpy()
        pair_c = None
        if dest:
            di = k["dest_index"].cpu().numpy()
            pair_c = [int(lane_c[np.argmax(di == p)])
                      for p in range(int(k["dest"].shape[0]))]
        nbytes, n_ops = padded_epoch_work(
            n_tr, t_len, c, g_slots, lane_c,
            k["topo"]["g_max"].cpu().numpy(), pair_c)
        bound, by = max((nbytes / H100.hbm_bytes_per_s * 1e3, "bytes"),
                        (n_ops / H100.peak_f32_flops * 1e3, "operations"))
        return {"variant": kern + "+topo", "lanes": n_lanes,
                "intervals": t_len, "chiplets": c,
                "dest_matrices": int(dest), "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by}

    rows = {}
    for label in ("a", "a-host", "b"):
        _, state0, xs, csim, tbl, k, _ = next(c for c in calls
                                              if c[0] == label)
        row = shape_row(state0, xs, csim, tbl, k)
        if label in per_gen:
            row.update(host_ms_per_generation=per_gen[label],
                       host_ms_per_search=warm[label],
                       evaluations_per_s=evals[label])
        rows[f"pareto-{label}"] = row
        say("10", f"epoch_step ({label}) generation launch ({row['variant']}"
                  f"; {row['lanes']} lanes x {row['intervals']} intervals x "
                  f"{row['chiplets']} chiplets"
                  f"{', destination matrices' if row['dest_matrices'] else ''}"
                  f"): {row['ms']:.4f} ms (device: CUDA-graph replays, "
                  f"median of 5); plain loop {row['plain_ms']:.2f} ms once; "
                  f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}; "
                  f"card: {card}")

    # What "wide" costs per padded chiplet: (b)'s first launch on its
    # 64-chiplet lanes alone and on its 256-chiplet lanes alone (both
    # padded to 256), and on the 64-chiplet lanes unpadded.
    _, state0, xs, csim, tbl, k, _ = next(c for c in calls if c[0] == "b")
    lane_c = k["topo"]["n_chiplets"]
    pad_ms = {}
    for c_pt in (min(PARETO_COUNTS), max(PARETO_COUNTS)):
        sel = torch.nonzero(lane_c == c_pt)[:, 0]
        sub = dict(k, lane_trace=k["lane_trace"][sel],
                   knobs={n: v[sel] for n, v in k["knobs"].items()},
                   topo={n: v[sel] for n, v in k["topo"].items()},
                   dest_index=k["dest_index"][sel])
        g0 = state0.ctl.g[sel]
        pad_ms[c_pt] = time_graph(lambda: ops.launch(g0, xs, csim, tbl,
                                                     **sub))
        if c_pt == min(PARETO_COUNTS):
            c0 = c_pt
            sim0 = dataclasses.replace(csim, cfg=dataclasses.replace(
                csim.cfg, n_chiplets=c0))
            xs0 = (xs[0][..., :c0], xs[1], xs[2][..., :c0], xs[3], xs[4])
            sub0 = dict(sub, topo=dict(sub["topo"],
                                       chip_mask=sub["topo"]["chip_mask"]
                                       [:, :c0]),
                        dest=k["dest"][:, :c0, :c0].contiguous())
            g00 = g0[:, :c0].contiguous()
            unpadded = time_graph(lambda: ops.launch(g00, xs0, sim0, tbl,
                                                     **sub0))
            n_sel = int(sel.shape[0])
    say("10", f"(b) one launch on its {n_sel} lanes of "
              f"{min(PARETO_COUNTS)} chiplets padded to "
              f"{max(PARETO_COUNTS)}: {pad_ms[min(PARETO_COUNTS)]:.4f} ms; "
              f"on its {n_sel} lanes of {max(PARETO_COUNTS)} chiplets: "
              f"{pad_ms[max(PARETO_COUNTS)]:.4f} ms; the "
              f"{min(PARETO_COUNTS)}-chiplet lanes unpadded: "
              f"{unpadded:.4f} ms (device, CUDA-graph replays); card: "
              f"{card}")
    rows["pareto-b-64-padded"] = {"ms": pad_ms[min(PARETO_COUNTS)],
                                  "lanes": n_sel}
    rows["pareto-b-256"] = {"ms": pad_ms[max(PARETO_COUNTS)], "lanes": n_sel}
    rows["pareto-b-64-unpadded"] = {"ms": unpadded, "lanes": n_sel}
    return {"epoch_launches": launches.get(ops.NAME, 0), "epoch_err": err,
            "epoch_shapes": rows, "variants": variants,
            "warm_host_ms": warm, "host_stages": by_stage,
            "idle_share": idle,
            "partings": {k: None if v is None else str(v)
                         for k, v in partings.items()}}


FLEET_DEVICES = 4        # emulated devices of phase 11 (a), on the card
FLEET_PROCESSES = 2


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def fleet_phase(dev, card: str) -> dict:
    """Phase 11, fleet and caching, a main path of its own (counters zeroed
    just before (a)'s sharded sweep, read just after it): (a)
    `sweep_workload` over the fleet launcher's default 64-point grid
    (`launch.fleet.build_grid`: chiplets 4-64 x 4 placements x 4
    workloads, 24 intervals, keys and widths pinned as the launcher pins
    them) sharded over FLEET_DEVICES emulated devices of the card
    (`devices=["cuda:0"] * 4`: one epoch_step launch a block, every block
    at the whole grid's padded shapes and design), bitwise the one-device
    call's, every block's launch held against the padded plain loop; (b)
    `python -m repro_torch.launch.fleet` as one process, as a
    FLEET_PROCESSES-process gloo group on the card, and as `--shard 0:2` /
    `1:2`, every point equal to the one-process run's (and to (a)'s); (c)
    a 1-rank NCCL group running `laned_all_reduce` at lanes 1, 2 and 4,
    the bits of one `all_reduce` of each leaf; (d) a cold and a warm child
    process sharing a fresh REPRO_CACHE_DIR: the cold one builds
    epoch_step, the warm one runs no nvcc. Prints the points per second
    of (a) and (b) and (d)'s first-call times, each beside the card's name
    and power limit."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch import backend
    from repro_torch import random as trandom
    from repro_torch.core import reconfig_runtime as rr
    from repro_torch.core import simulator as S
    from repro_torch.kernels.epoch_step import ops
    from repro_torch.kernels.epoch_step.ref import epoch_run_reference
    from repro_torch.launch import fleet

    sim = S.SimConfig().with_arch(S.Arch.RESIPI)
    args = fleet.build_parser().parse_args([])
    grid = fleet.build_grid(sim.cfg, chiplets=args.chiplets,
                            placements=args.placements,
                            workloads=args.workloads,
                            intervals=args.intervals, seed=args.seed)
    k = grid["k"]
    keys = trandom.split(trandom.prng_key(args.seed, device=dev), k)
    gen_c = max(args.chiplets)
    devices = ["cuda:0"] * FLEET_DEVICES

    def run(devs):
        out = S.sweep_workload(grid["specs"], sim, keys=keys,
                               gen_chiplets=gen_c, pad_chiplets=gen_c,
                               device=dev, devices=devs, **grid["grids"])
        torch.cuda.synchronize()
        return out

    one = run(None)                  # the one-device call, compared with
    calls = []
    kernel_epoch_run = ops.epoch_run

    def recorded_epoch_run(state, xs, csim, tables, **kw):
        out = kernel_epoch_run(state, xs, csim, tables, **kw)
        calls.append((state, xs, csim, tables, kw, out))
        return out

    ops.epoch_run = recorded_epoch_run
    try:
        torch.cuda.synchronize()
        backend.reset_counters()                 # main path starts
        t0 = time.perf_counter()
        sharded = run(devices)
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(backend.COUNTERS["launches"])  # main path ends
        variants = dict(backend.COUNTERS["variants"])
    finally:
        ops.epoch_run = kernel_epoch_run
    design = ops.variant(gen_c, False, False, k, padded=True)
    want = {f"{ops.NAME}:{design}+topo": FLEET_DEVICES}
    if variants != want or launches.get(ops.NAME, 0) != FLEET_DEVICES:
        fail(f"phase 11 (a) launched {launches} / {variants}, expected "
             f"{want}")
    want_sharding = {"grid_points": k, "pad_lanes": 0,
                     "devices": FLEET_DEVICES, "processes": 1}
    if sharded.get("sharding") != want_sharding:
        fail(f"phase 11 (a) sharding {sharded.get('sharding')}, expected "
             f"{want_sharding}")
    for part in ("records", "summary"):
        for name, v in one[part].items():
            if not torch.equal(sharded[part][name], v):
                fail(f"phase 11 (a): sharded {part} {name} differs from the "
                     f"one-device call")
    err = 0.0
    for state, xs, csim, tables, kw, (got_state, got) in calls:
        want_state, want_recs = epoch_run_reference(state, xs, csim, tables,
                                                     **kw)
        err = max(err, compare(got, want_recs, "phase 11 (a) block"),
                  compare(state_fields(got_state), state_fields(want_state),
                          "phase 11 (a) block state"))
    summ = sharded["summary"]
    for name, v in summ.items():
        if name != "pad_lanes" and (tuple(v.shape) != (k,)
                                    or not torch.isfinite(v).all()):
            fail(f"phase 11 (a) summary {name} malformed")
    say("11", f"(a) sweep_workload, the fleet's {k}-point grid on "
              f"{FLEET_DEVICES} emulated devices of the card: "
              f"{json.dumps(launches)} launches ({json.dumps(variants)}), "
              f"bitwise the one-device call; every block == the padded "
              f"plain loop (max abs err {err:.3g}); first call "
              f"{first_ms:.1f} ms")
    warm_ms = {}
    for label, devs in (("sharded", devices), ("one-device", None)):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(devs)
            times.append((time.perf_counter() - t0) * 1e3)
        warm_ms[label] = float(np.median(times))
    pps_a = k / (warm_ms["sharded"] * 1e-3)
    print(f"phase 11 (a) points/s: {pps_a:.1f} ({k} points in "
          f"{warm_ms['sharded']:.2f} ms warm, host clock, median of 3; the "
          f"one-device call {warm_ms['one-device']:.2f} ms); card: {card}",
          flush=True)
    state, xs, csim, tables, kw, _ = calls[0]
    ms = time_graph(lambda: ops.launch(state.ctl.g, xs, csim, tables, **kw))
    plain = time_cuda(lambda: epoch_run_reference(state, xs, csim, tables,
                                                  **kw), 1)[0]
    n_tr, t_len, c = xs[0].shape
    if n_tr != k // FLEET_DEVICES:
        fail(f"phase 11 (a): a block holds {n_tr} traces; its lanes read "
             f"{k // FLEET_DEVICES}")
    lane_c = kw["topo"]["n_chiplets"].cpu().numpy()
    lane_g = kw["topo"]["g_max"].cpu().numpy()
    nbytes, n_ops = padded_epoch_work(
        n_tr, t_len, c, csim.cfg.max_gateways_per_chiplet, lane_c, lane_g)
    bound, by = max((nbytes / H100.hbm_bytes_per_s * 1e3, "bytes"),
                    (n_ops / H100.peak_f32_flops * 1e3, "operations"))
    rows = {"fleet-block": {
        "variant": kw["kernel"] + "+topo", "lanes": len(lane_c),
        "traces": n_tr,
        "intervals": t_len, "chiplets": c, "ms": ms, "plain_ms": plain,
        "bound_ms": bound, "bound_by": by,
        "host_ms": warm_ms["sharded"] / FLEET_DEVICES}}
    say("11", f"epoch_step fleet-block launch ({kw['kernel']}+topo; "
              f"{len(lane_c)} lanes x {t_len} intervals x {c} chiplets, "
              f"the block's own {n_tr} traces): "
              f"{ms:.4f} ms (device: CUDA-graph replays, median of 5); "
              f"plain loop {plain:.2f} ms once; bound {bound:.4f} ms by {by} "
              f"({nbytes / 1e6:.2f} MB, {n_ops / 1e9:.4f} GFLOP); card: "
              f"{card}")

    # (b) the launcher: one process, a gloo group, emulated hosts.
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="fleet-", dir=ROOT / "build"))
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_CACHE_DIR", None)

    def launcher(name, *extra, env=env):
        out = tmp / f"{name}.json"
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.fleet",
             "--dump-points", "--out", str(out), *extra], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or not out.exists():
            fail(f"phase 11 fleet {name} exited {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        return json.loads(out.read_text())

    point_keys = ("labels", "mean_latency", "mean_power_mw", "mean_energy")
    single = launcher("single", "--reps", "3")
    for name in point_keys[1:]:
        if single[name] != [float(v) for v in
                            one["summary"][name].double().cpu()]:
            fail(f"phase 11 (b): the one-process fleet's {name} differs from "
                 f"(a)'s one-device call")
    group = launcher("gloo", "--reps", "3", "--processes",
                     str(FLEET_PROCESSES), "--collectives", "gloo")
    shards = [launcher(f"shard{i}", "--shard", f"{i}:{FLEET_PROCESSES}")
              for i in range(FLEET_PROCESSES)]
    if (group["mode"], group["process_count"]) != ("distributed",
                                                   FLEET_PROCESSES):
        fail(f"phase 11 (b): the group ran as {group['mode']} x "
             f"{group['process_count']}")
    for name in point_keys:
        if group[name] != single[name]:
            fail(f"phase 11 (b): the {FLEET_PROCESSES}-process gloo fleet's "
                 f"{name} differs from the one-process run's")
        if [v for sh in shards for v in sh[name]] != single[name]:
            fail(f"phase 11 (b): the --shard i:{FLEET_PROCESSES} runs' "
                 f"{name}, concatenated, differ from the one-process run's")
    say("11", f"(b) python -m repro_torch.launch.fleet: one process, a "
              f"{FLEET_PROCESSES}-process gloo group (launches "
              f"{json.dumps(group['kernel_launches'])} in rank 0) and "
              f"--shard i:{FLEET_PROCESSES} give the same {k} points bit for "
              f"bit (and (a)'s); builds in the children: "
              f"{[r['kernel_builds'] for r in [single, group] + shards]}")
    for label, r in (("one process", single), ("gloo group", group)):
        print(f"phase 11 (b) points/s: {r['points_per_sec']:.1f} "
              f"({label}, {r['process_count']} x {r['device']}: sweep "
              f"{r['sweep_wall_s'] * 1e3:.2f} ms warm, min of 3, host clock; "
              f"first call {r['first_call_s']:.2f} s); card: {card}",
              flush=True)

    # (c) a 1-rank NCCL group: the lanes' chunks give one all_reduce's bits.
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        gen = torch.Generator().manual_seed(11)
        tree = {"w": torch.randn(512, 96, generator=gen).to(dev),
                "b": [torch.randn(4099, generator=gen).to(dev),
                      torch.randn(33, generator=gen).double().to(dev)],
                "n": torch.randint(0, 99, (77,), generator=gen).to(dev)}
        leaves = {"w": tree["w"], "b0": tree["b"][0], "b1": tree["b"][1],
                  "n": tree["n"]}
        single_ar = {}
        for name, v in leaves.items():
            x = v.clone()
            dist.all_reduce(x)
            single_ar[name] = x
        lane_ms = {}
        for lanes in (1, 2, 4):
            t0 = time.perf_counter()
            out = rr.laned_all_reduce(tree, dist.group.WORLD, lanes)
            torch.cuda.synchronize()
            lane_ms[lanes] = (time.perf_counter() - t0) * 1e3
            got = {"w": out["w"], "b0": out["b"][0], "b1": out["b"][1],
                   "n": out["n"]}
            for name, v in single_ar.items():
                if not torch.equal(got[name], v):
                    fail(f"phase 11 (c): laned_all_reduce at {lanes} lanes, "
                         f"leaf {name}, differs from one all_reduce")
    finally:
        dist.destroy_process_group()
    say("11", f"(c) laned_all_reduce over a 1-rank NCCL group at lanes 1, "
              f"2, 4: the bits of one all_reduce per leaf; host ms "
              f"{json.dumps({k_: round(v, 3) for k_, v in lane_ms.items()})}"
              f"; card: {card}")

    # (d) cold and warm workers sharing a fresh library cache.
    shared = Path(tempfile.mkdtemp(prefix="cache-", dir=ROOT / "build"))
    cache_env = dict(env, REPRO_CACHE_DIR=str(shared))
    cold = launcher("cold", env=cache_env)
    warm = launcher("warm", env=cache_env)
    if cold["kernel_builds"] != {ops.NAME: 1} or warm["kernel_builds"]:
        fail(f"phase 11 (d): builds cold {cold['kernel_builds']}, warm "
             f"{warm['kernel_builds']}; expected one epoch_step build, then "
             f"none")
    if warm["cache"]["entries"] != 1 or warm["cache"]["dir"] != str(shared):
        fail(f"phase 11 (d): the warm worker's cache {warm['cache']}")
    for name in point_keys:
        if cold[name] != single[name] or warm[name] != single[name]:
            fail(f"phase 11 (d): the cold or warm worker's {name} differs")
    print(f"phase 11 (d) first call: cold worker {cold['first_call_s']:.2f} s "
          f"(nvcc built epoch_step into the shared cache), warm worker "
          f"{warm['first_call_s']:.2f} s (loaded it, no build: "
          f"{warm['kernel_builds']}); host clock; card: {card}", flush=True)
    return {"epoch_launches": launches.get(ops.NAME, 0), "epoch_err": err,
            "epoch_shapes": rows, "variants": variants,
            "points_per_sec": {"a": pps_a, "b-one": single["points_per_sec"],
                               "b-gloo": group["points_per_sec"]},
            "first_call_s": {"cold": cold["first_call_s"],
                             "warm": warm["first_call_s"]},
            "laned_all_reduce_ms": lane_ms}


def main() -> int:
    global SRC
    args = sys.argv[1:]
    grid_only = args == ["--epoch-grid"]
    search_only = args == ["--search"]
    serve_only = args == ["--serve"]
    pareto_only = args == ["--pareto"]
    fleet_only = args == ["--fleet"]
    families_only = args == ["--llm-families"]
    train_only = args == ["--train"]
    dryrun_only = args == ["--dryrun"]
    rows_ab = args[:1] == ["--rows-ab"] and (
        len(args) == 1 or (len(args) == 3 and args[1] == "--src"))
    if args and not (grid_only or rows_ab or search_only or serve_only
                     or pareto_only or fleet_only or families_only
                     or train_only or dryrun_only):
        print("usage: chip_smoke.py [--epoch-grid | --search | --serve | "
              "--pareto | --fleet | --llm-families | --train | --dryrun | "
              "--rows-ab [--src DIR]]", file=sys.stderr)
        return 2
    if rows_ab and len(args) == 3:
        SRC = Path(args[2]).resolve()
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
    global H100
    from repro_torch.core.constants import H100

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

    t_run = time.perf_counter()
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
    if grid_only or rows_ab or search_only or serve_only or pareto_only \
            or fleet_only or families_only or train_only or dryrun_only:
        if grid_only:
            ops.build()
            result = {"design_grid": epoch_design_grid(dev, card, GRID_FULL,
                                                       "grid")}
        elif search_only:
            ops.build()
            result = {"device_search": search_phase(dev, card)}
            result["device_search"].pop("variants")
        elif serve_only:
            ops.build()
            result = {"serving": serve_phase(dev, card)}
            result["serving"].pop("variants")
        elif pareto_only:
            ops.build()
            result = {"pareto": pareto_phase(dev, card)}
            result["pareto"].pop("variants")
        elif fleet_only:
            ops.build()
            result = {"fleet": fleet_phase(dev, card)}
            result["fleet"].pop("variants")
        elif families_only:
            fops.build()
            result = {"llm_families": llm_families_phase(dev, card, fops,
                                                         sops)}
        elif train_only:
            with ThreadPoolExecutor(2) as pool:
                for f in [pool.submit(m.build) for m in (fops, sops)]:
                    f.result()
            result = {"training": train_phase(dev, card, fops, sops)}
        elif dryrun_only:
            with ThreadPoolExecutor(3) as pool:
                for f in [pool.submit(m.build) for m in (fops, sops, ops)]:
                    f.result()
            result = {"analysis": analysis_phase(dev, card)}
        else:
            result = epoch_rows_ab(dev, card)
        print(json.dumps(result), flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": kind,
                                                 "count": count}}),
              flush=True)
        return 0
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
                              ("wide", "epoch_recv_kernel"),
                              ("wide", "epoch_wide_recurrence_kernel"),
                              ("wide", "epoch_wide_metrics_kernel"),
                              ("warp", "epoch_step_kernel"))),
                       (nops, (("node", "noc_node_kernel"),
                               ("warp", "noc_step_kernel"))),
                       (fops, (("wgmma", "flash_wgmma_kernel"),
                               ("simt", "flash_attention_kernel")))):
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
        # The other designs ("warp", "wide") on the same inputs, held alike.
        other_err = {}
        for kern in ("warp", "wide"):
            o_state, o = ops._reassemble(
                state0, ops.launch(state0.ctl.g, xs, sim, tables,
                                   kernel=kern, **kw), xs, sim, kw["faulted"])
            torch.cuda.synchronize()
            other_err[kern] = max(
                compare(o, want, f"{name} ({kern} kernel)"),
                compare(state_fields(o_state), state_fields(want_state),
                        f"{name} state ({kern} kernel)"))
        if name.startswith("ragged"):
            # The all-masked lane returns its input carry untouched.
            lane = state_fields(got_state)
            for k, v in state_fields(state0).items():
                if not torch.equal(lane[k][3], v[3]):
                    fail(f"all-masked lane changed its carry ({k})")
        max_err = max(max_err, err)
        say("2", f"{name}: {int(kw['lane_trace'].shape[0])} lanes x "
                 f"{xs[0].shape[1]} intervals, {ran} kernel == plain "
                 f"(max abs err {err:.3g}; warp kernel "
                 f"{other_err['warp']:.3g}, wide kernel "
                 f"{other_err['wide']:.3g})")

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
    # Figs. 10-12 draw the reference's workloads (the threefry twin, the
    # seeds and keys of its scripts), so they must give its numbers.
    traces11 = figures.fig11_traces(T_INTERVALS, seed=1, device=dev)
    traces10 = figures.fig10_traces(60, seed=7, device=dev)
    seq = figures.fig12_trace(T_INTERVALS, seed=3, device=dev)
    phase = "fig11"
    sim_mod.reset_engine_stats()
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
        + " (paper -37% / -25% / -53%; the reference -"
        + " / -".join(FIG11_REFERENCE.values()) + ")")
    for k, v in deltas.items():
        if f"{v:.1%}" != FIG11_REFERENCE[k]:
            fail(f"fig11 {k} reduction vs PROWAVES {v:.4%} is not the "
                 f"reference's {FIG11_REFERENCE[k]}")
    phase = "fig10"
    f10 = figures.fig10_dse(traces10, device=dev)
    say("3", f"fig10 L_m selected {f10['l_m_selected']:.4f} (paper "
             f"0.0152, the reference {FIG10_REFERENCE_LM}), "
             f"{f10['n_accepted']} points in the 10% band")
    if f"{f10['l_m_selected']:.4f}" != FIG10_REFERENCE_LM:
        fail(f"fig10 L_m {f10['l_m_selected']:.5f} is not the reference's "
             f"{FIG10_REFERENCE_LM}")
    phase = "fig12"
    f12 = figures.fig12_adaptivity(seq, per_app=T_INTERVALS, device=dev)
    say("3", f"fig12 settle after switches: ReSiPI "
             f"{f12['adaptation']['resipi_settle']}, PROWAVES "
             f"{f12['adaptation']['prowaves_settle']} (paper ~3 / ~5; the "
             f"reference {FIG12_REFERENCE['resipi_settle']} / "
             f"{FIG12_REFERENCE['prowaves_settle']}); max gateways "
             f"{f12['max_gateways_used']} (paper 18)")
    for k in ("latency_resipi", "power_resipi", "latency_prowaves"):
        if not np.all(np.isfinite(f12[k])) or len(f12[k]) != 3 * T_INTERVALS:
            fail(f"fig12 {k} malformed")
    got12 = dict(f12["adaptation"], max_gateways_used=f12["max_gateways_used"])
    if got12 != FIG12_REFERENCE:
        fail(f"fig12 {got12} is not the reference's {FIG12_REFERENCE}")

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

    # Kernel times per launch shape, every design on the same inputs: the
    # device time of the launch(es) alone (CUDA-graph replays, median of 5)
    # and the wrapper call around them (CUDA events, median of 5).
    epoch_shapes = {}
    for label, (_, state0, xs, csim, tables, kw, _) in shape_calls.items():
        row = {}
        for kern in ("split", "warp", "wide"):
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
        bound, by = max((nbytes / H100.hbm_bytes_per_s * 1e3, "bytes"),
                        (n_ops / H100.peak_f32_flops * 1e3, "operations"))
        epoch_shapes[label] = dict(row, lanes=n_lanes, intervals=t_len,
                                   bound_ms=bound, bound_by=by)
        say("4", f"epoch_step {label} launch ({n_lanes} lane(s) x {t_len} "
                 f"intervals): split {row['split_ms']:.4f} ms, warp "
                 f"{row['warp_ms']:.4f} ms, wide {row['wide_ms']:.4f} ms "
                 f"(device: CUDA-graph replays, median of 5; split "
                 f"{'fastest' if row['split_ms'] < min(row['warp_ms'], row['wide_ms']) else 'NOT fastest'}"
                 f"); wrapper call split {row['split_call_ms']:.4f} / warp "
                 f"{row['warp_call_ms']:.4f} / wide {row['wide_call_ms']:.4f} "
                 f"ms; bound {bound:.4f} ms by {by} "
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
    # "node-1024" is the node kernel's instantiation bounded to 1024
    # threads, which runs R > 128, forced here at R <= 128 (NOC_AB) and
    # held bitwise to the 128-bounded one the wrapper runs.
    noc_shapes = {}
    kernel_build = nops.build
    for label, prep in noc_preps.items():
        row = {}
        for name in ("node", "warp", "node-1024") * 2:
            lib = noc_ab_libs.get(name) or kernel_build()
            kern = "warp" if name == "warp" else "node"
            first = name == "node-1024" and name not in row
            want = nops.run_prepared(prep) if first else None
            nops.build = lambda: lib                    # noqa: B023
            try:
                run = lambda: nops.run_prepared(prep, kernel=kern)  # noqa
                for a, b in zip(run() if first else (), want or ()):
                    if not torch.equal(a, b):
                        fail(f"noc_step {label}: the node kernel bounded "
                             f"to 1024 threads differs from the 128-bounded "
                             f"one")
                time_cuda(run, 2)
                row.setdefault(name, []).append(
                    float(np.median(time_cuda(run, 5))))
            finally:
                nops.build = kernel_build
        b_runs, t_cyc, _ = prep["arrivals"].shape
        nbytes, n_ops = noc_work(prep, noc_kw[label].get("t_mask")
                                 is not None, nops.MAX_IN_DEGREE)
        bound, by = max((nbytes / H100.hbm_bytes_per_s * 1e3, "bytes"),
                        (n_ops / H100.peak_f32_flops * 1e3, "operations"))
        noc_shapes[label] = {"runs": b_runs, "cycles": t_cyc,
                             "ms": row["node"][0], "warp_ms": row["warp"][0],
                             "ms_again": row["node"][1],
                             "warp_ms_again": row["warp"][1],
                             "node1024_ms": row["node-1024"][0],
                             "node1024_ms_again": row["node-1024"][1],
                             "bound_ms": bound, "bound_by": by}
        say("4", f"noc_step {label} launch ({b_runs} run(s) x {t_cyc} "
                 f"cycles): node {row['node'][0]:.4f} ms (again "
                 f"{row['node'][1]:.4f}), warp {row['warp'][0]:.4f} ms (again "
                 f"{row['warp'][1]:.4f}), node bounded to 1024 threads "
                 f"{row['node-1024'][0]:.4f} ms (again "
                 f"{row['node-1024'][1]:.4f}) (CUDA events, median of 5 "
                 f"each, in turns); "
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

    # --- 5. streaming, session ticks, fault sweeps, F1 (a main path) -------
    p5 = stream_phase(dev, card)

    # --- 6. LLM serving (a main path a model) --------------------------------
    llm = serve_llms(dev, card, fops, sops, llm_err)

    # --- 12. the remaining LLM families (a main path a run) ----------------
    p12 = llm_families_phase(dev, card, fops, sops)
    flash_row = llm[0]
    flash_row["launches_by_path"] = {"zamba2+mamba2": flash_row["launches"],
                                     "llm families": p12["launches"]}
    flash_row["launches"] += p12["launches"]
    flash_row["max_abs_err"] = max(flash_row["max_abs_err"],
                                   p12["max_abs_err"])
    flash_row["shapes"] = {"pixtral-12b prefill": p12["shape"]}

    # --- 13. training (a main path a run) -----------------------------------
    p13 = train_phase(dev, card, fops, sops)
    ssd_row = llm[1]
    for row in (flash_row, ssd_row):
        trained = p13[row["name"]]
        row.setdefault("launches_by_path", {
            "zamba2+mamba2": row["launches"]})
        row["launches_by_path"]["training"] = trained["launches"]
        row["launches"] += trained["launches"]
        row["max_abs_err"] = max(row["max_abs_err"], trained["max_abs_err"])
        row["training"] = dict(trained["runs"], backward="plain VJP "
                               "(backward_plain: the plain version's "
                               "autograd, recomputed from the saved inputs)")
        row.setdefault("shapes", {})[
            f"{next(iter(trained['runs']))} training"] = trained["shape"]

    # --- 7. topology and placement DSE (a main path) ------------------------
    p7 = topology_phase(dev, card)

    # --- 8. the device placement search (a main path) ----------------------
    p8 = search_phase(dev, card)

    # --- 9. serving and resilience (a main path) ---------------------------
    p9 = serve_phase(dev, card)

    # --- 10. Pareto co-design (a main path) ---------------------------------
    p10 = pareto_phase(dev, card)

    # --- 11. fleet and caching (a main path) --------------------------------
    p11 = fleet_phase(dev, card)

    # --- 14. the dry run, its op analysis and the roofline on the card ------
    p14 = analysis_phase(dev, card, p13)
    say("15", f"phases 1-14 in {time.perf_counter() - t_run:.1f} s "
              f"(phase 14 {p14['seconds']:.1f} s); card: {card}")

    # --- 15. kernels line ---------------------------------------------------
    def ran(name):
        return ",".join(sorted({k.split(":")[1] for k in
                                list(variants) + list(p5["variants"])
                                + list(p7["variants"])
                                + list(p8["variants"])
                                + list(p9["variants"])
                                + list(p10["variants"])
                                + list(p11["variants"])
                                if k.startswith(name + ":")}))

    print(json.dumps({"kernels": [{
        "name": ops.NAME, "route": "cuda", "variant": ran(ops.NAME),
        "source": "src/repro_torch/kernels/epoch_step/csrc/epoch_step.cu",
        "replaces": "src/repro/kernels/epoch_step/kernel.py:48",
        "launches": stats["epoch_step_launches"] + p5["epoch_launches"]
        + p7["epoch_launches"] + p8["epoch_launches"]
        + p9["epoch_launches"] + p10["epoch_launches"]
        + p11["epoch_launches"],
        "launches_by_path": {"paper+dse": stats["epoch_step_launches"],
                             "streaming+faults+f1": p5["epoch_launches"],
                             "topology+placement": p7["epoch_launches"],
                             "device search": p8["epoch_launches"],
                             "serve+resilience": p9["epoch_launches"],
                             "pareto co-design": p10["epoch_launches"],
                             "fleet": p11["epoch_launches"]},
        "max_abs_err": max(max_err, p5["epoch_err"], p7["epoch_err"],
                           p8["epoch_err"], p9["epoch_err"],
                           p10["epoch_err"], p11["epoch_err"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "warp_ms": warp_ms,
        "shapes": dict(epoch_shapes, **p5["epoch_shapes"],
                       **p7["epoch_shapes"], **p8["epoch_shapes"],
                       **p9["epoch_shapes"], **p10["epoch_shapes"],
                       **p11["epoch_shapes"]),
        "design_choice": p5["design_choice"]}, {
        "name": nops.NAME, "route": "cuda", "variant": ran(nops.NAME),
        "source": "src/repro_torch/kernels/noc_step/csrc/noc_step.cu",
        "replaces": "src/repro/kernels/noc_step/kernel.py:32",
        "launches": noc_launches + p5["noc_launches"],
        "launches_by_path": {"paper+dse": noc_launches,
                             "streaming+faults+f1": p5["noc_launches"]},
        "max_abs_err": max(noc_err, p5["noc_err"]), "ms": noc_dse_ms,
        "plain_ms": noc_plain_ms, "bound_ms": noc_bound_ms,
        "bound_by": noc_bound_by, "library_ms": None,
        "warp_ms": noc_shapes["dse"]["warp_ms"],
        "shapes": dict(noc_shapes, **p5["noc_shapes"])}]
        + llm}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
