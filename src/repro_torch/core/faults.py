"""Fault injection for the 2.5D interposer network.

Port of `repro.core.faults`. ReSiPI's headline claim is run-time
reconfiguration, which matters when the network has to react to what goes
wrong at run time: gateway hardware dying, interposer links flapping, PCM
cells sticking, and slow optical loss drift. This module makes those events
first-class:

  * `FaultSpec` hierarchy — frozen/hashable dataclasses describing what
    fails (`GatewayFault` hard failures, `LinkFlap` Markov up/down link
    state, `PcmStuckCell` stuck-off/stuck-on cells, `LossDrift` slow
    dB-per-interval laser-budget erosion). Specs target either a gateway
    slot (activation-order index) or a physical router position, which
    resolves against whatever placement the config currently carries.
  * `compile_faults(specs, cfg, n_intervals)` — specs compile into a dense
    time-varying fault frame (`FAULT_KEYS`, numpy float32) that rides
    inside the trace dict (`attach_faults`), so the trace transforms
    (`pad_trace` / `chunk_trace` / `concat_traces`) align fault events to
    chunk boundaries, and the simulator threads them through the interval
    loop: a K-frame grid is `simulator.sweep_faults`, one kernel launch of
    K lanes on the card. Stochastic specs draw from numpy's `RandomState`
    exactly as the reference does, so a frame equals the reference's.
  * A failed gateway lane is dead — zero laser/ring power, zero capacity,
    zero reconfiguration energy — like a padded slot, and a frame that
    never fires inside the window is the fault-free run.
  * `FaultInjector` — the closed-loop environment: physical fault specs,
    per-chunk frames compiled against the current placement (re-placing
    gateways off dead routers really heals the network, LRU-cached per
    placement) and the hardware status register (`failed_positions`).
  * `placement_reconfig_cost` — the PCM switching bill of a live
    re-placement.

Fault frame semantics (all float32):

  gw_ok    [T, C, G]  1 = the slot's hardware is usable this interval.
  stuck_on [T, C, G]  1 = the slot's PCM cells are stuck coupling: the
                      lane burns laser/ring power even when the controller
                      wants it dark (a stuck-on lane that failed stays
                      dead).
  drift_db [T]        extra optical loss added to the placement's access
                      loss (costs laser power).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.constants import NETWORK, PHOTONIC_POWER, NetworkConfig
from repro_torch.core.selection import (normalize_placement,
                                        resolve_gateway_positions)
from repro_torch.core.simulator import FAULT_KEYS

# ---------------------------------------------------------------------------
# Spec hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Base class: a time-windowed fault. Frozen/hashable like TrafficSpec.

    `start`/`end` are reconfiguration-interval indices ([start, end), end
    None = open-ended). Subclasses add the what; `compile_faults` turns a
    list of specs into the dense fault frame.
    """
    start: int = 0
    end: Optional[int] = None

    def __post_init__(self):
        if self.start < 0:
            raise ValueError(f"{type(self).__name__}.start must be >= 0, "
                             f"got {self.start}")
        if self.end is not None and self.end < self.start:
            raise ValueError(f"{type(self).__name__}: end {self.end} < "
                             f"start {self.start}")

    def _window(self, n_intervals: int) -> np.ndarray:
        t = np.arange(n_intervals)
        hi = n_intervals if self.end is None else self.end
        return (t >= self.start) & (t < hi)


def _resolve_slot(spec, cfg: NetworkConfig) -> Optional[int]:
    """Slot index a spec targets under `cfg`'s placement, or None.

    Position-targeted specs model broken hardware at a router coordinate:
    if the current placement puts no gateway there, the broken router is
    unused and the spec compiles to a no-op — which is how re-placing
    gateways off dead routers heals the network.
    """
    if spec.position is not None:
        placement = normalize_placement(resolve_gateway_positions(cfg), cfg)
        target = (int(spec.position[0]), int(spec.position[1]))
        for s, p in enumerate(placement):
            if p == target:
                return s
        return None
    if not 0 <= spec.slot < cfg.max_gateways_per_chiplet:
        raise ValueError(
            f"{type(spec).__name__}.slot {spec.slot} out of range for "
            f"max_gateways_per_chiplet={cfg.max_gateways_per_chiplet}")
    return spec.slot


def _check_chiplet(spec, cfg: NetworkConfig) -> None:
    if not 0 <= spec.chiplet < cfg.n_chiplets:
        raise ValueError(f"{type(spec).__name__}.chiplet {spec.chiplet} out "
                         f"of range for n_chiplets={cfg.n_chiplets}")


@dataclasses.dataclass(frozen=True)
class GatewayFault(FaultSpec):
    """Hard gateway failure: the slot (or the gateway at `position`) is
    dead for the whole window — no traffic, no power, no capacity."""
    chiplet: int = 0
    slot: int = 0
    position: Optional[Tuple[int, int]] = None

    def apply(self, frame: dict, cfg: NetworkConfig, rng) -> None:
        _check_chiplet(self, cfg)
        s = _resolve_slot(self, cfg)
        if s is None:
            return
        w = self._window(frame["gw_ok"].shape[0])
        frame["gw_ok"][w, self.chiplet, s] = 0.0


@dataclasses.dataclass(frozen=True)
class LinkFlap(FaultSpec):
    """Transient interposer-link flaps: a 2-state Markov chain (up/down)
    over intervals. While down, every gateway slot of the chiplet is
    unusable (the chiplet's access waveguide is the shared cut).

    p_down: P(up -> down) per interval; p_up: P(down -> up). The chain is
    drawn at compile time from the frame's seed.
    """
    chiplet: int = 0
    p_down: float = 0.05
    p_up: float = 0.5

    def __post_init__(self):
        super().__post_init__()
        for name in ("p_down", "p_up"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"LinkFlap.{name} must be in [0, 1], "
                                 f"got {v}")

    def apply(self, frame: dict, cfg: NetworkConfig, rng) -> None:
        _check_chiplet(self, cfg)
        t = frame["gw_ok"].shape[0]
        w = self._window(t)
        up = True
        for i in range(t):
            if w[i]:
                if up and rng.rand() < self.p_down:
                    up = False
                elif not up and rng.rand() < self.p_up:
                    up = True
                if not up:
                    frame["gw_ok"][i, self.chiplet, :] = 0.0
            else:
                up = True     # the link is healthy outside the window


@dataclasses.dataclass(frozen=True)
class PcmStuckCell(FaultSpec):
    """PCM cell stuck in one crystallization state from `start` on.

    mode="off": the cell cannot couple — the lane is dead (as a hard
    gateway failure). mode="on": the cell cannot decouple — the lane burns
    power even when the controller gates it (power-only).
    """
    chiplet: int = 0
    slot: int = 0
    position: Optional[Tuple[int, int]] = None
    mode: str = "off"

    def __post_init__(self):
        super().__post_init__()
        if self.mode not in ("off", "on"):
            raise ValueError(f"PcmStuckCell.mode must be 'off' or 'on', "
                             f"got {self.mode!r}")

    def apply(self, frame: dict, cfg: NetworkConfig, rng) -> None:
        _check_chiplet(self, cfg)
        s = _resolve_slot(self, cfg)
        if s is None:
            return
        w = self._window(frame["gw_ok"].shape[0])
        if self.mode == "off":
            frame["gw_ok"][w, self.chiplet, s] = 0.0
        else:
            frame["stuck_on"][w, self.chiplet, s] = 1.0


@dataclasses.dataclass(frozen=True)
class LossDrift(FaultSpec):
    """Slow optical loss drift: `db_per_interval` extra dB accumulates per
    interval from `start`, clamped at `max_db` (laser aging / coupling
    drift). The laser manager compensates, so drift costs power."""
    db_per_interval: float = 0.01
    max_db: float = 3.0

    def __post_init__(self):
        super().__post_init__()
        if self.db_per_interval < 0 or self.max_db < 0:
            raise ValueError("LossDrift rates must be >= 0, got "
                             f"{self.db_per_interval}/{self.max_db}")

    def apply(self, frame: dict, cfg: NetworkConfig, rng) -> None:
        t = frame["drift_db"].shape[0]
        w = self._window(t)
        ramp = np.clip((np.arange(t) - self.start + 1)
                       * self.db_per_interval, 0.0, self.max_db)
        frame["drift_db"][w] += ramp[w]


# ---------------------------------------------------------------------------
# Compilation: specs -> dense time-varying frame
# ---------------------------------------------------------------------------

def no_faults(cfg: NetworkConfig, n_intervals: int) -> Dict[str, np.ndarray]:
    """The all-healthy frame (every slot usable, zero drift)."""
    c, g = cfg.n_chiplets, cfg.max_gateways_per_chiplet
    return {"gw_ok": np.ones((n_intervals, c, g), np.float32),
            "stuck_on": np.zeros((n_intervals, c, g), np.float32),
            "drift_db": np.zeros((n_intervals,), np.float32)}


def compile_faults(specs: Sequence[FaultSpec], cfg: NetworkConfig = NETWORK,
                   n_intervals: int = 64, *, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
    """Compile a list of FaultSpecs into one dense fault frame (numpy).

    Specs compose: `gw_ok` ANDs (any spec can kill a slot), `stuck_on` ORs,
    `drift_db` sums. Stochastic specs (LinkFlap) draw from `seed`
    deterministically, independent of list order (one numpy `RandomState`
    sub-stream per spec index, as the reference draws).
    """
    frame = no_faults(cfg, n_intervals)
    for i, spec in enumerate(specs):
        if not isinstance(spec, FaultSpec):
            raise TypeError(f"specs[{i}] is {type(spec).__name__}, expected "
                            f"a FaultSpec (GatewayFault / LinkFlap / "
                            f"PcmStuckCell / LossDrift)")
        spec.apply(frame, cfg, np.random.RandomState(seed * 9973 + i))
    return frame


def _device_of(trace: dict) -> torch.device:
    x = trace["ext_load"]
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def attach_faults(trace: dict, frame: Dict[str, np.ndarray]) -> dict:
    """Return `trace` with the fault frame riding in it (FAULT_KEYS, float32
    tensors on the trace's device).

    The frame's horizon must match the trace's T axis; after attachment
    the trace transforms slice/pad/concat the fault arrays along with the
    loads, so fault events stay aligned to chunk boundaries.
    """
    missing = [k for k in FAULT_KEYS if k not in frame]
    if missing:
        raise ValueError(f"fault frame is missing {missing} "
                         f"(build it with compile_faults/no_faults)")
    t = int(np.shape(trace["ext_load"])[0])
    tf = int(np.shape(frame["gw_ok"])[0])
    if t != tf:
        raise ValueError(f"fault frame covers {tf} intervals but the trace "
                         f"has {t} — compile the frame at the trace length")
    dev = _device_of(trace)
    return dict(trace, **{k: torch.as_tensor(frame[k], dtype=torch.float32,
                                             device=dev)
                          for k in FAULT_KEYS})


def strip_faults(trace: dict) -> dict:
    """The trace without its fault frame (fault-free baselines)."""
    return {k: v for k, v in trace.items() if k not in FAULT_KEYS}


def stack_fault_frames(frames: Sequence[dict]) -> Dict[str, torch.Tensor]:
    """Stack K frames along a new leading axis (the `sweep_faults` grid),
    as float32 tensors on the first frame's device (the CPU for numpy
    frames)."""
    if not frames:
        raise ValueError("stack_fault_frames() needs at least one frame")
    first = frames[0]["gw_ok"]
    dev = first.device if isinstance(first, torch.Tensor) \
        else torch.device("cpu")
    return {k: torch.stack([torch.as_tensor(f[k], dtype=torch.float32,
                                            device=dev) for f in frames])
            for k in FAULT_KEYS}


# ---------------------------------------------------------------------------
# Reconfiguration cost + the closed-loop fault environment
# ---------------------------------------------------------------------------

def placement_reconfig_cost(old_placement, new_placement,
                            power=PHOTONIC_POWER) -> dict:
    """PCM switching bill for a live re-placement: every gateway that moves
    re-programs its PCM coupler pair (`pcmc_reconfig_nj` each), and the
    re-placement stalls reconfiguration for one `pcmc_reconfig_cycles`
    window (cells re-program in parallel)."""
    old = set(tuple(map(int, p)) for p in (old_placement or ()))
    new = set(tuple(map(int, p)) for p in (new_placement or ()))
    moved = len(old - new) + len(new - old)
    return {"moved_gateways": moved,
            "pcm_nj": moved * power.pcmc_reconfig_nj,
            "stall_cycles": power.pcmc_reconfig_cycles if moved else 0}


class FaultInjector:
    """The closed-loop fault environment.

    Holds physical fault specs over a fixed horizon and, per chunk,
    compiles the frame the network experiences under its current placement
    — a position-targeted fault stops biting once the gateways move off the
    dead router. It also plays the hardware status register:
    `failed_positions(t)` is what a board-management controller would
    report.
    """

    def __init__(self, specs: Sequence[FaultSpec], horizon: int, *,
                 seed: int = 0, cache_size: int = 8):
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        if cache_size < 1:
            raise ValueError(f"cache_size must be >= 1, got {cache_size}")
        self.specs = tuple(specs)
        self.horizon = int(horizon)
        self.seed = int(seed)
        self.cache_size = int(cache_size)
        # Placement-keyed compiled frames, LRU-bounded: every heal is a new
        # placement key, so an unbounded dict would grow without end.
        self._frames: "collections.OrderedDict" = collections.OrderedDict()

    def frame_for(self, cfg: NetworkConfig, t0: int, t1: int) -> dict:
        """The fault frame for intervals [t0, t1) under `cfg`'s placement."""
        if not 0 <= t0 < t1 <= self.horizon:
            raise ValueError(f"window [{t0}, {t1}) outside horizon "
                             f"{self.horizon}")
        key = normalize_placement(resolve_gateway_positions(cfg), cfg)
        if key in self._frames:
            self._frames.move_to_end(key)
        else:
            self._frames[key] = compile_faults(self.specs, cfg, self.horizon,
                                               seed=self.seed)
            while len(self._frames) > self.cache_size:
                self._frames.popitem(last=False)
        full = self._frames[key]
        return {k: full[k][t0:t1] for k in FAULT_KEYS}

    def inject(self, chunk: dict, cfg: NetworkConfig, t0: int) -> dict:
        """Attach the chunk-aligned frame to a trace chunk starting at t0."""
        t = int(np.shape(chunk["ext_load"])[0])
        return attach_faults(chunk, self.frame_for(cfg, t0, t0 + t))

    def failed_positions(self, t: int) -> List[Tuple[int, int]]:
        """Router positions whose gateway hardware is dead at interval t
        (the status-register view: physical, placement-independent)."""
        out = []
        for spec in self.specs:
            pos = getattr(spec, "position", None)
            dead = isinstance(spec, GatewayFault) or (
                isinstance(spec, PcmStuckCell) and spec.mode == "off")
            if pos is None or not dead:
                continue
            hi = self.horizon if spec.end is None else spec.end
            if spec.start <= t < hi:
                out.append((int(pos[0]), int(pos[1])))
        return sorted(set(out))
