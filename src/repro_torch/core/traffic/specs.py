"""First-class traffic specifications: the workload axis of the DSE space.

ReSiPI's contribution is *run-time traffic-driven* reconfiguration (§4), so
workload must be a first-class, sweepable axis just like topology (PR 2) and
gateway placement (PR 3). Every spec here is a frozen — hence hashable —
dataclass: it can key an lru_cache, and zip into a sweep grid.

Two spec families:

  * `ParsecSpec` — the calibrated PARSEC-like application traces the paper
    evaluates (§4.2/§4.5): slow phase oscillation + lognormal jitter, per-app
    parameters from `PARSEC` (blackscholes/facesim/dedup anchors).
  * canonical synthetic NoC workloads (the D3NOC / HexaMesh evaluation set):
    `UniformSpec` (uniform random), `HotspotSpec` (spatially concentrated),
    `PermutationSpec` (transpose / bit-complement / tornado / neighbor), and
    `BurstySpec` (Markov-modulated on/off sources).

All specs carry their own `n_intervals`, so a mixed-length workload set is
normal: the engine pads the time axis to the longest trace with a `t_mask`
(masked tail intervals provably contribute zero to every reduction).

Generation itself lives in `repro_torch.core.traffic.generators`.
(Port of `repro.core.traffic.specs`: a verbatim copy.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np

from repro_torch.core.constants import NetworkConfig


@dataclasses.dataclass(frozen=True)
class AppProfile:
    name: str
    mean_ext_load: float    # per-chiplet inter-chiplet pkts/cycle
    cv: float               # coefficient of variation across intervals
    phase_period: float     # intervals per application phase
    ext_frac: float         # share of traffic that is inter-chiplet
    mem_frac: float         # share of ext traffic destined to memory


# Anchors per the paper; the other apps interpolated by their known
# communication intensity ordering in PARSEC characterization literature.
PARSEC: Dict[str, AppProfile] = {
    "blackscholes": AppProfile("blackscholes", 0.044, 0.25, 20.0, 0.40, 0.30),
    "swaptions":    AppProfile("swaptions",    0.018, 0.30, 16.0, 0.30, 0.25),
    "streamcluster":AppProfile("streamcluster",0.034, 0.35, 12.0, 0.45, 0.35),
    "facesim":      AppProfile("facesim",      0.006, 0.20, 24.0, 0.25, 0.30),
    "fluidanimate": AppProfile("fluidanimate", 0.028, 0.40, 10.0, 0.35, 0.25),
    "bodytrack":    AppProfile("bodytrack",    0.022, 0.35, 14.0, 0.30, 0.30),
    "canneal":      AppProfile("canneal",      0.038, 0.30, 18.0, 0.50, 0.40),
    "dedup":        AppProfile("dedup",        0.024, 0.45,  8.0, 0.35, 0.30),
}

APP_NAMES = list(PARSEC)

PERMUTATION_PATTERNS = ("transpose", "bit_complement", "tornado", "neighbor")


class TrafficSpec:
    """Marker base class; concrete specs are frozen dataclasses.

    Subclasses must provide `n_intervals: int`, a `name` property (the trace
    label) and pass `_check_common` from their `__post_init__`.
    """

    n_intervals: int

    @property
    def name(self) -> str:  # pragma: no cover - overridden everywhere
        return type(self).__name__

    def _check_common(self) -> None:
        if self.n_intervals < 1:
            raise ValueError(f"{type(self).__name__}: n_intervals must be "
                             f">= 1, got {self.n_intervals}")
        # (field, lower bound, bound is strict, upper bound)
        for field, lo, strict, hi in (("mean_load", 0.0, True, None),
                                      ("cv", 0.0, False, None),
                                      ("ext_frac", 0.0, True, 1.0),
                                      ("mem_frac", 0.0, False, 1.0)):
            if not hasattr(self, field):
                continue
            v = getattr(self, field)
            bad = v is None or v != v or (v <= lo if strict else v < lo)
            if bad:
                raise ValueError(f"{type(self).__name__}.{field} must be "
                                 f"{'>' if strict else '>='} {lo}, got {v}")
            if hi is not None and v > hi:
                raise ValueError(f"{type(self).__name__}.{field} must be "
                                 f"<= {hi}, got {v}")


@dataclasses.dataclass(frozen=True)
class ParsecSpec(TrafficSpec):
    """A calibrated PARSEC-like application trace (the paper's workloads)."""

    app: str = "dedup"
    n_intervals: int = 64

    def __post_init__(self):
        if self.app not in PARSEC:
            raise ValueError(f"unknown PARSEC app {self.app!r} "
                             f"(known: {APP_NAMES})")
        self._check_common()

    @property
    def profile(self) -> AppProfile:
        return PARSEC[self.app]

    @property
    def name(self) -> str:
        return self.app


@dataclasses.dataclass(frozen=True)
class UniformSpec(TrafficSpec):
    """Uniform-random traffic: every chiplet offers the same mean ext load,
    with lognormal per-interval jitter (stationary — no application phases)."""

    mean_load: float = 0.02
    cv: float = 0.3
    ext_frac: float = 0.4
    mem_frac: float = 0.3
    n_intervals: int = 64

    def __post_init__(self):
        self._check_common()

    @property
    def name(self) -> str:
        return "uniform"


@dataclasses.dataclass(frozen=True)
class HotspotSpec(TrafficSpec):
    """Hotspot traffic: `n_hotspots` randomly drawn chiplets concentrate
    `hotspot_frac` of the total offered ext load (HexaMesh-style stressor
    for the gateway controller's per-chiplet activation)."""

    mean_load: float = 0.02
    hotspot_frac: float = 0.6    # share of total load on the hotspot set
    n_hotspots: int = 1
    cv: float = 0.3
    ext_frac: float = 0.5
    mem_frac: float = 0.3
    n_intervals: int = 64

    def __post_init__(self):
        self._check_common()
        if self.n_hotspots < 1:
            raise ValueError(f"HotspotSpec.n_hotspots must be >= 1, "
                             f"got {self.n_hotspots}")
        if not 0.0 < self.hotspot_frac < 1.0:
            raise ValueError(f"HotspotSpec.hotspot_frac must be in (0, 1), "
                             f"got {self.hotspot_frac}")

    @property
    def name(self) -> str:
        return f"hotspot{self.n_hotspots}"


@dataclasses.dataclass(frozen=True)
class PermutationSpec(TrafficSpec):
    """Deterministic permutation traffic at chiplet granularity.

    Each chiplet sends to a fixed partner chiplet:

      * ``transpose``      — (i, j) -> (j, i) on the near-square chiplet
        grid; diagonal chiplets are self-paired, so their would-be inter-
        chiplet load stays *intra*-chiplet (zero ext injection there).
      * ``bit_complement`` — i -> C-1-i (index complement; self-paired
        middle chiplet when C is odd).
      * ``tornado``        — i -> (i + C//2) mod C.
      * ``neighbor``       — i -> (i + 1) mod C.

    At the epoch level the simulator consumes per-chiplet *injected* loads,
    so the pattern manifests through which chiplets inject inter-chiplet
    traffic at all (self-pairs divert to `int_load`); spatial injection is
    otherwise uniform, as in the canonical synthetic definitions.
    """

    pattern: str = "transpose"
    mean_load: float = 0.02
    cv: float = 0.25
    ext_frac: float = 0.5
    mem_frac: float = 0.25
    n_intervals: int = 64

    def __post_init__(self):
        if self.pattern not in PERMUTATION_PATTERNS:
            raise ValueError(f"unknown permutation pattern "
                             f"{self.pattern!r} (known: "
                             f"{PERMUTATION_PATTERNS})")
        self._check_common()

    @property
    def name(self) -> str:
        return self.pattern


@dataclasses.dataclass(frozen=True)
class BurstySpec(TrafficSpec):
    """Markov-modulated on/off sources (bursty traffic, D3NOC-style).

    Every chiplet runs an independent two-state Markov chain over intervals:
    OFF -> ON with probability `p_on`, ON -> OFF with `p_off`. ON-state load
    is calibrated to `mean_load / duty` (duty = p_on / (p_on + p_off)), so
    the long-run mean ext load equals `mean_load` regardless of burstiness.
    """

    mean_load: float = 0.02
    p_on: float = 0.2
    p_off: float = 0.3
    cv: float = 0.2
    ext_frac: float = 0.45
    mem_frac: float = 0.3
    n_intervals: int = 64

    def __post_init__(self):
        self._check_common()
        for f in ("p_on", "p_off"):
            v = getattr(self, f)
            if not 0.0 < v <= 1.0:
                raise ValueError(f"BurstySpec.{f} must be in (0, 1], got {v}")

    @property
    def duty(self) -> float:
        return self.p_on / (self.p_on + self.p_off)

    @property
    def name(self) -> str:
        return "bursty"


SpecLike = Union[TrafficSpec, str]


def as_spec(spec: SpecLike, n_intervals: int = 64) -> TrafficSpec:
    """Coerce a spec-like value: a `TrafficSpec` passes through, a string is
    a PARSEC app name (`ParsecSpec(app, n_intervals)`)."""
    if isinstance(spec, TrafficSpec):
        return spec
    if isinstance(spec, str):
        return ParsecSpec(app=spec, n_intervals=n_intervals)
    raise TypeError(f"expected a TrafficSpec or PARSEC app name, got "
                    f"{type(spec).__name__}: {spec!r}")


def expected_mean_ext_load(spec: TrafficSpec,
                           cfg: NetworkConfig) -> float:
    """Analytic mean of `ext_load` for a spec (the calibration target).

    Used by the property tests: every generator's sample mean must land
    within sampling tolerance of this value.
    """
    if isinstance(spec, ParsecSpec):
        return spec.profile.mean_ext_load
    if isinstance(spec, PermutationSpec):
        n_self = int((permutation_destinations(spec.pattern, cfg.n_chiplets)
                      == np.arange(cfg.n_chiplets)).sum())
        return spec.mean_load * (cfg.n_chiplets - n_self) / cfg.n_chiplets
    return spec.mean_load


def permutation_destinations(pattern: str, n_chiplets: int) -> np.ndarray:
    """Destination chiplet index per source chiplet for a pattern ([C])."""
    c = n_chiplets
    i = np.arange(c)
    if pattern == "tornado":
        return (i + c // 2) % c
    if pattern == "neighbor":
        return (i + 1) % c
    if pattern == "bit_complement":
        return c - 1 - i
    if pattern == "transpose":
        side = int(round(c ** 0.5))
        if side * side == c:
            r, q = i // side, i % side
            return q * side + r
        # Non-square chiplet counts: index reversal is the closest analogue
        # (same self-pair structure as bit_complement).
        return c - 1 - i
    raise ValueError(f"unknown permutation pattern {pattern!r} "
                     f"(known: {PERMUTATION_PATTERNS})")


ALL_SYNTHETIC_SPECS: Tuple[TrafficSpec, ...] = (
    UniformSpec(),
    HotspotSpec(),
    PermutationSpec(pattern="transpose"),
    PermutationSpec(pattern="bit_complement"),
    PermutationSpec(pattern="tornado"),
    PermutationSpec(pattern="neighbor"),
    BurstySpec(),
)
