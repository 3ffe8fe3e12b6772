"""Closed-loop self-healing reconfiguration (the ReSiPI run-time story).

Port of `repro.serve.resilience`. `ResilienceRuntime` closes the loop:
`SimSession` streams telemetry per chunk, a threshold+hysteresis policy
detects degradation against an EWMA healthy-latency baseline, and a
detected fault triggers a *warm-restarted* device placement search
(`search_placement`, engine="device": one `epoch_step` launch a
generation on the card) seeded from the incumbent placement with the
failed routers — as reported by the hardware status register
(`faults.FaultInjector.failed_positions`) — masked out of the proposal
space. The recovered placement swaps in live (`SimSession.swap_placement`
rebuilds the selection tables, which reach the kernel as inputs) and
every re-placement is billed its physical PCM switching cost
(`faults.placement_reconfig_cost`).

The control loop is deliberately host-side and cheap: one float of
telemetry per chunk crosses the device boundary (the chunk summary the
session already returns), and the expensive reaction is the search.

The detection core (`DegradationDetector`) and the reaction core
(`plan_replacement`) are standalone so the continuous-batching
`SessionServer` (serve.engine) runs the same closed loop over its packed
lanes: one detector on the per-tick mean latency, one planned
re-placement swapped into every lane at once.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.faults import placement_reconfig_cost, strip_faults
from repro_torch.core.search import repair_placement
from repro_torch.core.simulator import SimSession, search_placement


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """When to declare degradation and how hard to search for a fix.

    A chunk breaches when its mean latency exceeds
    ``(1 + threshold_frac) x baseline``; `hysteresis` consecutive breaches
    trigger a re-placement (one noisy chunk never does); `cooldown` chunks
    must pass after a re-placement before the next one (the PCM cells are
    re-programming and the search needs fresh post-swap telemetry). The
    baseline is an EWMA over *healthy* chunks only, so it remembers the
    pre-fault level while the fault is biting — recovery is measured
    against what the network used to deliver, not against the degraded
    present.
    """
    threshold_frac: float = 0.15
    hysteresis: int = 2
    cooldown: int = 2
    baseline_ewma: float = 0.25
    search_generations: int = 8
    search_population: int = 8
    search_seed: int = 0

    def __post_init__(self):
        if not self.threshold_frac > 0:
            raise ValueError(f"threshold_frac must be > 0, got "
                             f"{self.threshold_frac}")
        if self.hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got "
                             f"{self.hysteresis}")
        if self.cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {self.cooldown}")
        if not 0 < self.baseline_ewma <= 1:
            raise ValueError(f"baseline_ewma must be in (0, 1], got "
                             f"{self.baseline_ewma}")


class DegradationDetector:
    """The detection half of the closed loop, as a reusable state machine.

    Feed it one latency sample per chunk/tick (`update`); it maintains the
    healthy-EWMA baseline (frozen while breaching, so recovery is judged
    against the pre-fault level), counts consecutive breaches against the
    hysteresis, and reports `fire=True` exactly when the caller should
    react — at which point the detector arms its own cooldown.

    The baseline moves on every in-band sample, the first sample of a
    storm included when it still lies inside the band; from the first
    breach on it holds the value it had after the last in-band sample.
    """

    def __init__(self, policy: ResiliencePolicy = ResiliencePolicy()):
        self.policy = policy
        self.baseline: Optional[float] = None
        self._breaches = 0
        self._cooldown = 0

    def in_band(self, latency: float) -> bool:
        """Is this sample within the acceptance band of the baseline?"""
        return self.baseline is None or \
            latency <= (1.0 + self.policy.threshold_frac) * self.baseline

    def update(self, latency: float) -> dict:
        """One telemetry sample -> {latency, baseline, breach, fire}."""
        p = self.policy
        lat = float(latency)
        if self.baseline is None:
            self.baseline = lat
        breach = lat > (1.0 + p.threshold_frac) * self.baseline
        if breach:
            self._breaches += 1
        else:
            self._breaches = 0
            self.baseline = ((1.0 - p.baseline_ewma) * self.baseline
                             + p.baseline_ewma * lat)
        fire = False
        if self._cooldown > 0:
            self._cooldown -= 1
        elif self._breaches >= p.hysteresis:
            fire = True
            self._breaches = 0
            self._cooldown = p.cooldown
        return {"latency": lat, "baseline": float(self.baseline),
                "breach": bool(breach), "fire": fire}


def plan_replacement(clean_chunk: dict, sim, current_placement,
                     blocked: Sequence[Tuple[int, int]],
                     policy: ResiliencePolicy, *,
                     incumbent=None, seed_offset: int = 0,
                     device=None) -> dict:
    """The reaction half: one warm-restarted blocked re-placement plan.

    Scores candidates on the CLEAN traffic model (the fault frame only
    constrains WHERE, via `blocked`), warm-restarts from `incumbent` (or
    the live placement) repaired off the dead routers, and returns the
    swap-ready plan with its physical PCM bill. The caller applies it
    (`SimSession.swap_placement` / `SessionServer` lane-wide swap) and
    accumulates the accounting. The search runs on `device` (the card
    unless `device="cpu"`).
    """
    old = current_placement
    start = incumbent if incumbent is not None else old
    init = repair_placement(start, tuple(blocked), sim.cfg)
    res = search_placement(
        clean_chunk, sim, engine="device",
        generations=policy.search_generations,
        population=policy.search_population,
        seed=policy.search_seed + seed_offset, init=init,
        blocked_positions=tuple(blocked), device=device)
    new_p = res["best_placement"]
    cost = placement_reconfig_cost(old, new_p)
    return {"old_placement": old, "new_placement": new_p,
            "incumbent_placement": res.get("incumbent_placement", new_p),
            "blocked_positions": tuple(blocked),
            "search_best_score": res["best_score"],
            "moved_gateways": cost["moved_gateways"],
            "pcm_nj": cost["pcm_nj"],
            "stall_cycles": cost["stall_cycles"]}


class ResilienceRuntime:
    """Watch a `SimSession`, heal it by re-placing gateways around faults.

    Usage (the closed loop)::

        runtime = ResilienceRuntime(SimSession.init(sim))
        for t0, chunk in enumerate_chunks(trace):
            faulted = injector.inject(chunk, runtime.current_cfg, t0)
            runtime.report_failed_positions(injector.failed_positions(t0))
            out = runtime.observe(faulted)
            if out["healed"]:
                ...  # placement moved; injector re-compiles vs new cfg

    The heal's search runs on the session's device. Accounting lives on
    the instance: `total_pcm_nj` / `total_stall_cycles` accumulate the
    physical re-placement bill, `events` records one dict per chunk
    (latency, baseline, breach, heal details) for the detection-latency /
    recovery-time metrics.
    """

    def __init__(self, session: SimSession,
                 policy: ResiliencePolicy = ResiliencePolicy()):
        self.session = session
        self.policy = policy
        self.detector = DegradationDetector(policy)
        self.events: List[dict] = []
        self.total_pcm_nj = 0.0
        self.total_stall_cycles = 0
        self.replacements = 0
        self._blocked: Tuple[Tuple[int, int], ...] = ()
        self._incumbent = None        # annealer state for warm restarts
        self._last_clean_chunk: Optional[dict] = None

    @property
    def baseline(self) -> Optional[float]:
        """Healthy-EWMA latency baseline (the detector's view)."""
        return self.detector.baseline

    @property
    def current_cfg(self):
        """NetworkConfig carrying the session's LIVE placement — what a
        placement-aware fault environment (FaultInjector.inject) should
        compile against, so position-targeted faults stop biting once the
        gateways have moved off the dead routers."""
        return self.session.sim.cfg.with_placement(self.session.placement)

    def report_failed_positions(
            self, positions: Sequence[Tuple[int, int]]) -> None:
        """Feed the hardware status register (FaultInjector.failed_positions
        or a real BMC): routers listed here are masked out of the next
        search's proposal space."""
        self._blocked = tuple(sorted(
            {(int(x), int(y)) for (x, y) in positions}))

    def observe(self, chunk: dict) -> dict:
        """Stream one chunk; detect degradation; heal when policy fires.

        Returns {records, summary, latency, baseline, breach, healed} —
        `healed` is None or the heal event dict (old/new placement, search
        result, PCM bill).
        """
        out = self.session.step_chunk(chunk)
        # Re-placement candidates are scored on the clean traffic model:
        # the search explores placements for the demand, the fault frame
        # only ever constrains WHERE via the blocked mask.
        self._last_clean_chunk = strip_faults(chunk)
        det = self.detector.update(float(out["summary"]["mean_latency"]))
        healed = self._heal() if det["fire"] else None
        event = {"latency": det["latency"], "baseline": det["baseline"],
                 "breach": det["breach"], "healed": healed}
        self.events.append(event)
        return dict(out, **event)

    def _heal(self) -> dict:
        """One live re-placement: warm-restarted blocked search + swap."""
        plan = plan_replacement(
            self._last_clean_chunk, self.session.sim,
            self.session.placement, self._blocked, self.policy,
            incumbent=self._incumbent, seed_offset=self.replacements,
            device=self.session.device)
        self.session.swap_placement(plan["new_placement"])
        self._incumbent = plan["incumbent_placement"]
        self.total_pcm_nj += plan["pcm_nj"]
        self.total_stall_cycles += plan["stall_cycles"]
        self.replacements += 1
        return {k: plan[k] for k in
                ("old_placement", "new_placement", "blocked_positions",
                 "search_best_score", "moved_gateways", "pcm_nj",
                 "stall_cycles")}
