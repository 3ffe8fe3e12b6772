"""Fault tolerance & straggler mitigation for multi-pod runs (the port's own
copy of `repro.runtime.fault_tolerance`: pure host code).

Mechanisms (scaled for 1000+ nodes; exercised single-host in tests):

  * `Heartbeat` — per-step liveness watermarking. A step that exceeds
    `timeout_factor` x the EWMA step time marks the run DEGRADED; the
    launcher's supervisor (launch/train.py) checkpoints and exits nonzero
    so the cluster scheduler can reschedule (checkpoint/restart model).
  * `StepGuard` — NaN/inf loss + grad-norm spike detection with
    skip-and-continue (bounded by `max_skips`), the standard large-run
    guard against data poison and transient hardware SDC.
  * `StragglerMonitor` — epoch-level per-"gateway" (pod) step-time stats;
    persistent stragglers trigger a *lane reconfiguration* through the
    ReSiPI controller (reduce lanes crossing the slow pod) rather than a
    full restart — the paper's reconfiguration applied to failure handling.
  * `elastic.replan` — remap a saved (mesh-agnostic) checkpoint onto a
    smaller/larger mesh after node loss (restores a checkpoint onto the
    new mesh's placements).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Heartbeat:
    timeout_factor: float = 5.0
    ewma: float = 0.3
    _mean: Optional[float] = None
    degraded: bool = False

    def beat(self, step_seconds: float) -> bool:
        """Record one step; returns True if the run looks healthy."""
        if self._mean is None:
            self._mean = step_seconds
            return True
        if step_seconds > self.timeout_factor * self._mean:
            self.degraded = True
        self._mean = (1 - self.ewma) * self._mean + self.ewma * step_seconds
        return not self.degraded


@dataclasses.dataclass
class StepGuard:
    max_skips: int = 10
    grad_spike_factor: float = 50.0
    skips: int = 0
    _gnorm_ewma: Optional[float] = None

    def check(self, loss: float, grad_norm: float) -> bool:
        """True = apply the step; False = skip it (and count)."""
        bad = not np.isfinite(loss) or not np.isfinite(grad_norm)
        if self._gnorm_ewma is not None and grad_norm > \
                self.grad_spike_factor * self._gnorm_ewma:
            bad = True
        if not bad:
            g = max(grad_norm, 1e-12)
            self._gnorm_ewma = g if self._gnorm_ewma is None else \
                0.9 * self._gnorm_ewma + 0.1 * g
            return True
        self.skips += 1
        if self.skips > self.max_skips:
            raise RuntimeError(
                f"StepGuard: {self.skips} bad steps — aborting for restart")
        return False


@dataclasses.dataclass
class StragglerMonitor:
    """Per-pod step-time tracking; feeds the lane controller (Level 2).

    A pod whose epoch-mean step time exceeds `threshold` x the fleet median
    is flagged; the runtime responds by *narrowing lanes* that cross it
    (reconfiguration, cheap) and only escalates to checkpoint/restart if
    the pod stays slow for `escalate_after` epochs.
    """
    n_pods: int = 2
    threshold: float = 1.3
    escalate_after: int = 3
    _times: Optional[list] = None
    _slow_epochs: Optional[np.ndarray] = None

    def __post_init__(self):
        self._times = [[] for _ in range(self.n_pods)]
        self._slow_epochs = np.zeros(self.n_pods, np.int32)

    def record(self, pod: int, step_seconds: float):
        self._times[pod].append(step_seconds)

    def epoch_verdict(self) -> dict:
        means = np.array([np.mean(t) if t else 0.0 for t in self._times])
        self._times = [[] for _ in range(self.n_pods)]
        med = np.median(means[means > 0]) if (means > 0).any() else 0.0
        slow = (means > self.threshold * med) & (med > 0)
        self._slow_epochs = np.where(slow, self._slow_epochs + 1, 0)
        return {
            "pod_means": means,
            "slow_pods": np.nonzero(slow)[0].tolist(),
            "narrow_lanes_for": np.nonzero(slow)[0].tolist(),
            "escalate": np.nonzero(
                self._slow_epochs >= self.escalate_after)[0].tolist(),
        }
