"""Serving policy: admission, deadlines, retry, and degradation knobs.

Port of `repro.serve.policies`, a verbatim copy (pure Python: the port
keeps its own copy rather than importing the JAX package). One frozen
dataclass (`ServerPolicy`) holds every robustness decision the
continuous-batching `SessionServer` makes, so a deployment is one value
and a test can pin exact behavior. The module also fixes the server's two
public vocabularies:

  * admission signals — what `submit()` tells the client (`ACCEPT` /
    `THROTTLE` / `SHED`): throttle is backpressure ("taken, but slow
    down"), shed is a refusal with a taxonomy reason.
  * the rejection/termination taxonomy — every session ends with exactly
    one reason string from `TERMINAL_REASONS`, and every refused
    submission carries one from `REJECT_REASONS`. Nothing ever just
    raises out of the serve loop (pinned by the property tests in
    tests/test_torch_serve.py).

Priority classes are small ints (higher = more important):
`PRIORITY_BATCH` (0) sheds first, `PRIORITY_PREMIUM` (2) sheds last and
may displace queued lower classes when the queue is full.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# --- admission signals (what submit() returns) -----------------------------
ACCEPT = "accept"
THROTTLE = "throttle"
SHED = "shed"
ADMISSION_SIGNALS = (ACCEPT, THROTTLE, SHED)

# --- priority classes ------------------------------------------------------
PRIORITY_BATCH = 0          # best-effort: first to shed, last to admit
PRIORITY_STANDARD = 1
PRIORITY_PREMIUM = 2        # may displace queued lower-priority sessions
PRIORITY_CLASSES = (PRIORITY_BATCH, PRIORITY_STANDARD, PRIORITY_PREMIUM)

# --- the rejection / termination taxonomy ----------------------------------
COMPLETED = "completed"                  # stream fully served and closed
DEADLINE_EXPIRED = "deadline_expired"    # queued or mid-stream past deadline
RETRY_EXHAUSTED = "retry_exhausted"      # transient failures > retry_limit
IDLE_EVICTED = "idle_evicted"            # open stream starved the lane
SHED_QUEUE_FULL = "shed_queue_full"      # bounded queue at capacity
SHED_MEMORY = "shed_memory"              # queued-interval budget exceeded
SHED_PRIORITY = "shed_priority"          # class refused in degraded mode

# Reasons a *session* (admitted, queued, or refused) can terminate with.
TERMINAL_REASONS = (COMPLETED, DEADLINE_EXPIRED, RETRY_EXHAUSTED,
                    IDLE_EVICTED, SHED_QUEUE_FULL, SHED_MEMORY,
                    SHED_PRIORITY)
# Reasons a *submission* can be refused with (shed signal).
REJECT_REASONS = (SHED_QUEUE_FULL, SHED_MEMORY, SHED_PRIORITY)


@dataclasses.dataclass(frozen=True)
class ServerPolicy:
    """Every robustness knob of the `SessionServer`, in one frozen value.

    Shape (fixed for the life of the server: every dispatch is one
    [lanes, chunk_intervals] batch, one `epoch_step` launch on the card):
      lanes            concurrent resident sessions B packed per tick.
      chunk_intervals  T intervals each lane advances per dispatch; every
                       session chunk is padded to this length (`t_mask`
                       freeze semantics make the padding exact).

    Admission (bounded queue + backpressure):
      queue_capacity   max queued sessions; beyond it submissions shed
                       (premium may displace a queued lower class).
      throttle_depth   queue depth at which accepted submissions are told
                       THROTTLE instead of ACCEPT (None = capacity // 2).
      max_queued_intervals  memory budget: total un-served intervals the
                       queue may hold; beyond it submissions shed with
                       SHED_MEMORY (None = unbounded by intervals).

    Deadlines / liveness:
      default_deadline_ticks  deadline for requests that set none, in
                       server ticks from submission (None = no deadline).
      idle_evict_ticks an open (streaming) session that has fed no chunk
                       for this many ticks is evicted from its lane.

    Retry (transient step failures):
      retry_limit          failed attempts per chunk before the session
                           terminates RETRY_EXHAUSTED.
      retry_backoff_ticks  base backoff; attempt k parks the lane for
                           base * 2**(k-1) ticks (exponential).

    Graceful degradation (sustained overload):
      degrade_hi / degrade_lo  queue-fill fractions with hysteresis:
                       `degrade_patience` consecutive ticks at or above
                       hi enters degraded mode, the same count at or
                       below lo exits.
      degrade_coalesce in degraded mode each tick dispatches this many
                       chunks back-to-back for resident sessions (same
                       shape, no admissions in between) — the server
                       drains residents faster instead of collapsing.
      degrade_min_priority  while degraded, submissions below this class
                       shed immediately with SHED_PRIORITY.

    keep_records: retain per-interval record arrays on each session
    (memory grows with served intervals — benchmarks/tests only).
    """
    lanes: int = 8
    chunk_intervals: int = 8
    queue_capacity: int = 16
    throttle_depth: Optional[int] = None
    max_queued_intervals: Optional[int] = None
    default_deadline_ticks: Optional[int] = None
    idle_evict_ticks: int = 4
    retry_limit: int = 3
    retry_backoff_ticks: int = 1
    degrade_hi: float = 0.75
    degrade_lo: float = 0.25
    degrade_patience: int = 2
    degrade_coalesce: int = 2
    degrade_min_priority: int = PRIORITY_STANDARD
    keep_records: bool = False

    def __post_init__(self):
        for name, lo in (("lanes", 1), ("chunk_intervals", 1),
                         ("queue_capacity", 0), ("idle_evict_ticks", 1),
                         ("retry_limit", 0), ("retry_backoff_ticks", 1),
                         ("degrade_patience", 1), ("degrade_coalesce", 1)):
            v = getattr(self, name)
            if v < lo:
                raise ValueError(f"ServerPolicy.{name} must be >= {lo}, "
                                 f"got {v}")
        if self.throttle_depth is not None \
                and not 0 <= self.throttle_depth <= self.queue_capacity:
            raise ValueError(
                f"ServerPolicy.throttle_depth must be in "
                f"[0, queue_capacity={self.queue_capacity}], got "
                f"{self.throttle_depth}")
        if self.max_queued_intervals is not None \
                and self.max_queued_intervals < self.chunk_intervals:
            raise ValueError(
                f"ServerPolicy.max_queued_intervals "
                f"({self.max_queued_intervals}) below one chunk "
                f"({self.chunk_intervals}) would shed every submission")
        if not 0.0 <= self.degrade_lo <= self.degrade_hi <= 1.0:
            raise ValueError(
                f"ServerPolicy degradation band needs "
                f"0 <= degrade_lo <= degrade_hi <= 1, got "
                f"lo={self.degrade_lo}, hi={self.degrade_hi}")
        if self.degrade_min_priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"ServerPolicy.degrade_min_priority must be one of "
                f"{PRIORITY_CLASSES}, got {self.degrade_min_priority}")
        if self.default_deadline_ticks is not None \
                and self.default_deadline_ticks < 1:
            raise ValueError(
                f"ServerPolicy.default_deadline_ticks must be >= 1, got "
                f"{self.default_deadline_ticks}")

    @property
    def effective_throttle_depth(self) -> int:
        return self.queue_capacity // 2 if self.throttle_depth is None \
            else self.throttle_depth
