"""Host-side bookkeeping for the continuous-batching session server.

Port of `repro.serve.scheduler`. Three small pieces, all host-side (the
engine owns the packed dispatch):

  * `SessionRequest` — what a client submits: a whole trace (closed
    session), or nothing yet (an open stream fed incrementally with
    `SessionServer.feed`), plus a priority class and an optional
    deadline.
  * `ServeSession` — one admitted-or-queued session's state machine:
    pending padded chunks (host numpy float32: the engine packs them on
    the host and copies each packed batch to the device once), the
    accumulated mask-correct sums (numpy float32 scalars, folded in
    float32 as a standalone `SimSession` folds its own, so the replay is
    exact), retry/backoff state, a served log (chunk + placement + fault
    frame per successful step) that lets `replay_standalone` re-run the
    session bit-exactly through a standalone `SimSession`, and a
    `summary()` that is well-formed at EVERY point of the lifecycle —
    including terminated mid-retry or expired before serving anything
    (valid-intervals-only reductions; zero served intervals means zero
    means, never a raise).
  * `AdmissionQueue` — the bounded priority queue with the backpressure
    and shedding policy: accept / throttle by depth, shed by capacity or
    queued-interval memory budget, premium displacement of queued lower
    classes.

Session ids come from one module-level counter ("s0", "s1", ...), as in
the reference.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.simulator import summary_from_sums
from repro_torch.core.traffic import chunk_trace, validate_trace
from repro_torch.serve.policies import (ACCEPT, PRIORITY_CLASSES,
                                        PRIORITY_STANDARD, SHED, SHED_MEMORY,
                                        SHED_QUEUE_FULL, TERMINAL_REASONS,
                                        THROTTLE, ServerPolicy)

_session_counter = itertools.count()

# The per-session totals (`simulator.session_sums_zero`'s keys).
SUM_KEYS = ("latency", "power_mw", "energy", "gateways", "wavelengths",
            "saturated", "reconfig_nj", "valid_intervals")


def sums_zero() -> Dict[str, np.float32]:
    """The additive identity of the per-session totals, as host float32
    scalars (0 + s is exact, so folding from zero equals a standalone
    session's first-chunk totals)."""
    return {k: np.float32(0.0) for k in SUM_KEYS}


def _host(v):
    """A trace value on the host: tensors as numpy arrays, the rest as
    given."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


@dataclasses.dataclass
class SessionRequest:
    """A client submission. `trace` None opens a stream (feed chunks later
    with `SessionServer.feed`, end it with `close`); a full trace closes
    the session at submit. `deadline_ticks` is relative to submission."""
    trace: Optional[dict] = None
    priority: int = PRIORITY_STANDARD
    deadline_ticks: Optional[int] = None
    session_id: Optional[str] = None

    def __post_init__(self):
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(f"priority must be one of {PRIORITY_CLASSES}, "
                             f"got {self.priority}")
        if self.deadline_ticks is not None and self.deadline_ticks < 1:
            raise ValueError(f"deadline_ticks must be >= 1, got "
                             f"{self.deadline_ticks}")


class ServeSession:
    """One session's host-side state; the engine drives the transitions.

    Lifecycle: queued -> running -> terminal, where terminal is exactly
    one reason from `policies.TERMINAL_REASONS`. `sums` accumulates the
    same mask-correct sufficient statistics a standalone `SimSession`
    carries, starting from the additive identity, so `summary()` is
    always well-formed — mid-retry, expired in the queue, or complete.
    """

    def __init__(self, req: SessionRequest, policy: ServerPolicy,
                 n_chiplets: int, now: int):
        self.id = req.session_id or f"s{next(_session_counter)}"
        self.priority = req.priority
        self.submitted_tick = now
        dl = req.deadline_ticks if req.deadline_ticks is not None \
            else policy.default_deadline_ticks
        self.deadline_tick = None if dl is None else now + dl
        self._chunk_t = policy.chunk_intervals
        self._n_chiplets = n_chiplets
        self.pending: List[dict] = []
        self.closed = False
        if req.trace is not None:
            self.feed(req.trace)
            self.closed = True
        # engine-owned state
        self.lane: Optional[int] = None
        self.status = "queued"
        self.termination_reason: Optional[str] = None
        self.placement_at_admit = None
        self.admitted_tick: Optional[int] = None
        self.terminated_tick: Optional[int] = None
        self.sums: Dict[str, np.float32] = sums_zero()
        self.retries = 0
        self.backoff_until = now
        self.last_progress_tick = now
        self.served_log: List[dict] = []
        self.records: List[dict] = []

    # -- input side ---------------------------------------------------------
    def feed(self, trace: dict) -> int:
        """Append a trace's intervals as padded fixed-T chunks; returns the
        number of chunks enqueued. A trace given as device tensors is
        brought to the host once, here."""
        if self.closed:
            raise ValueError(f"session {self.id} is closed to new input")
        if isinstance(trace, dict):
            trace = {k: _host(v) for k, v in trace.items()}
        validate_trace(trace, who=f"session {self.id} trace")
        if trace.get("dest") is not None and np.ndim(trace["dest"]) != 2:
            # Lanes carry ONE [C, C] matrix each; a stacked [K, C, C]
            # batch is a sweep input, not a session.
            raise ValueError(
                f"session {self.id} trace carries a batched destination "
                f"matrix of shape {np.shape(trace['dest'])} — "
                f"a served session needs a single [C, C] matrix")
        c = int(np.shape(trace["ext_load"])[-1])
        if c != self._n_chiplets:
            raise ValueError(
                f"session {self.id} trace has {c} chiplets, the server "
                f"simulates {self._n_chiplets}")
        n = 0
        for ch in chunk_trace(trace, self._chunk_t, pad=True):
            self.pending.append({k: _host(v) for k, v in ch.items()})
            n += 1
        return n

    @property
    def pending_intervals(self) -> int:
        """Un-served valid intervals still queued on this session."""
        return sum(int(np.sum(np.asarray(ch["t_mask"]) > 0))
                   for ch in self.pending)

    @property
    def served_intervals(self) -> int:
        return int(self.sums["valid_intervals"])

    # -- engine transitions -------------------------------------------------
    @property
    def terminal(self) -> bool:
        return self.termination_reason is not None

    def ready(self, now: int) -> bool:
        """Can this resident session dispatch a chunk this tick?"""
        return (not self.terminal and bool(self.pending)
                and now >= self.backoff_until)

    def advance(self, sums, now: int, placement, frame, records=None,
                keep_records: bool = False) -> None:
        """One chunk served successfully: fold its sums (host float32
        scalars) in float32, log the replay entry, reset the retry
        ladder."""
        chunk = self.pending.pop(0)
        self.sums = {k: np.float32(self.sums[k] + np.float32(sums[k]))
                     for k in self.sums}
        self.served_log.append(
            {"chunk": chunk, "placement": placement, "frame": frame})
        if keep_records and records is not None:
            self.records.append(records)
        self.retries = 0
        self.backoff_until = now
        self.last_progress_tick = now

    def fail(self, now: int, policy: ServerPolicy) -> bool:
        """One transient step failure: back off exponentially; returns True
        while retry budget remains (False = the engine must terminate the
        session with RETRY_EXHAUSTED)."""
        self.retries += 1
        if self.retries > policy.retry_limit:
            return False
        self.backoff_until = now + policy.retry_backoff_ticks \
            * 2 ** (self.retries - 1)
        return True

    def terminate(self, reason: str, now: int) -> None:
        if reason not in TERMINAL_REASONS:
            raise ValueError(f"unknown termination reason {reason!r} "
                             f"(taxonomy: {TERMINAL_REASONS})")
        self.termination_reason = reason
        self.status = reason
        self.terminated_tick = now
        self.lane = None

    # -- output side --------------------------------------------------------
    def summary(self) -> dict:
        """Whole-session summary, well-formed at any lifecycle point.

        Valid-intervals-only reductions over whatever was actually served
        (zero served intervals -> zero means), plus the lifecycle
        metadata a client needs to interpret a partial result. The means
        are float32 divisions of the float32 totals, as a standalone
        `SimSession.summary()` takes them.
        """
        out = summary_from_sums(
            {k: torch.as_tensor(v) for k, v in self.sums.items()},
            self._n_chiplets)
        out = {k: float(v) for k, v in out.items()}
        out.update({
            "session_id": self.id,
            "priority": self.priority,
            "status": self.status,
            "termination_reason": self.termination_reason,
            "served_intervals": self.served_intervals,
            "pending_intervals": self.pending_intervals,
            "served_chunks": len(self.served_log),
            "retries": self.retries,
            "submitted_tick": self.submitted_tick,
            "admitted_tick": self.admitted_tick,
            "terminated_tick": self.terminated_tick,
            "deadline_tick": self.deadline_tick,
        })
        return out


class AdmissionQueue:
    """Bounded priority admission queue with the shedding policy.

    Ordering is (priority desc, arrival order) — premium ahead of
    standard ahead of batch, FIFO within a class. `offer` implements the
    full admission decision except the degraded-mode class gate (the
    engine owns mode state): capacity shed with premium displacement,
    queued-interval memory budget, throttle-by-depth backpressure.
    """

    def __init__(self, policy: ServerPolicy):
        self.policy = policy
        self._items: List[Tuple[int, int, ServeSession]] = []
        self._arrival = itertools.count()

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return (s for _, _, s in self._items)

    @property
    def pending_intervals(self) -> int:
        return sum(s.pending_intervals for s in self)

    def _push(self, sess: ServeSession) -> None:
        self._items.append((-sess.priority, next(self._arrival), sess))
        self._items.sort(key=lambda t: t[:2])

    def _shed_lowest(self, below_priority: int) -> Optional[ServeSession]:
        """Remove the lowest-priority, youngest queued session strictly
        below `below_priority` (displacement victim), or None."""
        for i in range(len(self._items) - 1, -1, -1):
            if self._items[i][2].priority < below_priority:
                return self._items.pop(i)[2]
        return None

    def offer(self, sess: ServeSession) -> Tuple[str, str, List[
            Tuple[ServeSession, str]]]:
        """Admission decision for one submission.

        Returns (signal, reason, displaced): signal in ADMISSION_SIGNALS;
        reason is "" for accept/throttle or a REJECT_REASONS entry for
        shed; displaced lists (queued session pushed out, shed reason)
        pairs — the engine terminates each with its reason.
        """
        p = self.policy
        displaced: List[Tuple[ServeSession, str]] = []

        if len(self._items) >= p.queue_capacity:
            victim = self._shed_lowest(sess.priority)
            if victim is None:
                return SHED, SHED_QUEUE_FULL, []
            displaced.append((victim, SHED_QUEUE_FULL))

        if p.max_queued_intervals is not None:
            need = sess.pending_intervals
            while self.pending_intervals + need > p.max_queued_intervals:
                victim = self._shed_lowest(sess.priority)
                if victim is None:
                    for v, _ in displaced:    # undo the capacity eviction
                        self._push(v)
                    return SHED, SHED_MEMORY, []
                displaced.append((victim, SHED_MEMORY))

        self._push(sess)
        signal = THROTTLE if len(self._items) > p.effective_throttle_depth \
            else ACCEPT
        return signal, "", displaced

    def pop_next(self) -> Optional[ServeSession]:
        """Highest-priority, oldest queued session (None if empty)."""
        return self._items.pop(0)[2] if self._items else None

    def remove_expired(self, now: int) -> List[ServeSession]:
        """Extract every queued session whose deadline has passed."""
        out = [s for _, _, s in self._items
               if s.deadline_tick is not None and now >= s.deadline_tick]
        if out:
            dead = set(id(s) for s in out)
            self._items = [it for it in self._items
                           if id(it[2]) not in dead]
        return out
