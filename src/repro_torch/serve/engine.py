"""Overload-robust continuous-batching session server.

Port of `repro.serve.engine`. N concurrent `SimSession`-style streams
share ONE packed dispatch: each tick the server packs the next padded
chunk of every resident session into a `[lanes, chunk_intervals]` batch
on the host (numpy float32), copies it to the device once, and advances
all of them with a single `simulator.session_tick` (one `epoch_step`
launch on the card for RESIPI / RESIPI_ALL). The `t_mask` freeze
semantics make every irregularity exact — an empty lane, a session
backing off after a transient failure, or a final partial chunk all ride
along as masked rows that inject nothing, record zeros, and freeze their
carry. Destination-aware traces (a `dest` [C, C] matrix) serve too: each
tick packs the dest-carrying lanes as their own group with a per-lane
`dest` [B, C, C] batch (the dest path is all-or-nothing per launch, and
mixing would silently change dest-free lanes' numbers). Lane k of the
batched tick is bit-identical to a standalone `SimSession` stepping the
same chunks (pinned by `replay_standalone` and tests/test_torch_serve.py),
so sharing the launch costs nothing in fidelity.

After each launch the tick's per-lane sums cross to the host in one copy
(which also ends the dispatch's wall-clock window); every outcome decision
reads that copy, and per-lane records stay on the device unless
`ServerPolicy.keep_records` is set. Session totals fold in float32 on the
host, as a standalone session folds its own on the device.

Around that hot loop sits the robustness envelope, every decision a
`policies.ServerPolicy` knob:

  * bounded admission queue with backpressure — `submit` answers
    accept / throttle / shed by priority class, premium displaces queued
    batch work, a queued-interval budget bounds memory, and every
    refusal carries a taxonomy reason;
  * per-session deadlines — queued or mid-stream, an expired session
    terminates with a well-formed partial `summary()` (never a raise);
  * transient-failure retry — a failed lane step rolls its carry back
    (the tick leaves its input carry untouched), backs off
    exponentially, and terminates RETRY_EXHAUSTED past the retry budget;
  * idle eviction — an open stream that stops feeding frees its lane;
  * graceful degradation — sustained queue pressure (hysteresis band)
    switches the server to coalesced ticks: several same-shape dispatches
    back-to-back drain residents faster, and low-priority submissions
    shed at the door, instead of latency collapse;
  * closed-loop self-healing — a `resilience.DegradationDetector` on the
    per-tick mean latency plus `plan_replacement` (the device placement
    search) swap a blocked re-placement into EVERY lane at once (the
    selection tables are launch inputs), healthy sessions never drop;
  * a metrics/health surface — admit/shed/evict/retry counters, queue
    depth, p50/p99 dispatch wall latency, availability.

Fault frames live on HARDWARE time (tick index x chunk_intervals), shared
by every lane: all sessions experience the same interposer each tick.
The server runs on the card unless `device="cpu"`.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch.core.faults import attach_faults, placement_reconfig_cost
from repro_torch.core.gateway_controller import ControllerState
from repro_torch.core.selection import (normalize_placement,
                                        resolve_gateway_positions,
                                        selection_tables_torch)
from repro_torch.core.simulator import (SimConfig, SimSession, SimState,
                                        init_session_states, session_tick)
from repro_torch.serve import policies as P
from repro_torch.serve.policies import ServerPolicy
from repro_torch.serve.resilience import (DegradationDetector,
                                          ResiliencePolicy,
                                          plan_replacement)
from repro_torch.serve.scheduler import (SUM_KEYS, AdmissionQueue,
                                         ServeSession, SessionRequest)

_COUNTER_KEYS = (
    "submitted", "admitted", "completed", "shed_queue_full", "shed_memory",
    "shed_priority", "displaced", "deadline_expired", "idle_evicted",
    "retries", "retry_exhausted", "dispatches", "coalesced_dispatches",
    "served_chunks", "degraded_ticks", "heals")


def _map_state(fn, *states: SimState) -> SimState:
    """`fn` over the five tensors of one or more `SimState`s, field by
    field (the port's `jax.tree.map` over the carry)."""
    return SimState(
        ctl=ControllerState(
            g=fn(*(s.ctl.g for s in states)),
            packets_seen=fn(*(s.ctl.packets_seen for s in states)),
            epoch=fn(*(s.ctl.epoch for s in states))),
        wavelengths=fn(*(s.wavelengths for s in states)),
        prev_active=fn(*(s.prev_active for s in states)))


def where_lanes(keep: torch.Tensor, new: SimState, old: SimState
                ) -> SimState:
    """Per lane, `new`'s carry where `keep` [B] is true and `old`'s
    elsewhere (a failed lane's rollback); neither input is changed."""
    return _map_state(
        lambda n, o: torch.where(
            keep.reshape((keep.shape[0],) + (1,) * (n.dim() - 1)), n, o),
        new, old)


def set_lanes(states: SimState, lanes: torch.Tensor, fresh: SimState
              ) -> SimState:
    """`states` with rows `lanes` replaced by the one-lane `fresh` carry
    (admission); `states` itself is not changed."""
    n = int(lanes.shape[0])
    return _map_state(
        lambda b, f: b.index_copy(0, lanes, f.expand((n,) + f.shape[1:])),
        states, fresh)


class SessionServer:
    """Continuous-batching multi-session simulation server.

    ::

        server = SessionServer(sim, ServerPolicy(lanes=8), device="cpu")
        out = server.submit(SessionRequest(trace=tr))   # accept/throttle/shed
        server.run(ticks=32)                            # or tick() by hand
        server.drain()
        summaries = [s.summary() for s in server.completed]

    `fault_env` (a `faults.FaultInjector`) plays the hardware; pass a
    `ResiliencePolicy` as `resilience` to close the self-healing loop.
    `step_fault_hook(tick, session)` -> bool injects transient *server*
    step failures for the retry path (tests/benchmarks). `device=None`
    means the card.

    A tick's stages are the methods `_pack`, `_launch`, `_settle` and
    `_heal`; `chip_smoke.py` phase 9 wraps these four on a live server to
    time each stage and count its launches, so they keep their names.
    """

    def __init__(self, sim: SimConfig,
                 policy: ServerPolicy = ServerPolicy(), *,
                 fault_env=None,
                 resilience: Optional[ResiliencePolicy] = None,
                 step_fault_hook: Optional[
                     Callable[[int, ServeSession], bool]] = None,
                 device=None):
        self.sim = sim
        self.policy = policy
        self.device = backend.resolve_device(device)
        self.fault_env = fault_env
        self.step_fault_hook = step_fault_hook
        self.placement = normalize_placement(
            resolve_gateway_positions(sim.cfg), sim.cfg)
        self._tables = selection_tables_torch(sim.cfg, self.device)
        self._states = init_session_states(sim, policy.lanes,
                                           device=self.device)
        self._fresh = init_session_states(sim, 1, device=self.device)
        self._lanes: List[Optional[ServeSession]] = [None] * policy.lanes
        self.queue = AdmissionQueue(policy)
        self.sessions: Dict[str, ServeSession] = {}
        self.completed: List[ServeSession] = []
        self.terminated: List[ServeSession] = []   # non-completed endings
        self.tick_count = 0
        self.hw_intervals = 0        # hardware time consumed (fault frames)
        self.counters = Counter({k: 0 for k in _COUNTER_KEYS})
        self.events: List[dict] = []
        self.detector = DegradationDetector(resilience) \
            if resilience is not None else None
        self.resilience = resilience
        self.replacements = 0
        self.total_pcm_nj = 0.0
        self.total_stall_cycles = 0
        self._incumbent = None
        self._blocked: Tuple[Tuple[int, int], ...] = ()
        self._degraded = False
        self._over = 0
        self._under = 0
        self._dispatch_wall_s: List[float] = []
        self._in_band: List[bool] = []
        self._last_demand: Optional[dict] = None

    # ------------------------------------------------------------------ API
    @property
    def current_cfg(self):
        """NetworkConfig carrying the LIVE placement (what a
        placement-aware FaultInjector compiles frames against)."""
        return self.sim.cfg.with_placement(self.placement)

    @property
    def degraded(self) -> bool:
        return self._degraded

    @property
    def sessions_in_flight(self) -> int:
        return sum(s is not None for s in self._lanes)

    def submit(self, req) -> dict:
        """Admit a request (or bare trace dict): the backpressure door.

        Returns {signal, reason, session_id}: ACCEPT or THROTTLE means
        queued (throttle = "slow down"); SHED means refused, with the
        taxonomy reason, and the session object still yields a well-formed
        zero-served `summary()`.
        """
        if isinstance(req, dict):
            req = SessionRequest(trace=req)
        sess = ServeSession(req, self.policy, self.sim.cfg.n_chiplets,
                            self.tick_count)
        self.counters["submitted"] += 1
        self.sessions[sess.id] = sess
        if self._degraded and sess.priority < self.policy.degrade_min_priority:
            self._reject(sess, P.SHED_PRIORITY)
            return {"signal": P.SHED, "reason": P.SHED_PRIORITY,
                    "session_id": sess.id}
        signal, reason, displaced = self.queue.offer(sess)
        for victim, why in displaced:
            self._reject(victim, why)
            self.counters["displaced"] += 1
        if signal == P.SHED:
            self._reject(sess, reason)
        return {"signal": signal, "reason": reason, "session_id": sess.id}

    def feed(self, session_id: str, trace: dict) -> int:
        """Append intervals to an open (streaming) session."""
        return self._live(session_id).feed(trace)

    def close(self, session_id: str) -> None:
        """End an open session's input; it completes once drained."""
        self._live(session_id).closed = True

    def tick(self) -> dict:
        """One server tick: expire -> evict -> admit -> pack -> dispatch
        (coalesced when degraded) -> retry/complete -> heal. Never raises
        for per-session conditions — they terminate via the taxonomy."""
        now = self.tick_count
        self._expire_deadlines(now)
        self._complete_drained(now)
        self._evict_idle(now)
        admitted = self._admit(now)
        self._update_degraded()
        reps = self.policy.degrade_coalesce if self._degraded else 1
        served_lanes = 0
        lat_sum, valid_sum = 0.0, 0.0
        for rep in range(reps):
            # Ready lanes split into destination-free and destination-
            # carrying groups: `session_tick`'s dest path is all-or-nothing
            # per batch, and serving a dest-free lane through a uniform
            # matrix would silently change its numbers (replay parity).
            # Pure workloads still dispatch exactly once per tick.
            dispatched = 0
            for want_dest in (False, True):
                packed = self._pack(now, want_dest=want_dest)
                if packed is None:
                    continue
                dispatched += 1
                s_lat, s_valid, n = self._settle(
                    packed, self._launch(packed), now)
                lat_sum += s_lat
                valid_sum += s_valid
                served_lanes += n
            if dispatched == 0:
                break
            if rep > 0:
                self.counters["coalesced_dispatches"] += 1
        det = self._observe(lat_sum, valid_sum, served_lanes)
        self.tick_count += 1
        event = {"tick": now, "admitted": admitted,
                 "in_flight": self.sessions_in_flight,
                 "queue_depth": len(self.queue),
                 "degraded": self._degraded,
                 "served_lanes": served_lanes, **det}
        self.events.append(event)
        return event

    def run(self, ticks: int, arrivals: Optional[
            Callable[[int], Sequence[SessionRequest]]] = None) -> List[dict]:
        """Drive `ticks` ticks; `arrivals(tick)` submits before each."""
        out = []
        for _ in range(ticks):
            if arrivals is not None:
                for req in arrivals(self.tick_count):
                    self.submit(req)
            out.append(self.tick())
        return out

    def drain(self, max_ticks: int = 10_000) -> int:
        """Tick until no session is queued or resident; returns ticks used.

        Raises only if `max_ticks` elapses with work still pending (a
        liveness bug — with deadlines/retry bounds every session
        terminates in bounded time)."""
        for i in range(max_ticks):
            if not len(self.queue) and self.sessions_in_flight == 0:
                return i
            self.tick()
        raise RuntimeError(
            f"drain() did not converge in {max_ticks} ticks "
            f"({self.sessions_in_flight} resident, {len(self.queue)} queued)")

    def metrics(self) -> dict:
        """The monitoring surface: counters, queue, p50/p99 dispatch wall
        (launch + read-back, host clock), availability, heal bill."""
        wall = np.asarray(self._dispatch_wall_s)
        pct = (lambda q: float(np.percentile(wall, q))) if wall.size else \
            (lambda q: None)
        return {
            **{k: int(self.counters[k]) for k in _COUNTER_KEYS},
            "ticks": self.tick_count,
            "queue_depth": len(self.queue),
            "queued_intervals": self.queue.pending_intervals,
            "sessions_in_flight": self.sessions_in_flight,
            "degraded": self._degraded,
            "p50_chunk_s": pct(50),
            "p99_chunk_s": pct(99),
            "availability": float(np.mean(self._in_band))
            if self._in_band else None,
            "baseline_latency": None if self.detector is None
            else self.detector.baseline,
            "replacements": self.replacements,
            "total_pcm_nj": self.total_pcm_nj,
            "total_stall_cycles": self.total_stall_cycles,
        }

    def health(self) -> dict:
        """Coarse health verdict for load balancers / dashboards."""
        fill = len(self.queue) / max(self.policy.queue_capacity, 1)
        status = "degraded" if self._degraded else (
            "overloaded" if fill >= self.policy.degrade_hi else "ok")
        return {"status": status, "queue_fill": fill,
                "sessions_in_flight": self.sessions_in_flight,
                "degraded": self._degraded,
                "blocked_positions": list(self._blocked)}

    def swap_placement(self, positions) -> dict:
        """Operator-initiated live re-placement of EVERY lane at once
        (new selection tables, the same launch); returns the PCM bill."""
        new_p = normalize_placement(positions, self.sim.cfg)
        cost = placement_reconfig_cost(self.placement, new_p)
        self._tables = selection_tables_torch(
            self.sim.cfg.with_placement(new_p), self.device)
        self.placement = new_p
        self.total_pcm_nj += cost["pcm_nj"]
        self.total_stall_cycles += cost["stall_cycles"]
        return cost

    # ------------------------------------------------------------ internals
    def _live(self, session_id: str) -> ServeSession:
        sess = self.sessions.get(session_id)
        if sess is None or sess.terminal:
            raise KeyError(f"no live session {session_id!r}")
        return sess

    def _reject(self, sess: ServeSession, reason: str) -> None:
        sess.terminate(reason, self.tick_count)
        self.counters[reason] += 1
        self.terminated.append(sess)

    def _free_lane(self, sess: ServeSession, reason: str, now: int) -> None:
        lane = sess.lane
        sess.terminate(reason, now)
        if lane is not None:
            self._lanes[lane] = None
        if reason == P.COMPLETED:
            self.counters["completed"] += 1
            self.completed.append(sess)
        else:
            self.counters[reason] += 1
            self.terminated.append(sess)

    def _expire_deadlines(self, now: int) -> None:
        for victim in self.queue.remove_expired(now):
            victim.terminate(P.DEADLINE_EXPIRED, now)
            self.counters["deadline_expired"] += 1
            self.terminated.append(victim)
        for sess in list(self._lanes):
            if sess is not None and sess.deadline_tick is not None \
                    and now >= sess.deadline_tick:
                self._free_lane(sess, P.DEADLINE_EXPIRED, now)

    def _complete_drained(self, now: int) -> None:
        """A resident stream closed AFTER its last fed chunk was served
        completes here (the in-dispatch check only sees closes that
        precede the final chunk)."""
        for sess in list(self._lanes):
            if sess is not None and sess.closed and not sess.pending:
                self._free_lane(sess, P.COMPLETED, now)

    def _evict_idle(self, now: int) -> None:
        for sess in list(self._lanes):
            if sess is not None and not sess.pending and not sess.closed \
                    and now - sess.last_progress_tick \
                    >= self.policy.idle_evict_ticks:
                self._free_lane(sess, P.IDLE_EVICTED, now)

    def _admit(self, now: int) -> int:
        lanes = []
        for lane, occupant in enumerate(self._lanes):
            if occupant is not None:
                continue
            sess = self.queue.pop_next()
            if sess is None:
                break
            sess.lane = lane
            sess.status = "running"
            sess.admitted_tick = now
            sess.placement_at_admit = self.placement
            sess.last_progress_tick = now
            self._lanes[lane] = sess
            self.counters["admitted"] += 1
            lanes.append(lane)
        if lanes:
            # Fresh lane carries: each admitted row becomes a standalone
            # session's initial state, so the lane replays
            # `SimSession.init` exactly (one update for the tick's
            # admissions).
            self._states = set_lanes(
                self._states, torch.as_tensor(lanes, device=self.device),
                self._fresh)
        return len(lanes)

    def _update_degraded(self) -> None:
        p = self.policy
        fill = len(self.queue) / max(p.queue_capacity, 1)
        if fill >= p.degrade_hi:
            self._over += 1
            self._under = 0
        elif fill <= p.degrade_lo:
            self._under += 1
            self._over = 0
        else:
            self._over = 0
            self._under = 0
        if not self._degraded and self._over >= p.degrade_patience:
            self._degraded = True
        elif self._degraded and self._under >= p.degrade_patience:
            self._degraded = False
        if self._degraded:
            self.counters["degraded_ticks"] += 1

    def _pack(self, now: int, *, want_dest: bool = False) -> Optional[dict]:
        """Stack each ready lane's next padded chunk into the [B, T] batch
        on the host (idle lanes ride as all-masked rows); None if nothing
        to serve.

        `want_dest` selects the destination-carrying lane group: those
        batches add a per-lane `dest` [B, C, C] and route through the
        dest-aware launch. Non-member rows get a valid uniform matrix but
        are fully masked (zero injection, frozen carry), so the filler
        never contributes."""
        p = self.policy
        b, t, c = p.lanes, p.chunk_intervals, self.sim.cfg.n_chiplets
        ext = np.zeros((b, t, c), np.float32)
        mem = np.zeros((b, t), np.float32)
        intra = np.zeros((b, t, c), np.float32)
        frac = np.zeros((b,), np.float32)
        mask = np.zeros((b, t), np.float32)
        dmat = None
        if want_dest:
            uniform = np.full((c, c), 1.0 / max(c - 1, 1), np.float32)
            np.fill_diagonal(uniform, 0.0)
            dmat = np.broadcast_to(uniform, (b, c, c)).copy()
        ready = []
        for lane, sess in enumerate(self._lanes):
            if sess is None or not sess.ready(now):
                continue
            ch = sess.pending[0]
            if (ch.get("dest") is not None) != want_dest:
                continue
            ext[lane] = np.asarray(ch["ext_load"], np.float32)
            mem[lane] = np.asarray(ch["mem_load"], np.float32)
            intra[lane] = np.asarray(ch["int_load"], np.float32)
            frac[lane] = float(np.asarray(ch["ext_frac"]))
            mask[lane] = np.asarray(
                ch.get("t_mask", np.ones((t,), np.float32)), np.float32)
            if want_dest:
                dmat[lane] = np.asarray(ch["dest"], np.float32)
            ready.append(lane)
        if not ready:
            return None
        batch = {"ext_load": ext, "mem_load": mem, "int_load": intra,
                 "ext_frac": frac, "t_mask": mask}
        if want_dest:
            batch["dest"] = dmat
        return {"batch": batch, "ready": ready}

    def _tick_frame(self) -> Optional[dict]:
        """The shared hardware-time fault frame for this dispatch window
        (None once past the injector's horizon — storms are finite)."""
        if self.fault_env is None:
            return None
        t0, t1 = self.hw_intervals, \
            self.hw_intervals + self.policy.chunk_intervals
        if t1 > self.fault_env.horizon:
            return None
        self._blocked = tuple(self.fault_env.failed_positions(t0))
        return self.fault_env.frame_for(self.current_cfg, t0, t1)

    def _launch(self, packed: dict) -> dict:
        """One `session_tick` (the packed batch copied to the device, one
        launch) and the one read-back of its per-lane sums; the dispatch
        wall clock spans both."""
        frame = self._tick_frame()
        t0 = time.perf_counter()
        new_states, recs, sums = session_tick(
            self._states, packed["batch"], self._tables, self.sim,
            frame=frame)
        host = torch.stack([sums[k] for k in SUM_KEYS]).cpu().numpy()
        self._dispatch_wall_s.append(time.perf_counter() - t0)
        self.counters["dispatches"] += 1
        self.hw_intervals += self.policy.chunk_intervals
        return {"states": new_states, "records": recs, "frame": frame,
                "sums": dict(zip(SUM_KEYS, host))}

    def _settle(self, packed: dict, out: dict,
                now: int) -> Tuple[float, float, int]:
        """Per-lane outcomes of one launch from the host copy of its sums:
        fold, retry or complete each ready lane, then keep the new carry
        (rolling failed lanes back to the old one). Returns the (latency
        sum, valid-interval sum, lanes served) telemetry."""
        batch, ready = packed["batch"], packed["ready"]
        host_sums, recs = out["sums"], out["records"]
        keep = np.ones((self.policy.lanes,), bool)
        lat_sum, valid_sum, served = 0.0, 0.0, 0
        for lane in ready:
            sess = self._lanes[lane]
            lane_sums = {k: v[lane] for k, v in host_sums.items()}
            failed = not all(np.isfinite(v) for v in lane_sums.values())
            if self.step_fault_hook is not None \
                    and self.step_fault_hook(now, sess):
                failed = True
            if failed:
                keep[lane] = False           # roll this lane's carry back
                self.counters["retries"] += 1
                if not sess.fail(now, self.policy):
                    self._free_lane(sess, P.RETRY_EXHAUSTED, now)
                continue
            sess.advance(
                lane_sums, now, self.placement, out["frame"],
                records={k: v[lane] for k, v in recs.items()}
                if self.policy.keep_records else None,
                keep_records=self.policy.keep_records)
            self.counters["served_chunks"] += 1
            lat_sum += float(lane_sums["latency"])
            valid_sum += float(lane_sums["valid_intervals"])
            served += 1
            if sess.closed and not sess.pending:
                self._free_lane(sess, P.COMPLETED, now)
        if served:
            self._demand_sample(batch, ready)
        if keep.all():
            self._states = out["states"]
        else:
            self._states = where_lanes(
                torch.as_tensor(keep, device=self.device), out["states"],
                self._states)
        return lat_sum, valid_sum, served

    def _demand_sample(self, batch: dict, ready: List[int]) -> None:
        """Mean served-lane demand: the clean chunk re-placement candidates
        are scored on (lane chunks never carry fault keys — faults attach
        at the tick level, so no strip is needed)."""
        idx = np.asarray(ready)
        self._last_demand = {
            "ext_load": batch["ext_load"][idx].mean(axis=0),
            "mem_load": batch["mem_load"][idx].mean(axis=0),
            "int_load": batch["int_load"][idx].mean(axis=0),
            "ext_frac": float(batch["ext_frac"][idx].mean()),
            "t_mask": batch["t_mask"][idx].max(axis=0),
        }

    def _observe(self, lat_sum: float, valid_sum: float,
                 served_lanes: int) -> dict:
        """Feed the tick's mean latency to the detector; heal on fire."""
        if self.detector is None or served_lanes == 0 or valid_sum <= 0:
            return {"latency": None, "baseline": None, "breach": False,
                    "healed": None}
        det = self.detector.update(lat_sum / valid_sum)
        self._in_band.append(not det["breach"])
        healed = self._heal() \
            if det["fire"] and self._last_demand is not None else None
        return dict(det, healed=healed)

    def _heal(self) -> dict:
        """One live re-placement swapped into every lane (the server-wide
        analogue of ResilienceRuntime._heal): the device search, then the
        new placement's selection tables."""
        plan = plan_replacement(
            self._last_demand, self.sim, self.placement, self._blocked,
            self.resilience, incumbent=self._incumbent,
            seed_offset=self.replacements, device=self.device)
        self._tables = selection_tables_torch(
            self.sim.cfg.with_placement(plan["new_placement"]), self.device)
        self.placement = plan["new_placement"]
        self._incumbent = plan["incumbent_placement"]
        self.total_pcm_nj += plan["pcm_nj"]
        self.total_stall_cycles += plan["stall_cycles"]
        self.replacements += 1
        self.counters["heals"] += 1
        return {k: plan[k] for k in
                ("old_placement", "new_placement", "blocked_positions",
                 "search_best_score", "moved_gateways", "pcm_nj",
                 "stall_cycles")}


def replay_standalone(sim: SimConfig, sess: ServeSession, *,
                      device=None) -> dict:
    """Re-run a served session through a standalone `SimSession` on
    `device` (the card unless `device="cpu"`), bit-exactly: same chunks,
    same placements, same shared fault frames, in served order. Returns
    the standalone whole-stream summary — the check that continuous
    batching is free (compare against `sess.summary()`)."""
    if not sess.served_log:
        raise ValueError(f"session {sess.id} served nothing to replay")
    ref = SimSession.init(sim, device=device)
    if sess.placement_at_admit is not None \
            and tuple(sess.placement_at_admit) != tuple(ref.placement):
        ref.swap_placement(sess.placement_at_admit)
    for entry in sess.served_log:
        if tuple(entry["placement"]) != tuple(ref.placement):
            ref.swap_placement(entry["placement"])
        chunk = entry["chunk"]
        if entry["frame"] is not None:
            chunk = attach_faults(chunk, entry["frame"])
        ref.step_chunk(chunk)
    return ref.summary()
