"""The port's session server (`repro_torch.serve`: policies, scheduler,
engine) against the JAX reference on the CPU.

Each scenario of the reference's `tests/test_serve.py` runs through both
packages on the same inputs (traces the reference's generator draws, as
numpy, fed to both servers; the same session ids where a hook keys on
them) and the two transcripts must agree: every submit signal and reason,
every counter of `metrics()` but the wall-clock percentiles, every tick
event (latencies and baselines at rtol 1e-6, heal placements, moved
gateways, PCM nJ and stall cycles exact), and per session, in submission
order, its termination reason, lifecycle ticks and counts exactly, its
summary means at rtol 1e-6 and `valid_intervals` exactly. Inside the port,
every completed session's `replay_standalone` equals its `summary()` bit
for bit. Policy and request validation raise the reference's messages.
Sizes are small (1-3 lanes, chunks of 4-8, the Table-1 system); each
scenario runs once per worker (`functools.lru_cache`).
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                    # minimal containers
    from hypothesis_fallback import given, settings, strategies as st

from repro.core import faults as jfaults
from repro.core import simulator as jsim
from repro.core import traffic as jtr
from repro.serve import engine as jengine
from repro.serve import policies as jpol
from repro.serve import resilience as jres
from repro.serve import scheduler as jsched
from repro_torch import interop
from repro_torch.core import faults as tfaults
from repro_torch.core import simulator as tsim
from repro_torch.core import traffic as ttr
from repro_torch.serve import cases as tcases
from repro_torch.serve import engine as tengine
from repro_torch.serve import policies as tpol
from repro_torch.serve import resilience as tres
from repro_torch.serve import scheduler as tsched

RTOL = 1e-6
SUMMARY_FLOATS = ("mean_latency", "mean_power_mw", "mean_energy",
                  "mean_gateways", "mean_wavelengths", "saturated_frac",
                  "total_reconfig_nj")
REPLAY_KEYS = SUMMARY_FLOATS + ("valid_intervals",)
RECORD_KEYS = ("latency", "power_mw", "g", "energy", "wavelengths")


def _storm(sim):
    return dataclasses.replace(sim, ctl=type(sim.ctl)(
        l_m=sim.ctl.l_m, max_gateways=4, min_gateways=4))


JAX = SimpleNamespace(
    name="jax", Server=jengine.SessionServer, Policy=jpol.ServerPolicy,
    Request=jsched.SessionRequest, P=jpol, Res=jres.ResiliencePolicy,
    faults=jfaults, sim=jsim.SimConfig().with_arch(jsim.Arch.RESIPI),
    kw={}, replay=jengine.replay_standalone)
PORT = SimpleNamespace(
    name="port", Server=tengine.SessionServer, Policy=tpol.ServerPolicy,
    Request=tsched.SessionRequest, P=tpol, Res=tres.ResiliencePolicy,
    faults=tfaults, sim=tsim.SimConfig().with_arch(tsim.Arch.RESIPI),
    kw={"device": "cpu"},
    replay=lambda sim, s: tengine.replay_standalone(sim, s, device="cpu"))


@pytest.fixture(scope="module", autouse=True)
def _cold_reference_engine():
    """Leave the reference's jit caches as this module found them: a test
    file that runs after this one in the same worker may count the engine's
    fresh traces."""
    yield
    jsim.clear_engine_caches()


@functools.lru_cache(maxsize=None)
def _trace(seed: int, t: int, scale: float = 1.0, dest: bool = False):
    """dedup from the reference's generator, as numpy (a ring destination
    matrix with `dest`)."""
    tr = jtr.generate_trace("dedup", t, jax.random.PRNGKey(seed))
    out = {k: (v if k == "app" else np.array(v)) for k, v in tr.items()}
    for k in ("ext_load", "mem_load", "int_load"):
        out[k] = out[k] * np.float32(scale)
    if dest:
        out["dest"] = _ring_dest(out["ext_load"].shape[-1])
    return out


def _tr(seed, t, scale=1.0, dest=False) -> dict:
    return dict(_trace(seed, t, scale, dest))


def _ring_dest(c: int) -> np.ndarray:
    """Each chiplet sends everything to its ring neighbour."""
    d = np.zeros((c, c), np.float32)
    for i in range(c):
        d[i, (i + 1) % c] = 1.0
    return d


def _same(got, want, path="") -> None:
    """Recursive equality: floats at RTOL, everything else exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (bool, np.bool_)) or want is None \
            or isinstance(want, str):
        assert got == want, (path, got, want)
    elif isinstance(want, (int, np.integer)):
        assert got == want and not isinstance(got, float), (path, got, want)
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=RTOL, err_msg=path)


def _transcript(server, outs=()) -> dict:
    """What the two servers must agree on (ids left out: they come from a
    process-wide counter in each package)."""
    m = {k: v for k, v in server.metrics().items()
         if k not in ("p50_chunk_s", "p99_chunk_s")}
    sessions = []
    for sess in server.sessions.values():
        s = sess.summary()
        s.pop("session_id")
        s["valid_intervals"] = repr(s["valid_intervals"])    # exactly
        sessions.append(s)
    return {"outs": [{k: v for k, v in o.items() if k != "session_id"}
                     for o in outs],
            "metrics": m, "events": server.events, "sessions": sessions,
            "placement": tuple(server.placement),
            "health": server.health()}


def _replays_exact(server) -> int:
    """Every completed session's replay equals its summary bit for bit."""
    for sess in server.completed:
        ref = PORT.replay(server.sim, sess)
        mine = sess.summary()
        for k in REPLAY_KEYS:
            assert float(ref[k]) == mine[k], (sess.id, k)
    return len(server.completed)


# ---------------------------------------------------------------------------
# Scenarios: each takes a package side and returns (server, outs, extra)
# ---------------------------------------------------------------------------

def sc_churn(S):
    server = S.Server(S.sim, S.Policy(lanes=3, chunk_intervals=6,
                                      queue_capacity=10), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(i, 5 + 4 * i)))
            for i in range(4)]
    server.run(2)
    outs += [server.submit(S.Request(trace=_tr(i, 7))) for i in range(4, 7)]
    server.drain()
    return server, outs, {}


def sc_signals(S):
    server = S.Server(S.sim, S.Policy(lanes=1, chunk_intervals=4,
                                      queue_capacity=2, throttle_depth=1),
                      **S.kw)
    return server, [server.submit(S.Request(trace=_tr(i, 4)))
                    for i in range(3)], {}


def sc_premium(S):
    server = S.Server(S.sim, S.Policy(lanes=1, chunk_intervals=4,
                                      queue_capacity=2), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(i, 4),
                                    priority=S.P.PRIORITY_BATCH))
            for i in range(2)]
    outs.append(server.submit(S.Request(trace=_tr(9, 4),
                                        priority=S.P.PRIORITY_PREMIUM)))
    queued = [s.priority for s in server.queue]
    outs.append(server.submit(S.Request(trace=_tr(10, 4),
                                        priority=S.P.PRIORITY_BATCH)))
    return server, outs, {"queued": queued}


def sc_memory(S):
    server = S.Server(S.sim, S.Policy(lanes=1, chunk_intervals=4,
                                      queue_capacity=10,
                                      max_queued_intervals=8), **S.kw)
    return server, [server.submit(S.Request(trace=_tr(i, 8)))
                    for i in range(2)], {}


def sc_memory_displaces(S):
    # Premium work displaces queued batch sessions until the interval
    # budget fits; an equal class cannot, and the capacity eviction is
    # undone when the budget still does not fit.
    server = S.Server(S.sim, S.Policy(lanes=1, chunk_intervals=4,
                                      queue_capacity=3,
                                      max_queued_intervals=12), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(i, 4),
                                    priority=S.P.PRIORITY_BATCH))
            for i in range(3)]
    outs.append(server.submit(S.Request(trace=_tr(5, 8),
                                        priority=S.P.PRIORITY_PREMIUM)))
    outs.append(server.submit(S.Request(trace=_tr(6, 12),
                                        priority=S.P.PRIORITY_STANDARD)))
    server.drain()
    return server, outs, {}


def sc_deadline(S):
    server = S.Server(S.sim, S.Policy(lanes=1, chunk_intervals=4,
                                      queue_capacity=8), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(i, 16), deadline_ticks=2))
            for i in range(3)]
    server.run(4)
    return server, outs, {}


def sc_retry(S):
    fails = {"s_flaky": 2}

    def hook(tick, sess):
        if fails.get(sess.id, 0) > 0:
            fails[sess.id] -= 1
            return True
        return False

    server = S.Server(S.sim, S.Policy(lanes=2, chunk_intervals=4,
                                      queue_capacity=4, retry_limit=3),
                      step_fault_hook=hook, **S.kw)
    outs = [server.submit(S.Request(trace=_tr(0, 8), session_id="s_flaky")),
            server.submit(S.Request(trace=_tr(1, 8), session_id="s_ok"))]
    server.drain()
    return server, outs, {}


def sc_exhaust(S):
    def hook(tick, sess):
        return sess.id == "s_dead" and len(sess.served_log) >= 1

    server = S.Server(S.sim, S.Policy(lanes=2, chunk_intervals=4,
                                      queue_capacity=4, retry_limit=2,
                                      retry_backoff_ticks=1),
                      step_fault_hook=hook, **S.kw)
    outs = [server.submit(S.Request(trace=_tr(0, 12), session_id="s_dead")),
            server.submit(S.Request(trace=_tr(1, 12), session_id="s_ok"))]
    server.drain()
    return server, outs, {}


def sc_backoff(S):
    attempts = []

    def hook(tick, sess):
        attempts.append(tick)
        return True

    server = S.Server(S.sim, S.Policy(lanes=1, chunk_intervals=4,
                                      queue_capacity=2, retry_limit=3,
                                      retry_backoff_ticks=2),
                      step_fault_hook=hook, **S.kw)
    outs = [server.submit(S.Request(trace=_tr(0, 4)))]
    server.run(16)
    return server, outs, {"attempts": attempts}


def sc_stream(S):
    server = S.Server(S.sim, S.Policy(lanes=2, chunk_intervals=4,
                                      queue_capacity=4, idle_evict_ticks=3),
                      **S.kw)
    outs = [server.submit(S.Request(session_id="a")),
            server.submit(S.Request(session_id="b"))]
    fed = [server.feed("a", _tr(0, 8)), server.feed("b", _tr(1, 4))]
    server.run(2)
    server.close("a")
    server.run(6)
    return server, outs, {"fed": fed}


def sc_degraded(S):
    server = S.Server(S.sim, S.Policy(
        lanes=2, chunk_intervals=4, queue_capacity=4, degrade_hi=0.5,
        degrade_lo=0.25, degrade_patience=2, degrade_coalesce=3,
        degrade_min_priority=S.P.PRIORITY_STANDARD), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(i, 12))) for i in range(6)]
    server.run(2)
    seen = [server.degraded]
    outs.append(server.submit(S.Request(trace=_tr(9, 4),
                                        priority=S.P.PRIORITY_BATCH)))
    before = server.metrics()["coalesced_dispatches"]
    server.tick()
    seen.append(server.metrics()["coalesced_dispatches"] - before)
    server.drain()
    server.run(4)
    seen.append(server.degraded)
    return server, outs, {"seen": seen}


def sc_storm(S):
    sim = _storm(S.sim)
    policy = S.Policy(lanes=2, chunk_intervals=8, queue_capacity=4)
    victims = S.Server(sim, policy, **S.kw).placement[:2]
    env = S.faults.FaultInjector(
        [S.faults.GatewayFault(start=24, position=p) for p in victims],
        24 * 8)
    server = S.Server(sim, policy, fault_env=env, resilience=S.Res(
        threshold_frac=0.10, hysteresis=2, cooldown=1,
        search_generations=4, search_population=6), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(i, 64, scale=2.0)))
            for i in range(2)]
    server.drain()
    return server, outs, {"victims": tuple(victims)}


def sc_dest(S):
    server = S.Server(S.sim, S.Policy(lanes=2, chunk_intervals=4), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(0, 8, dest=True)))]
    server.drain()
    return server, outs, {}


def sc_plain_one_lane(S):
    server = S.Server(S.sim, S.Policy(lanes=1, chunk_intervals=4), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(0, 8)))]
    server.drain()
    return server, outs, {}


def sc_dest_one_lane(S):
    server = S.Server(S.sim, S.Policy(lanes=1, chunk_intervals=4), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(0, 8, dest=True)))]
    server.drain()
    return server, outs, {}


def sc_mixed(S):
    server = S.Server(S.sim, S.Policy(lanes=3, chunk_intervals=4), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(1, 8))),
            server.submit(S.Request(trace=_tr(2, 8, dest=True)))]
    server.drain()
    return server, outs, {}


def sc_plain_three_lanes(S):
    server = S.Server(S.sim, S.Policy(lanes=3, chunk_intervals=4), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(1, 8)))]
    server.drain()
    return server, outs, {}


def sc_swap(S):
    # An operator swap mid-serve, then a degraded stretch with a mixed
    # dest / plain population.
    server = S.Server(S.sim, S.Policy(lanes=2, chunk_intervals=4,
                                      queue_capacity=2, degrade_hi=0.5,
                                      degrade_patience=1), **S.kw)
    outs = [server.submit(S.Request(trace=_tr(i, 10, dest=i % 2 == 1)))
            for i in range(4)]
    server.run(1)
    cost = server.swap_placement(((1, 1), (2, 2), (1, 2), (2, 1)))
    outs.append(server.submit(S.Request(trace=_tr(7, 6))))
    server.drain()
    return server, outs, {"cost": cost}


@functools.lru_cache(maxsize=None)
def _dse_traces():
    """`serve.cases.dse_traces` at a small size, as numpy."""
    return [({k: (v if k == "app" else v.numpy()) for k, v in tr.items()}, p)
            for tr, p in tcases.dse_traces(16, "cpu", max_t=64)]


def sc_dse(S):
    # `serve.cases.dse_server` at 8 lanes: the 8 PARSEC apps at twice
    # their load, a quarter with destination matrices, routers under two
    # gateways dead from the 4th dispatch, the launcher's healer; 4
    # arrivals a tick until drained.
    sim = _storm(S.sim)
    policy = S.Policy(lanes=8, chunk_intervals=32, queue_capacity=16)
    victims = S.Server(sim, policy, **S.kw).placement[:2]
    env = S.faults.FaultInjector(
        [S.faults.GatewayFault(start=4 * 32, position=p) for p in victims],
        1 << 14)
    server = S.Server(sim, policy, fault_env=env, resilience=S.Res(
        threshold_frac=0.10, hysteresis=2, cooldown=1), **S.kw)
    traces, outs = _dse_traces(), []
    while traces or len(server.queue) or server.sessions_in_flight:
        outs += [server.submit(S.Request(trace=dict(tr), priority=p))
                 for tr, p in traces[:4]]
        traces = traces[4:]
        server.tick()
    return server, outs, {"victims": tuple(victims)}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_churn, sc_signals, sc_premium, sc_memory, sc_memory_displaces,
    sc_deadline, sc_retry, sc_exhaust, sc_backoff, sc_stream, sc_degraded,
    sc_storm, sc_dest, sc_plain_one_lane, sc_dest_one_lane, sc_mixed,
    sc_plain_three_lanes, sc_swap, sc_dse)}


@functools.lru_cache(maxsize=None)
def _run(name: str):
    """(reference transcript, port transcript, reference extra, port
    extra, port server) of one scenario."""
    fn = SCENARIOS[name]
    j_server, j_outs, j_extra = fn(JAX)
    t_server, t_outs, t_extra = fn(PORT)
    return (_transcript(j_server, j_outs), _transcript(t_server, t_outs),
            j_extra, t_extra, t_server)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_the_reference(name):
    """Signals, reasons, counters, events and every session's ending and
    summary equal the reference's; every completed session replays
    exactly inside the port."""
    want, got, j_extra, t_extra, server = _run(name)
    _same(got, want, name)
    _same(t_extra, j_extra, name + " extra")
    _replays_exact(server)


# ---------------------------------------------------------------------------
# What each scenario shows (the reference test's assertions, on the port)
# ---------------------------------------------------------------------------

def _port(name):
    return _run(name)[4], _run(name)[1], _run(name)[3]


def _well_formed(s: dict) -> None:
    assert s["termination_reason"] in tpol.TERMINAL_REASONS
    assert float(s["valid_intervals"]) == float(s["served_intervals"])
    for k in ("mean_latency", "mean_power_mw", "mean_energy"):
        assert np.isfinite(s[k])
        if s["served_intervals"] == 0:
            assert s[k] == 0.0


def test_churning_population_completes_and_replays():
    server, tr, _ = _port("churn")
    assert tr["metrics"]["completed"] == 7 and _replays_exact(server) == 7


def test_admission_signals_and_queue_full_shed():
    server, tr, _ = _port("signals")
    assert [o["signal"] for o in tr["outs"]] == [tpol.ACCEPT, tpol.THROTTLE,
                                                 tpol.SHED]
    assert tr["outs"][2]["reason"] == tpol.SHED_QUEUE_FULL
    _well_formed(tr["sessions"][2])
    assert tr["metrics"]["shed_queue_full"] == 1


def test_premium_displaces_queued_batch_work():
    _, tr, extra = _port("premium")
    assert tr["outs"][2]["signal"] in (tpol.ACCEPT, tpol.THROTTLE)
    assert tr["sessions"][1]["termination_reason"] == tpol.SHED_QUEUE_FULL
    assert tr["metrics"]["displaced"] == 1
    assert tpol.PRIORITY_PREMIUM in extra["queued"]
    assert tr["outs"][3]["signal"] == tpol.SHED


def test_memory_budget_sheds_by_queued_intervals():
    _, tr, _ = _port("memory")
    assert tr["outs"][0]["signal"] == tpol.ACCEPT
    assert tr["outs"][1] == {"signal": tpol.SHED,
                             "reason": tpol.SHED_MEMORY}
    _well_formed(tr["sessions"][1])


def test_deadline_expires_queued_and_running_sessions():
    _, tr, _ = _port("deadline")
    running, q1, q2 = tr["sessions"]
    assert running["termination_reason"] == tpol.DEADLINE_EXPIRED
    assert 0 < running["served_intervals"] < 16
    for s in (running, q1, q2):
        _well_formed(s)
    assert q1["served_intervals"] == q2["served_intervals"] == 0
    assert tr["metrics"]["deadline_expired"] == 3


def test_transient_failures_retry_then_bit_match():
    server, tr, _ = _port("retry")
    assert tr["metrics"]["retries"] == 2
    flaky = server.sessions["s_flaky"]
    assert flaky.termination_reason == tpol.COMPLETED
    assert flaky.served_intervals == 8 and _replays_exact(server) == 2


def test_retry_exhaustion_terminates_with_partial_summary():
    server, tr, _ = _port("exhaust")
    dead = server.sessions["s_dead"].summary()
    assert dead["termination_reason"] == tpol.RETRY_EXHAUSTED
    assert dead["served_intervals"] == 4
    _well_formed(dead)
    assert tr["metrics"]["retry_exhausted"] == 1


def test_exponential_backoff_parks_the_lane():
    _, tr, extra = _port("backoff")
    a = extra["attempts"]
    assert len(a) == 4 and [y - x for x, y in zip(a, a[1:])] == [2, 4, 8]
    assert tr["metrics"]["retry_exhausted"] == 1


def test_open_stream_feed_close_and_idle_eviction():
    server, tr, extra = _port("stream")
    assert extra["fed"] == [2, 1]
    assert server.sessions["a"].termination_reason == tpol.COMPLETED
    b = server.sessions["b"].summary()
    assert b["termination_reason"] == tpol.IDLE_EVICTED
    assert b["served_intervals"] == 4
    _well_formed(b)
    with pytest.raises(KeyError, match="no live session 'b'"):
        server.feed("b", _tr(1, 4))


def test_degraded_mode_enters_coalesces_sheds_and_exits():
    server, tr, extra = _port("degraded")
    entered, coalesced, still = extra["seen"]
    assert entered and coalesced > 0 and not still
    assert tr["outs"][6] == {"signal": tpol.SHED,
                             "reason": tpol.SHED_PRIORITY}
    m = tr["metrics"]
    assert m["degraded_ticks"] > 0 and m["shed_priority"] == 1
    assert m["completed"] == m["admitted"]


def test_fault_storm_heals_lanes_without_dropping_sessions():
    server, tr, extra = _port("storm")
    m = tr["metrics"]
    assert m["heals"] >= 1 and m["total_pcm_nj"] > 0.0
    assert not set(server.placement) & set(extra["victims"])
    assert len(server.completed) == 2
    assert all(s.served_intervals == 64 for s in server.completed)
    first = next(e["tick"] for e in server.events if e.get("healed"))
    assert any(not e["breach"] for e in server.events
               if e["tick"] > first and e.get("healed") is None)


def test_dest_sessions_complete_differ_and_leave_plain_lanes_alone():
    server, tr, _ = _port("dest")
    assert tr["sessions"][0]["status"] == "completed"
    plain = _port("plain_one_lane")[1]["sessions"][0]
    routed = _port("dest_one_lane")[1]["sessions"][0]
    assert any(plain[k] != routed[k] for k in REPLAY_KEYS)
    mixed = _port("mixed")[1]["sessions"]
    alone = _port("plain_three_lanes")[1]["sessions"][0]
    assert [s["status"] for s in mixed] == ["completed"] * 2
    for k in REPLAY_KEYS:
        assert mixed[0][k] == alone[k], k


def test_dse_size_server_heals_and_drains():
    """The phase-9 (c) server at 8 lanes: every session completes, the
    storm heals off the dead routers, plain and destination groups both
    dispatch."""
    server, tr, extra = _port("dse")
    m = tr["metrics"]
    assert m["completed"] == m["submitted"] == 16
    assert m["heals"] >= 1 and not set(server.placement) & set(
        extra["victims"])
    assert any("dest" in s.served_log[0]["chunk"] for s in server.completed)
    assert m["dispatches"] > m["ticks"]


def test_operator_swap_bills_and_replays():
    server, tr, extra = _port("swap")
    assert extra["cost"]["moved_gateways"] > 0
    assert tr["metrics"]["total_pcm_nj"] == extra["cost"]["pcm_nj"]
    assert tr["placement"] == ((1, 1), (2, 2), (1, 2), (2, 1))
    assert _replays_exact(server) == tr["metrics"]["completed"]


# ---------------------------------------------------------------------------
# Validation and the request / session surface
# ---------------------------------------------------------------------------

def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [
    {"lanes": 0}, {"chunk_intervals": 0}, {"retry_backoff_ticks": 0},
    {"throttle_depth": 99}, {"max_queued_intervals": 2},
    {"degrade_hi": 0.2, "degrade_lo": 0.8}, {"degrade_min_priority": 7},
    {"default_deadline_ticks": 0}, {"queue_capacity": -1},
    {"idle_evict_ticks": 0}, {"retry_limit": -1}, {"degrade_patience": 0},
    {"degrade_coalesce": 0}], ids=lambda kw: ",".join(kw))
def test_server_policy_rejects_bad_parameters(kw):
    assert _message(lambda: tpol.ServerPolicy(**kw)) \
        == _message(lambda: jpol.ServerPolicy(**kw))


@pytest.mark.parametrize("kw", [{"priority": 9}, {"deadline_ticks": 0}])
def test_session_request_rejects_bad_parameters(kw):
    assert _message(lambda: tsched.SessionRequest(**kw)) \
        == _message(lambda: jsched.SessionRequest(**kw))


def test_policy_vocabulary_is_the_reference_s():
    for name in ("ACCEPT", "THROTTLE", "SHED", "ADMISSION_SIGNALS",
                 "PRIORITY_CLASSES", "TERMINAL_REASONS", "REJECT_REASONS",
                 "COMPLETED", "DEADLINE_EXPIRED", "RETRY_EXHAUSTED",
                 "IDLE_EVICTED", "SHED_QUEUE_FULL", "SHED_MEMORY",
                 "SHED_PRIORITY"):
        assert getattr(tpol, name) == getattr(jpol, name), name
    assert dataclasses.asdict(tpol.ServerPolicy()) \
        == dataclasses.asdict(jpol.ServerPolicy())
    assert tpol.ServerPolicy(queue_capacity=9).effective_throttle_depth == 4


@pytest.mark.parametrize("bad", ["batched_dest", "chiplets", "closed"])
def test_session_feed_rejections_match_the_reference(bad):
    def attempt(S):
        server = S.Server(S.sim, S.Policy(lanes=1, chunk_intervals=4),
                          **S.kw)
        if bad == "batched_dest":
            tr = dict(_tr(0, 6), dest=np.stack([_ring_dest(4)] * 2))
            return _message(lambda: server.submit(S.Request(
                trace=tr, session_id="x")))
        if bad == "chiplets":
            tr = {k: (v[..., :3] if k in ("ext_load", "int_load") else v)
                  for k, v in _tr(0, 6).items()}
            return _message(lambda: server.submit(S.Request(
                trace=tr, session_id="x")))
        server.submit(S.Request(trace=_tr(0, 6), session_id="x"))
        return _message(lambda: server.sessions["x"].feed(_tr(1, 4)))

    got, want = attempt(PORT), attempt(JAX)
    assert got == want
    if bad == "batched_dest":
        assert "batched destination" in got


def test_session_sums_fold_in_float32_from_zero():
    server = _port("churn")[0]
    for sess in server.completed:
        assert all(type(v) is np.float32 for v in sess.sums.values())
    fresh = tsched.ServeSession(tsched.SessionRequest(), tpol.ServerPolicy(),
                                4, 0)
    s = fresh.summary()
    assert s["mean_latency"] == 0.0 and s["served_intervals"] == 0
    assert set(fresh.sums) == set(tsim.session_sums_zero(device="cpu"))


def test_device_trace_is_brought_to_the_host_at_feed():
    tr = interop.trace_from_numpy(_tr(3, 10), "cpu")
    sess = tsched.ServeSession(tsched.SessionRequest(trace=tr),
                               tpol.ServerPolicy(chunk_intervals=4), 4, 0)
    assert len(sess.pending) == 3 and sess.pending_intervals == 10
    for ch in sess.pending:
        assert all(not isinstance(v, torch.Tensor) for v in ch.values())
        assert ch["ext_load"].dtype == np.float32
        assert ch["t_mask"].shape == (4,)


def test_keep_records_are_the_standalone_records():
    sim = PORT.sim
    server = tengine.SessionServer(
        sim, tpol.ServerPolicy(lanes=2, chunk_intervals=4, keep_records=True),
        device="cpu")
    server.submit(tsched.SessionRequest(trace=_tr(4, 10)))
    server.submit(tsched.SessionRequest(trace=_tr(5, 6, dest=True)))
    server.drain()
    for sess in server.completed:
        ref = tsim.SimSession.init(sim, device="cpu")
        assert len(sess.records) == len(sess.served_log)
        for rec, entry in zip(sess.records, sess.served_log):
            want = ref.step_chunk(entry["chunk"])["records"]
            for k in RECORD_KEYS:
                assert torch.equal(rec[k], want[k]), k


def test_server_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.SessionServer(PORT.sim)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.replay_standalone(PORT.sim, _run("churn")[4].completed[0])


# ---------------------------------------------------------------------------
# The packed tick
# ---------------------------------------------------------------------------

def _batch(trs) -> dict:
    return {"ext_load": np.stack([t["ext_load"] for t in trs]),
            "mem_load": np.stack([t["mem_load"] for t in trs]),
            "int_load": np.stack([t["int_load"] for t in trs]),
            "ext_frac": np.stack([np.float32(t["ext_frac"]) for t in trs]),
            "t_mask": np.ones((len(trs), trs[0]["mem_load"].shape[0]),
                              np.float32)}


def _state_copy(s) -> list:
    return [x.clone() for x in (s.ctl.g, s.ctl.packets_seen, s.ctl.epoch,
                                s.wavelengths, s.prev_active)]


def _state_list(s) -> list:
    return [s.ctl.g, s.ctl.packets_seen, s.ctl.epoch, s.wavelengths,
            s.prev_active]


def test_batched_tick_bit_matches_standalone_sessions_and_the_reference():
    trs = [_tr(i, 6) for i in range(3)]
    batch = _batch(trs)
    states = tsim.init_session_states(PORT.sim, 3, device="cpu")
    tables = tsim.selection_tables_torch(PORT.sim.cfg, "cpu")
    _, recs, _ = tsim.session_tick(states, batch, tables, PORT.sim)
    _, jrecs, _ = jsim.session_tick(
        jsim.init_session_states(JAX.sim, 3), batch,
        jsim.selection_tables_jax(JAX.sim.cfg), JAX.sim)
    for i, tr in enumerate(trs):
        ref = tsim.SimSession.init(PORT.sim, device="cpu").step_chunk(tr)
        for k in RECORD_KEYS:
            assert torch.equal(ref["records"][k], recs[k][i]), k
            np.testing.assert_allclose(recs[k][i].numpy(),
                                       np.asarray(jrecs[k][i]), rtol=RTOL,
                                       atol=RTOL, err_msg=k)


def test_tick_leaves_its_input_states_and_masked_lane_untouched():
    tr = _tr(0, 5)
    batch = _batch([tr, tr])
    batch["t_mask"][0] = 0.0
    server = tengine.SessionServer(PORT.sim, tpol.ServerPolicy(lanes=2),
                                   device="cpu")
    states = tengine.set_lanes(server._states,
                               torch.tensor([1]), server._fresh)
    before = _state_copy(states)
    new, _, sums = tsim.session_tick(states, batch, server._tables,
                                     PORT.sim)
    for a, b in zip(before, _state_list(states)):
        assert torch.equal(a, b)                  # inputs untouched
    for a, b in zip(before, _state_list(new)):
        assert torch.equal(a[0], b[0])            # masked lane frozen
    assert all(float(v[0]) == 0.0 for v in sums.values())
    kept = tengine.where_lanes(torch.tensor([False, True]), new, states)
    for a, b, c in zip(_state_list(kept), _state_list(new), before):
        assert torch.equal(a[1], b[1]) and torch.equal(a[0], c[0])


# ---------------------------------------------------------------------------
# The walkthrough and the property test
# ---------------------------------------------------------------------------

def _reference_walkthrough():
    """The reference's `session_server_walkthrough` inputs through the
    reference server (examples/noc_reconfig_demo.py:300-346)."""
    sim = _storm(JAX.sim)
    policy = jpol.ServerPolicy(lanes=2, chunk_intervals=8, queue_capacity=3)
    victims = jengine.SessionServer(sim, policy).placement[:2]
    env = jfaults.FaultInjector(
        [jfaults.GatewayFault(start=32, position=p) for p in victims], 256)
    server = jengine.SessionServer(
        sim, policy, fault_env=env, resilience=jres.ResiliencePolicy(
            threshold_frac=0.10, hysteresis=2, cooldown=1,
            search_generations=4, search_population=6))
    outs = [server.submit(jsched.SessionRequest(trace=_tr(i, 64, 2.0)))
            for i in range(2)]
    server.run(1)
    outs += [server.submit(jsched.SessionRequest(trace=_tr(i, 64, 2.0)))
             for i in range(2, 4)]
    outs += [server.submit(jsched.SessionRequest(trace=_tr(s, 16, 2.0),
                                                 priority=p))
             for s, p in tcases.BURST]
    server.drain()
    return server, outs


def test_session_server_walkthrough_matches_the_reference():
    """`serve.cases.session_server` (the port's traces from twin keys)
    against the reference walkthrough: submits, heal at tick 4 (4
    gateways, 8 nJ), 5/5 completed with 3 shed and 1 displaced, every
    event and session; every completed session replays exactly."""
    j_server, j_outs = _reference_walkthrough()
    got = tcases.session_server("cpu")
    server = got["server"]
    assert got["submits"] == [(o["signal"], o["reason"]) for o in j_outs]
    _same(_transcript(server), _transcript(j_server), "walkthrough")
    heals = [e for e in server.events if e["healed"]]
    assert [(e["tick"], e["healed"]["moved_gateways"],
             e["healed"]["pcm_nj"]) for e in heals] == [(4, 4, 8.0)]
    m = server.metrics()
    assert (m["completed"], m["admitted"], m["shed_queue_full"]
            + m["shed_priority"], m["displaced"]) == (5, 5, 3, 1)
    assert _replays_exact(server) == 5


@settings(max_examples=8, deadline=None)
@given(st.integers(min_value=1, max_value=5),
       st.integers(min_value=0, max_value=3),
       st.integers(min_value=1, max_value=4),
       st.integers(min_value=0, max_value=6),
       st.integers(min_value=0, max_value=1 << 16))
def test_property_every_session_ends_well_formed(
        n_sessions, queue_capacity, deadline, fail_mod, seed):
    """Whatever the arrival mix, deadlines, queue bound and transient
    failure pattern: the loop never raises, every session ends with a
    taxonomy reason and a well-formed summary, and the port's transcript
    is the reference's (explicit ids, so the failure hook sees the same
    sessions in both)."""
    rng = np.random.default_rng(seed)
    reqs = [(f"p{i}", int(rng.integers(99)), int(rng.integers(1, 10)),
             int(rng.integers(3))) for i in range(n_sessions)]

    def hook(tick, sess):
        return fail_mod > 0 and (tick + int(sess.id[1:])) % (fail_mod + 2) \
            == 0

    def run(S):
        server = S.Server(S.sim, S.Policy(
            lanes=2, chunk_intervals=4, queue_capacity=queue_capacity,
            retry_limit=2, retry_backoff_ticks=1,
            default_deadline_ticks=deadline), step_fault_hook=hook, **S.kw)
        outs = [server.submit(S.Request(trace=_tr(s, t), priority=p,
                                        session_id=sid))
                for sid, s, t, p in reqs]
        server.drain()
        return server, outs

    t_server, t_outs = run(PORT)
    j_server, j_outs = run(JAX)
    assert t_server.sessions_in_flight == 0 and len(t_server.queue) == 0
    for sess in t_server.sessions.values():
        assert sess.terminal
        _well_formed(sess.summary())
    m = t_server.metrics()
    assert m["completed"] + m["deadline_expired"] + m["retry_exhausted"] \
        + m["shed_queue_full"] + m["shed_memory"] + m["shed_priority"] \
        == n_sessions
    _same(_transcript(t_server, t_outs), _transcript(j_server, j_outs))
    _replays_exact(t_server)


# ---------------------------------------------------------------------------
# SimSession.swap_placement under padded chunks (the port's own bits)
# ---------------------------------------------------------------------------

def test_swap_placement_between_padded_chunks_bit_matches_two_phase():
    """Swap mid-stream between two t_mask-padded chunks == the two-phase
    unpadded run, records and summary bit for bit (per-lane totals sum in
    a fixed pairwise order, so 16 intervals in one chunk total what two
    chunks of 8 do); the records equal the reference's at 1e-6."""
    tr = _tr(0, 20)
    alt = ((1, 1), (2, 2), (1, 2), (2, 1))
    padded = tsim.SimSession.init(PORT.sim, device="cpu")
    jpadded = jsim.SimSession.init(JAX.sim)
    recs, jrecs = [], []
    for i, ch in enumerate(ttr.chunk_trace(tr, 8, pad=True)):
        if i == 2:
            padded.swap_placement(alt)
            jpadded.swap_placement(alt)
        recs.append(padded.step_chunk(ch)["records"])
        jrecs.append(jpadded.step_chunk(
            {k: (v if k == "app" else np.asarray(v))
             for k, v in ch.items()})["records"])

    def phase(lo, hi):
        return {k: (v[lo:hi] if getattr(v, "ndim", 0) >= 1 else v)
                for k, v in tr.items()}

    ref = tsim.SimSession.init(PORT.sim, device="cpu")
    a = ref.step_chunk(phase(0, 16))["records"]
    ref.swap_placement(alt)
    b = ref.step_chunk(phase(16, 20))["records"]
    for k in RECORD_KEYS:
        got = torch.cat([r[k] for r in recs])[:20]
        assert torch.equal(got, torch.cat([a[k], b[k]])), k
        np.testing.assert_allclose(
            got.numpy(), np.concatenate([np.asarray(r[k])
                                         for r in jrecs])[:20],
            rtol=RTOL, atol=RTOL, err_msg=k)
    for k in REPLAY_KEYS:
        assert float(padded.summary()[k]) == float(ref.summary()[k]), k
    assert padded.intervals_seen == 20


def test_swap_placement_before_first_chunk_equals_fresh_session():
    tr = _tr(1, 12)
    alt = ((0, 0), (3, 3), (0, 3), (3, 0))
    swapped = tsim.SimSession.init(PORT.sim, device="cpu")
    swapped.swap_placement(alt)
    fresh = tsim.SimSession.init(dataclasses.replace(
        PORT.sim, cfg=PORT.sim.cfg.with_placement(alt)), device="cpu")
    a = swapped.step_chunk(tr)["records"]
    b = fresh.step_chunk(tr)["records"]
    for k in RECORD_KEYS:
        assert torch.equal(a[k], b[k]), k
