"""The port's closed-loop self-healing (`repro_torch.serve.resilience`:
`ResiliencePolicy`, `DegradationDetector`, `plan_replacement`,
`ResilienceRuntime`) against the JAX reference on the CPU.

Each scenario of the reference's `tests/test_resilience.py` runs through
both packages on the same chunks (the reference's dedup trace at twice its
load, as numpy; the controller pinned at 4 gateways; routers under live
gateways dead from interval 32): the per-chunk (latency, baseline, breach)
sequence at rtol 1e-6, every heal decision exactly (chunk, old and new
placement, blocked routers, moved gateways, PCM nJ, stall cycles; the
search's best score at 1e-6) and the bill. The reference's
`test_baseline_freezes_during_breach` fails (ROADMAP R2): its storm's first
chunk is still inside the 10% band, so the EWMA moves once more before the
first breach. Here the port's detector is pinned on its real property: at
every breaching chunk the baseline is the one after the last in-band
chunk.
"""
import dataclasses
import functools
import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.core import faults as jfaults
from repro.core import search as jsearch
from repro.core import simulator as jsim
from repro.core import traffic as jtr
from repro.serve import resilience as jres
from repro_torch.core import faults as tfaults
from repro_torch.core import search as tsearch
from repro_torch.core import simulator as tsim
from repro_torch.core import traffic as ttr
from repro_torch.serve import cases as tcases
from repro_torch.serve import resilience as tres

RTOL = 1e-6
CHUNK, T_TOTAL, STORM_T0, LOAD_SCALE = 8, 64, 32, 2.0


def _storm(sim):
    return dataclasses.replace(sim, ctl=type(sim.ctl)(
        l_m=sim.ctl.l_m, max_gateways=4, min_gateways=4))


JAX = SimpleNamespace(
    sim=_storm(jsim.SimConfig().with_arch(jsim.Arch.RESIPI)),
    Session=lambda sim: jsim.SimSession.init(sim), Runtime=jres.
    ResilienceRuntime, Policy=jres.ResiliencePolicy, faults=jfaults,
    chunks=jtr.chunk_trace, plan=jres.plan_replacement, kw={})
PORT = SimpleNamespace(
    sim=_storm(tsim.SimConfig().with_arch(tsim.Arch.RESIPI)),
    Session=lambda sim: tsim.SimSession.init(sim, device="cpu"),
    Runtime=tres.ResilienceRuntime, Policy=tres.ResiliencePolicy,
    faults=tfaults, chunks=ttr.chunk_trace, plan=tres.plan_replacement,
    kw={"device": "cpu"})


@pytest.fixture(scope="module", autouse=True)
def _cold_reference_engine():
    """Leave the reference's jit caches as this module found them: a test
    file that runs after this one in the same worker may count the engine's
    fresh traces."""
    yield
    jsim.clear_engine_caches()


@functools.lru_cache(maxsize=None)
def _trace(seed: int = 0, t: int = T_TOTAL):
    tr = jtr.generate_trace("dedup", t, jax.random.PRNGKey(seed))
    out = {k: (v if k == "app" else np.array(v)) for k, v in tr.items()}
    for k in ("ext_load", "mem_load", "int_load"):
        out[k] = out[k] * np.float32(LOAD_SCALE)
    return out


def _storm_policy(S, **kw):
    base = dict(threshold_frac=0.10, hysteresis=2, cooldown=1,
                search_generations=4, search_population=6)
    return S.Policy(**dict(base, **kw))


def _loop(S, policy, specs_of, seed=0, t=T_TOTAL, report=True):
    """Stream the trace in chunks of 8 through a runtime under the faults
    `specs_of(victims)` returns; every observe's outcome, in order."""
    runtime = S.Runtime(S.Session(S.sim), policy)
    victims = tuple(runtime.session.placement)
    injector = S.faults.FaultInjector(specs_of(victims, S.faults), t)
    outs = []
    for i, ch in enumerate(S.chunks(dict(_trace(seed, t)), CHUNK)):
        t0 = i * CHUNK
        ch = {k: (v if k == "app" else np.asarray(v)) for k, v in ch.items()}
        faulted = injector.inject(ch, runtime.current_cfg, t0)
        if report:
            runtime.report_failed_positions(injector.failed_positions(t0))
        out = runtime.observe(faulted)
        outs.append({k: out[k] for k in ("latency", "baseline", "breach",
                                         "healed")})
    return runtime, victims, outs


def _storm_specs(n, start=STORM_T0, end=None):
    def specs(victims, faults):
        return [faults.GatewayFault(start=start, end=end, position=p)
                for p in victims[:n]]
    return specs


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (bool, str, int, np.integer)) or want is None:
        assert got == want and type(got) is not float, (path, got, want)
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   atol=RTOL, err_msg=path)


SCENARIOS = {
    # (policy kwargs or None for the default 15% band, specs, seed, t)
    "healthy": (None, lambda v, f: [], 0, T_TOTAL),
    "storm": ({}, _storm_specs(2), 0, T_TOTAL),
    "glitch": ({}, _storm_specs(2, 24, 24 + CHUNK), 1, 48),
    "cooldown": ({"threshold_frac": 0.01, "hysteresis": 1, "cooldown": 2},
                 _storm_specs(1), 0, T_TOTAL),
    "baseline_freeze": ({"hysteresis": 99}, _storm_specs(2), 0, T_TOTAL),
}


@functools.lru_cache(maxsize=None)
def _run(name):
    kw, specs, seed, t = SCENARIOS[name]
    res = {}
    for label, S in (("jax", JAX), ("port", PORT)):
        policy = S.Policy() if kw is None else _storm_policy(S, **kw)
        runtime, victims, outs = _loop(S, policy, specs, seed, t,
                                       report=name != "baseline_freeze")
        res[label] = {"runtime": runtime, "victims": victims, "outs": outs,
                      "bill": (runtime.total_pcm_nj,
                               runtime.total_stall_cycles,
                               runtime.replacements),
                      "placement": tuple(runtime.session.placement),
                      "events": runtime.events}
    return res


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_runtime_follows_the_reference(name):
    """Per chunk: latency, baseline and breach at 1e-6, every heal's
    placements, blocked routers and bill exactly; the final placement,
    the bill and the event log."""
    r = _run(name)
    for key in ("victims", "outs", "bill", "placement", "events"):
        _same(r["port"][key], r["jax"][key], f"{name}.{key}")


def test_healthy_stream_never_heals():
    rt = _run("healthy")["port"]["runtime"]
    assert all(o["healed"] is None for o in _run("healthy")["port"]["outs"])
    assert rt.replacements == 0 and rt.total_pcm_nj == 0.0
    assert rt.baseline is not None and rt.baseline > 0
    assert len(rt.events) == T_TOTAL // CHUNK


def test_fault_storm_detect_heal_recover_and_bill():
    r = _run("storm")["port"]
    rt, victims, outs = r["runtime"], r["victims"][:2], r["outs"]
    heal_chunk = next(i for i, o in enumerate(outs) if o["healed"])
    heal = outs[heal_chunk]["healed"]
    storm_chunk = STORM_T0 // CHUNK
    assert storm_chunk <= heal_chunk <= storm_chunk + 3
    assert heal["new_placement"] == rt.session.placement
    assert not set(rt.session.placement) & set(victims)
    assert set(heal["blocked_positions"]) == set(victims)
    assert heal["moved_gateways"] >= len(victims)
    assert rt.total_pcm_nj >= heal["pcm_nj"] > 0.0
    assert rt.total_stall_cycles >= 100
    prefault = outs[storm_chunk - 1]["baseline"]
    post = [o["latency"] for o in outs[heal_chunk + 1:]]
    assert post and np.mean(post) <= 1.10 * prefault


def test_one_chunk_glitch_is_absorbed_by_hysteresis():
    rt = _run("glitch")["port"]["runtime"]
    assert rt.replacements == 0 and rt.total_pcm_nj == 0.0


def test_cooldown_blocks_back_to_back_heals():
    outs = _run("cooldown")["port"]["outs"]
    heals = [i for i, o in enumerate(outs) if o["healed"]]
    assert heals
    for a, b in zip(heals, heals[1:]):
        assert b - a > 2, heals


def test_baseline_freezes_at_the_last_in_band_value_during_breach():
    """ROADMAP R2 on the port's terms: the reference test's scenario
    (threshold 0.10, hysteresis 99, storm at chunk 4). The (latency,
    baseline, breach) sequence is the reference detector's at 1e-6; the
    storm's first chunk (4) is still in band, so the baseline moves once
    more (to 18.2951), and from the first breach on it holds exactly the
    value it had after the last in-band chunk — not chunk 3's 18.1123,
    which the reference test expects."""
    r = _run("baseline_freeze")
    got, want = r["port"]["outs"], r["jax"]["outs"]
    _same([(o["latency"], o["baseline"], o["breach"]) for o in got],
          [(o["latency"], o["baseline"], o["breach"]) for o in want])
    breaches = [i for i, o in enumerate(got) if o["breach"]]
    assert breaches == [5, 6, 7]
    assert not got[STORM_T0 // CHUNK]["breach"]
    last_in_band = got[breaches[0] - 1]["baseline"]
    assert last_in_band == pytest.approx(18.2951, abs=1e-4)
    assert got[STORM_T0 // CHUNK - 1]["baseline"] == pytest.approx(
        18.1123, abs=1e-4)
    for i in breaches:
        assert got[i]["baseline"] == last_in_band, i


def test_fault_storm_walkthrough_matches_the_reference():
    """`serve.cases.fault_storm_recovery` (the port's trace from a twin
    key, search 8 x 8) against the reference walkthrough's inputs through
    the reference runtime: heal at chunk 6, 6 gateways moved off
    (1, 0) / (2, 3) for 12 nJ and 100 stall cycles, placement
    ((2, 0), (1, 3), (3, 2), (0, 2))."""
    runtime, victims, want = _loop(
        JAX, jres.ResiliencePolicy(threshold_frac=0.10, hysteresis=2,
                                   cooldown=1), _storm_specs(2))
    got = tcases.fault_storm_recovery("cpu")
    assert got["victims"] == victims[:2] == ((1, 0), (2, 3))
    _same([{k: e[k] for k in ("latency", "baseline", "breach", "healed")}
           for e in got["events"]], want)
    heals = [(i, e["healed"]) for i, e in enumerate(got["events"])
             if e["healed"]]
    assert [(i, h["moved_gateways"], h["pcm_nj"], h["stall_cycles"])
            for i, h in heals] == [(6, 6, 12.0, 100)]
    assert got["placement"] == ((2, 0), (1, 3), (3, 2), (0, 2)) \
        == runtime.session.placement
    assert (got["total_pcm_nj"], got["total_stall_cycles"],
            got["replacements"]) == (12.0, 100, 1)


@pytest.mark.parametrize("blocked,incumbent,offset", [
    (((1, 0), (2, 3)), None, 0),
    (((1, 2), (3, 1), (2, 2)), ((2, 1), (0, 2), (3, 3), (2, 0)), 1),
    (((0, 0),), None, 3)], ids=["two", "three+incumbent", "off-placement"])
def test_plan_replacement_matches_the_reference(blocked, incumbent, offset):
    """One plan from the same clean chunk, placement, blocked routers and
    warm start: old / new / incumbent placements, moved gateways, PCM nJ
    and stall cycles exactly, the search's best score at 1e-6."""
    chunk = {k: (v[:CHUNK] if k in ("ext_load", "mem_load", "int_load")
                 else v) for k, v in _trace().items()}
    plans = {}
    for label, S in (("jax", JAX), ("port", PORT)):
        placement = tuple(S.Session(S.sim).placement)
        plans[label] = S.plan(dict(chunk), S.sim, placement, blocked,
                              _storm_policy(S), incumbent=incumbent,
                              seed_offset=offset, **S.kw)
    _same(plans["port"], plans["jax"])
    assert not set(plans["port"]["new_placement"]) & set(blocked)


@pytest.mark.parametrize("kw", [
    {"threshold_frac": 0.0}, {"threshold_frac": -0.1},
    {"hysteresis": 0}, {"cooldown": -1},
    {"baseline_ewma": 0.0}, {"baseline_ewma": 1.5}],
    ids=lambda kw: f"{next(iter(kw))}={next(iter(kw.values()))}")
def test_policy_rejects_bad_parameters(kw):
    msgs = []
    for policy in (tres.ResiliencePolicy, jres.ResiliencePolicy):
        with pytest.raises(ValueError) as e:
            policy(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert dataclasses.asdict(tres.ResiliencePolicy()) \
        == dataclasses.asdict(jres.ResiliencePolicy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_detector_is_the_reference_s_on_random_telemetry(seed):
    """The pure-Python detector, sample for sample, on noisy telemetry
    with storms (the same floats out, fire included)."""
    rng = random.Random(seed)
    kw = dict(threshold_frac=rng.choice([0.05, 0.1, 0.2]),
              hysteresis=rng.randint(1, 3), cooldown=rng.randint(0, 3),
              baseline_ewma=rng.choice([0.1, 0.25, 1.0]))
    mine = tres.DegradationDetector(tres.ResiliencePolicy(**kw))
    theirs = jres.DegradationDetector(jres.ResiliencePolicy(**kw))
    for i in range(200):
        lat = rng.uniform(90, 110) * (1.6 if 60 <= i % 100 < 75 else 1.0)
        assert mine.update(lat) == theirs.update(lat)
        assert mine.in_band(lat) == theirs.in_band(lat)


def test_degradation_detector_threshold_hysteresis_cooldown():
    det = tres.DegradationDetector(tres.ResiliencePolicy(
        threshold_frac=0.10, hysteresis=2, cooldown=2))
    assert det.update(100.0)["breach"] is False
    assert det.update(105.0)["breach"] is False
    assert det.update(130.0) == {"latency": 130.0, "baseline": det.baseline,
                                 "breach": True, "fire": False}
    out = det.update(130.0)
    assert out["breach"] and out["fire"]
    assert det.update(130.0)["fire"] is False
    assert det.update(130.0)["fire"] is False
    assert det.update(130.0)["fire"]
    assert det.baseline == pytest.approx(101.25)


def test_repair_placement_moves_only_blocked_gateways():
    cfg = tsim.SimConfig().cfg
    placement = tsim.SimSession.init(tsim.SimConfig(), device="cpu").placement
    blocked = (placement[0],)
    repaired = tsearch.repair_placement(placement, blocked, cfg)
    assert repaired == jsearch.repair_placement(placement, blocked,
                                                jsim.SimConfig().cfg)
    assert blocked[0] not in repaired
    assert set(placement) - set(blocked) <= set(repaired)
    assert tsearch.repair_placement(placement, (), cfg) == placement


def test_report_failed_positions_dedups_and_sorts():
    runtime = tres.ResilienceRuntime(
        tsim.SimSession.init(tsim.SimConfig(), device="cpu"))
    runtime.report_failed_positions([(3, 1), (0, 2), (3, 1)])
    assert runtime._blocked == ((0, 2), (3, 1))
    assert runtime.current_cfg == tsim.SimConfig().cfg.with_placement(
        runtime.session.placement)
