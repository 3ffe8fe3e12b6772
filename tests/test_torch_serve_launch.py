"""The port's serving launcher (`python -m repro_torch.launch.serve`)
against the reference's (`python -m repro.launch.serve`) on the CPU.

Two seeded runs, each through both launchers in this process: the
defaults (seed 0: 58 submitted, admitted and completed over 26 ticks + 2
drain, 141 chunks in 25 dispatches) and a fault storm with the healer
(`--storm-at 6 --heal --arrival-rate 4 --deadline 6 --lanes 4`: 100
submitted, 65 admitted, 59 completed over 29 ticks + 5 drain, 12 shed for
a full queue, 15 for priority, 10 displaced, 14 expired, 148 chunks in 42
dispatches, 13 coalesced, 13 degraded ticks, no heal, 93% availability).
The port draws its sessions' traces with the threefry twin from the same
keys. Every printed line but the wall-clock percentiles, every counter of
`metrics()` and every tick event equal the reference's (latencies at
rtol 1e-6), and every completed session replays exactly. Last, the
serving example `examples/torch_serve_batch.py` prints the summary of
`examples/serve_batch.py` (after the runs above, which compiled the
reference's engine at its shapes).
"""
import contextlib
import functools
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import serve as jlaunch
from repro_torch.launch import serve as tlaunch
from repro_torch.serve.engine import replay_standalone

STORM = ["--storm-at", "6", "--heal", "--arrival-rate", "4", "--deadline",
         "6", "--lanes", "4"]
RUNS = {"defaults": [], "storm": STORM}
# The reference's counters at seed 0 (jax 0.9.0 on the CPU).
REFERENCE = {
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


def _lines(text: str) -> list:
    """The printed lines with the wall-clock percentiles cut off."""
    return [line.split("; chunk wall")[0] for line in text.splitlines()]


@functools.lru_cache(maxsize=None)
def _run(name: str):
    out = {}
    for label, mod, extra in (("jax", jlaunch, []),
                              ("port", tlaunch, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            server = mod.main(RUNS[name] + extra)
        out[label] = (server, _lines(buf.getvalue()))
    return out


def _drain_ticks(lines) -> int:
    return int(lines[0].split("(+")[1].split(" drain")[0])


@pytest.mark.parametrize("name", list(RUNS))
def test_launcher_counters_are_the_reference_s(name):
    server, lines = _run(name)["port"]
    m = server.metrics()
    got = {k: m[k] for k in REFERENCE[name] if k in m}
    got["drain"] = _drain_ticks(lines)
    if "availability" in REFERENCE[name]:
        got["availability"] = f"{m['availability']:.0%}"
    assert got == REFERENCE[name]
    ref_server, ref_lines = _run(name)["jax"]
    want = ref_server.metrics()
    assert set(m) == set(want)
    for k, v in want.items():
        if k in ("p50_chunk_s", "p99_chunk_s"):
            continue                                  # wall clock
        if isinstance(v, float):
            np.testing.assert_allclose(m[k], v, rtol=1e-6, err_msg=k)
        else:
            assert m[k] == v, k
    assert _drain_ticks(ref_lines) == got["drain"]


@pytest.mark.parametrize("name", list(RUNS))
def test_launcher_prints_the_reference_s_lines(name):
    assert _run(name)["port"][1] == _run(name)["jax"][1]


@pytest.mark.parametrize("name", list(RUNS))
def test_launcher_events_and_sessions_match_the_reference(name):
    (j, _), (t, _) = _run(name)["jax"], _run(name)["port"]
    assert len(t.events) == len(j.events)
    for a, b in zip(t.events, j.events):
        assert set(a) == set(b)
        for k in b:
            if isinstance(b[k], float):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
            else:
                assert a[k] == b[k], k
    ends = [(s.termination_reason, s.priority, s.submitted_tick,
             s.admitted_tick, s.terminated_tick, s.served_intervals,
             len(s.served_log)) for s in j.sessions.values()]
    assert [(s.termination_reason, s.priority, s.submitted_tick,
             s.admitted_tick, s.terminated_tick, s.served_intervals,
             len(s.served_log)) for s in t.sessions.values()] == ends
    for a, b in zip(t.sessions.values(), j.sessions.values()):
        sa, sb = a.summary(), b.summary()
        for k in ("mean_latency", "mean_power_mw", "mean_energy",
                  "mean_gateways"):
            np.testing.assert_allclose(sa[k], sb[k], rtol=1e-6)


@pytest.mark.parametrize("name", list(RUNS))
def test_launcher_sessions_replay_exactly(name):
    server = _run(name)["port"][0]
    for sess in server.completed:
        ref = replay_standalone(server.sim, sess, device="cpu")
        mine = sess.summary()
        for k in ("mean_latency", "mean_power_mw", "mean_energy",
                  "mean_gateways", "valid_intervals"):
            assert float(ref[k]) == mine[k], (sess.id, k)


def _options(mod) -> set:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        mod.main(["--help"])
    return {w.strip("[],") for w in buf.getvalue().split()
            if w.startswith(("--", "[--"))}


def test_launcher_takes_the_reference_s_flags_and_a_device():
    assert _options(tlaunch) == _options(jlaunch) | {"--device"}


def test_launcher_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--ticks", "1"])


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_lines(main, *args) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(*args)
    return [line for line in _lines(buf.getvalue())
            if line.startswith("[serve]")]


def test_serve_batch_example_is_the_references():
    examples = Path(__file__).resolve().parents[1] / "examples"
    want = _example_lines(_load(examples / "serve_batch.py").main)
    got = _example_lines(_load(examples / "torch_serve_batch.py").main,
                         ["--device", "cpu"])
    assert got == want and len(got) == 4
