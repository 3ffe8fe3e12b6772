"""The padded entry points' topology plan: what `simulator.topology_inputs`
builds from its non-trace inputs (the prepared grid, the lane maps, the
lanes' knobs, the destination pairs' plan) is memoized by the config, the
grids' values, `pad_chiplets`, `zipped`, the trace count and the device.
A hit gives the records and summaries of a fresh build bit for bit, on
other traces of the same grid; every key part builds anew when it
changes; a tensor grid bypasses the memo; no result shares a tensor with
it; both clear functions empty it and it keeps its most recent entries;
`engine_stats()` counts builds and hits; a `lane_topology` patched after a
hit still runs (the benchmark's planted topology faults). On the card
(marker `cuda`): the c256-shaped call's second run is a hit with one host
read, bitwise a run after `clear_engine_caches()`. This file imports no
JAX."""
import dataclasses

import pytest
import torch

from repro_torch.core import selection
from repro_torch.core import simulator as tsim
from repro_torch.core import traffic

SIM = tsim.SimConfig().with_arch(tsim.Arch.RESIPI)
GRID = {"n_chiplets": [4, 9, 16, 16], "gateways_per_chiplet": [4, 2, 1, 3]}
APPS = ("dedup", "canneal")
T = 6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `python -m pytest -m cuda "
                    "tests/test_torch_topology_plan.py` on a machine with "
                    "a card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_memo():
    tsim.clear_engine_caches()
    tsim.reset_engine_stats()
    yield
    tsim.clear_engine_caches()
    tsim.reset_engine_stats()


def _traces(seed: int, n: int = 2, dest: bool = True,
            chiplets: int = 20) -> list:
    cfg = SIM.cfg.with_topology(n_chiplets=chiplets)
    return [traffic.generate(traffic.ParsecSpec(APPS[i % 2], T),
                             100 * seed + i, cfg, dest=dest, device="cpu")
            for i in range(n)]


def _plans() -> tuple:
    stats = tsim.engine_stats()
    return stats["topology_plan_builds"], stats["topology_plan_hits"]


def _tensors(out: dict) -> list:
    return [v for part in ("records", "summary")
            for v in out[part].values() if isinstance(v, torch.Tensor)]


def _same(got: dict, want: dict) -> None:
    for part in ("records", "summary"):
        assert set(got[part]) == set(want[part])
        for k, w in want[part].items():
            g = got[part][k]
            if not isinstance(w, torch.Tensor):   # shard_sweep's pad_lanes
                assert g == w, (part, k)
                continue
            assert g.dtype == w.dtype and g.shape == w.shape, (part, k)
            assert torch.equal(g, w), (part, k)


def _clone(out: dict) -> dict:
    return {part: {k: v.clone() if isinstance(v, torch.Tensor) else v
                   for k, v in out[part].items()}
            for part in ("records", "summary")}


# Each padded entry point on a batch drawn from `seed`: one
# `topology_inputs` call each.
ENTRIES = {
    "sweep_topology": lambda seed: tsim.sweep_topology(
        _traces(seed, 1)[0], SIM, device="cpu", **GRID),
    "sweep_topology_batch": lambda seed: tsim.sweep_topology_batch(
        _traces(seed), SIM, device="cpu", **GRID),
    "without_destinations": lambda seed: tsim.sweep_topology_batch(
        _traces(seed, dest=False), SIM, device="cpu", **GRID),
    "pad_chiplets": lambda seed: tsim.sweep_topology_batch(
        _traces(seed), SIM, device="cpu", **GRID, pad_chiplets=20),
    "shard_sweep": lambda seed: tsim.shard_sweep(
        _traces(seed), SIM, devices=["cpu", "cpu"], **GRID),
    "zipped_workload": lambda seed: tsim.sweep_workload(
        [traffic.ParsecSpec(a, T) for a in APPS * 2], SIM, seed=seed,
        dest=True, device="cpu", **GRID),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_a_hit_equals_a_fresh_build(entry):
    run = ENTRIES[entry]
    first = _clone(run(1))
    assert _plans() == (1, 0)
    hit = _clone(run(2))             # the same grid on other traces
    again = run(1)
    assert _plans() == (1, 2)
    tsim.clear_engine_caches()
    fresh = run(2)
    assert _plans() == (2, 2)
    _same(hit, fresh)
    _same(again, first)
    assert not torch.equal(hit["records"]["latency"],
                           first["records"]["latency"])


G2 = {"n_chiplets": [9, 16], "gateways_per_chiplet": [2, 3]}
# One key part changed from the base call's (2 traces on G2).
CHANGES = {
    "grid_value": dict(n_chiplets=[9, 12], gateways_per_chiplet=[2, 3]),
    "knob_grid": dict(G2, l_m=[0.006, 0.01]),
    "config_field": dict(G2, sim=dataclasses.replace(
        SIM, ctl=dataclasses.replace(SIM.ctl, l_m=0.01))),
    "trace_count": dict(G2, n=3),
    "zipped": dict(G2, zipped=True),
    "pad_chiplets": dict(G2, pad_chiplets=20),
}


def _inputs(sim=SIM, n=2, **kw):
    return tsim.topology_inputs(_traces(7, n), sim, device="cpu", **kw)


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_each_key_part_builds_anew(change):
    _inputs(**G2)
    _inputs(**G2)
    assert _plans() == (1, 1)
    _inputs(**CHANGES[change])
    assert _plans() == (2, 1)
    _inputs(**CHANGES[change])
    _inputs(**G2)
    assert _plans() == (2, 3)
    assert len(tsim._TOPOLOGY_PLANS) == 2


def test_a_tensor_grid_bypasses_the_memo():
    traces = _traces(3)
    want = tsim.sweep_topology_batch(traces, SIM, device="cpu", **GRID)
    grid = dict(GRID, n_chiplets=torch.tensor(GRID["n_chiplets"]))
    for builds in (2, 3):
        got = tsim.sweep_topology_batch(traces, SIM, device="cpu", **grid)
        _same(got, want)
        assert _plans() == (builds, 0)
        assert len(tsim._TOPOLOGY_PLANS) == 1


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_writing_into_a_result_leaves_the_next_call(entry):
    run = ENTRIES[entry]
    out = run(4)
    want = _clone(out)
    (plan,) = tsim._TOPOLOGY_PLANS.values()
    held = [plan.lane_trace, plan.point, *plan.knobs.values(),
            *plan.grid.topo.values()]
    if plan.pairs is not None:
        held += list(dataclasses.astuple(plan.pairs))
    storages = {t.untyped_storage().data_ptr() for t in held}
    for v in _tensors(out):
        assert v.untyped_storage().data_ptr() not in storages
        v.fill_(True if v.dtype == torch.bool else 7)
    _same(run(4), want)
    assert _plans() == (1, 1)


@pytest.mark.parametrize("clear", ["clear_engine_caches",
                                   "clear_padded_table_caches"])
def test_both_clears_empty_the_memo(clear):
    _inputs(**G2)
    assert len(tsim._TOPOLOGY_PLANS) == 1
    {"clear_engine_caches": tsim.clear_engine_caches,
     "clear_padded_table_caches": selection.clear_padded_table_caches}[
        clear]()
    assert len(tsim._TOPOLOGY_PLANS) == 0
    _inputs(**G2)
    assert _plans() == (2, 0)


def test_the_memo_keeps_its_most_recent_plans():
    slots = tsim._TOPOLOGY_PLAN_SLOTS

    def call(i):
        _inputs(**G2, l_m=[0.001 * (i + 1)] * 2)

    for i in range(slots):
        call(i)
    call(0)                          # a hit: plan 0 is now the newest
    for i in range(slots, slots + 4):
        call(i)
    assert len(tsim._TOPOLOGY_PLANS) == slots
    assert _plans() == (slots + 4, 1)
    call(0)
    assert _plans() == (slots + 4, 2)
    call(1)                          # the oldest, evicted
    assert _plans() == (slots + 5, 2)


def test_reset_zeroes_the_plan_counters():
    _inputs(**G2)
    _inputs(**G2)
    assert _plans() == (1, 1)
    tsim.reset_engine_stats()
    assert _plans() == (0, 0)
    _inputs(**G2)
    assert _plans() == (0, 1)


def test_a_lane_topology_patched_after_a_hit_runs(monkeypatch):
    """What the benchmark's `neighbour_topology` fault plants: each lane
    given the next point's topology rows, after the set-up's calls."""
    traces = _traces(5)
    want = tsim.sweep_topology_batch(traces, SIM, device="cpu", **GRID)
    tsim.sweep_topology_batch(traces, SIM, device="cpu", **GRID)
    real, seen = tsim.lane_topology, []

    def neighbour(topo, point, c_max):
        seen.append(point)
        k = int(topo["n_chiplets"].shape[0])
        return real(topo, (point + 1) % k, c_max)

    monkeypatch.setattr(tsim, "lane_topology", neighbour)
    got = tsim.sweep_topology_batch(traces, SIM, device="cpu", **GRID)
    assert len(seen) == 1 and _plans() == (1, 2)
    assert not torch.equal(got["summary"]["mean_latency"],
                           want["summary"]["mean_latency"])
    monkeypatch.undo()
    _same(tsim.sweep_topology_batch(traces, SIM, device="cpu", **GRID),
          want)


@pytest.mark.cuda
def test_a_c256_call_hits_its_plan_on_the_card(cuda_device):
    cfg = SIM.cfg.with_topology(n_chiplets=256)
    traces = [traffic.generate(traffic.ParsecSpec(app, 100), 60 + i, cfg,
                               dest=True, device=cuda_device)
              for i, app in enumerate(("blackscholes", "swaptions",
                                       "streamcluster", "facesim",
                                       "fluidanimate", "bodytrack",
                                       "canneal", "dedup"))]
    grid = dict(n_chiplets=[c for c in (16, 36, 64, 100, 144, 196, 256)
                            for _ in range(4)],
                gateways_per_chiplet=[1, 2, 3, 4] * 7)
    tsim.sweep_topology_batch(traces, SIM, device=cuda_device, **grid)
    tsim.reset_engine_stats()
    hit = tsim.sweep_topology_batch(traces, SIM, device=cuda_device, **grid)
    stats = tsim.engine_stats()
    assert (stats["topology_plan_builds"], stats["topology_plan_hits"]) \
        == (0, 1)
    assert sum(r["n"] for r in stats["host_reads"].values()) == 1
    assert stats["epoch_step_launches"] == 1
    tsim.clear_engine_caches()
    fresh = tsim.sweep_topology_batch(traces, SIM, device=cuda_device,
                                      **grid)
    assert tsim.engine_stats()["topology_plan_builds"] == 1
    _same(hit, fresh)
