"""The co-design search as one CUDA graph: what the CPU can check.

The graph itself runs only on the card (`tests/test_torch_cuda.py`: replays
bit for bit the eager searches of their seeds, inputs changed at equal
shapes reach the replay, the counters). Here: the gate refuses the graph
for CPU tensors, several blocks, several processes and the host engine; a
search's cache key changes with every shape and Python scalar the capture
bakes in and with nothing that only changes the inputs' values; the cache
marks a key's first search eager and its second for capture, holds a
fixed number of keys and is emptied by `clear_codesign_caches`; the
counters in `engine_stats()`; and the tensor walk that copies a search's
inputs into the graph's static tensors. Imports no JAX.
"""
import dataclasses

import pytest
import torch

from repro_torch.core import pareto as tpar
from repro_torch.core import simulator as tsim
from repro_torch.core import traffic

KW = dict(n_chiplets=[4, 8], mesh_radix=[3, 4], islands=2, generations=2,
          population=3, archive=8, migrate_every=1,
          knob_grids={"l_m": [0.01, 0.02]}, seed=1)


def _traces(apps=("dedup", "canneal"), n_int=4, dest=False):
    cfg = tsim.SimConfig().cfg.with_topology(n_chiplets=8)
    return [traffic.generate(traffic.ParsecSpec(a, n_int), i, cfg,
                             dest=dest, device="cpu")
            for i, a in enumerate(apps)]


@pytest.mark.parametrize("engine, device, blocks, processes, want", [
    ("device", "cuda", 1, 1, True),
    ("device", "cuda:0", 1, 1, True),
    ("device", "cpu", 1, 1, False),
    ("device", "cuda", 2, 1, False),
    ("device", "cuda", 1, 2, False),
    ("host", "cuda", 1, 1, False),
])
def test_the_gate(engine, device, blocks, processes, want):
    assert tpar._graph_gate(engine, torch.device(device), blocks,
                            processes) is want


@pytest.fixture
def keys(monkeypatch):
    """Every search's cache key, with the gate open on the CPU (each
    search still runs eager: the slot is forced)."""
    seen = []
    monkeypatch.setattr(tpar, "_graph_gate", lambda *a: True)

    def slot(key):
        seen.append(key)
        return "eager"
    monkeypatch.setattr(tpar, "_graph_slot", slot)
    return seen


def _key(keys, traces=_traces, sim=None, **kw):
    """The key of a search at KW changed by `kw` (`traces` makes them)."""
    tpar.search_codesign(traces(),
                         tsim.SimConfig() if sim is None else sim,
                         device="cpu", **dict(KW, **kw))
    return keys[-1]


# Each changes a shape or a scalar the capture bakes in.
BAKED = {
    "generations": dict(generations=3),
    "population": dict(population=4),
    "migrate_every": dict(migrate_every=2),
    "archive": dict(archive=9),
    "islands": dict(islands=3, knob_grids={"l_m": [0.01, 0.02, 0.03]}),
    "restart_frac": dict(restart_frac=0.5),
    "grid_chiplets": dict(n_chiplets=[6, 8]),        # rows, d_pad, bounds
    "grid_radix": dict(mesh_radix=[3, 5]),           # big_bound, a_bound
    "grid_points": dict(n_chiplets=[4, 6, 8], mesh_radix=[3, 3, 4]),
    "workloads": dict(traces=lambda: _traces(("dedup", "canneal",
                                              "facesim"))),
    "intervals": dict(traces=lambda: _traces(n_int=5)),
    "destinations": dict(traces=lambda: _traces(dest=True)),
    "padded_config": dict(sim=tsim.SimConfig().with_arch(
        tsim.Arch.RESIPI_ALL)),
}
# Each changes only values the graph reads from its static tensors.
DATA = {
    "seed": dict(seed=7),
    "temperature": dict(temperature=0.2, cooling=0.5),
    "knob_values": dict(knob_grids={"l_m": [0.015, 0.03]}),
    "gateway_bounds": dict(knob_grids={"l_m": [0.01, 0.02],
                                       "max_gateways": [2, 3]}),
    "trace_values": dict(traces=lambda: _traces(("facesim",
                                                 "bodytrack"))),
}


@pytest.mark.parametrize("change", list(BAKED))
def test_the_key_changes_with_what_a_capture_bakes_in(keys, change):
    base = _key(keys)
    assert _key(keys) == base
    assert _key(keys, **BAKED[change]) != base


@pytest.mark.parametrize("change", list(DATA))
def test_the_key_stays_where_only_the_inputs_values_change(keys, change):
    assert _key(keys, **DATA[change]) == _key(keys)


def test_the_key_names_the_device_and_the_design():
    x = [torch.zeros(2, 3)]
    base = dict(generations=2, design="wide")
    key = tpar._graph_key("cuda:0", None, (), x, **base)
    assert tpar._graph_key("cuda:1", None, (), x, **base) != key
    assert tpar._graph_key("cuda:0", None, (), x,
                           **dict(base, design="split")) != key
    assert tpar._graph_key("cuda:0", None, (), [torch.zeros(2, 3).long()],
                           **base) != key


def test_a_keys_first_search_is_eager_its_second_captures():
    tpar.clear_codesign_caches()
    try:
        assert tpar._graph_slot(("a",)) == "eager"
        assert tpar._graph_slot(("b",)) == "eager"
        assert tpar._graph_slot(("a",)) == "capture"
        tpar._GRAPHS[("a",)] = graph = object()
        assert tpar._graph_slot(("a",)) is graph
        for i in range(tpar._GRAPH_SLOTS):
            tpar._graph_slot(("more", i))
        assert len(tpar._GRAPHS) == tpar._GRAPH_SLOTS
        assert ("a",) not in tpar._GRAPHS     # the least recently used
        assert tpar._graph_slot(("a",)) == "eager"
        tpar.clear_codesign_caches()
        assert not tpar._GRAPHS
    finally:
        tpar.clear_codesign_caches()


def test_engine_stats_count_captures_and_replays():
    stats = tsim.engine_stats()
    assert "codesign_graph_captures" in stats
    assert "codesign_graph_replays" in stats
    tsim._STATS["codesign_graph_captures"] += 1
    tsim._STATS["codesign_graph_replays"] += 2
    stats = tsim.engine_stats()
    assert stats["codesign_graph_captures"] >= 1
    assert stats["codesign_graph_replays"] >= 2
    tsim.reset_engine_stats()
    stats = tsim.engine_stats()
    assert stats["codesign_graph_captures"] == 0
    assert stats["codesign_graph_replays"] == 0
    assert stats["search_dispatches"] == 0


def test_a_cpu_search_captures_nothing():
    tsim.reset_engine_stats()
    for _ in range(2):
        tpar.search_codesign(_traces(), tsim.SimConfig(), device="cpu",
                             **KW)
    stats = tsim.engine_stats()
    assert stats["search_dispatches"] == 2
    assert stats["codesign_graph_captures"] == 0
    assert stats["codesign_graph_replays"] == 0
    assert "codesign.replay" not in stats["spans"]


def test_the_tensor_walk_round_trips_a_scoring():
    sim = tsim.SimConfig().with_arch(tsim.Arch.RESIPI)
    sim_p, rows, _, c_max, _ = tpar._prepare_codesign(sim, [4, 8], [4],
                                                      [3, 4], "cpu")
    arrays = tsim._topo_trace_arrays(tsim.stack_traces(_traces(), pad=True),
                                     c_max, "cpu")
    knobs = tpar._knob_grid({"l_m": [0.01, 0.02]}, 2, sim, [4, 4])
    scoring = tsim.codesign_scoring(
        sim_p, {k: rows[k] for k in tpar._LANE_ROWS}, knobs, arrays, 3,
        [4, 8])
    inputs = (torch.zeros(2), [scoring], {"rows": rows})
    leaves = tpar._tensors(inputs)
    assert len(leaves) > 20
    new = [x.clone() for x in leaves]
    back = tpar._with_tensors(inputs, iter(new))
    got = tpar._tensors(back)
    assert all(a is b for a, b in zip(got, new)) and len(got) == len(new)
    s2 = back[1][0]
    assert s2.sim is scoring.sim and s2.shape == scoring.shape
    assert dataclasses.fields(s2) == dataclasses.fields(scoring)
    assert s2.xs[0] is not scoring.xs[0]
    assert torch.equal(s2.xs[0], scoring.xs[0])
    assert s2.state0.ctl.g is not scoring.state0.ctl.g
