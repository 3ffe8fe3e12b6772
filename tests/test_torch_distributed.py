"""The fleet layer of the port against the JAX reference on the CPU:
partitioning, `GridSharding`, the rules table and meshes, the five sharded
entry points, and the fleet launcher.

Several devices are emulated in one process (`devices=["cpu"] * 4`, as the
reference's `tests/test_distributed.py` forces four host devices): every
sharded call must equal the one-device call bit for bit (every block runs
at the whole grid's padded shapes) and the reference's unsharded call at
1e-6, and carry the reference's sharding description. Several processes
are tested by one 2-process gloo fleet against the single-process run,
point by point, and the emulated-host shards `--shard i:3` concatenate to
the full grid.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import simulator as jsim
from repro.core import traffic as jtr
from repro.launch import fleet as jfleet
from repro.launch import mesh as jmesh
from repro.sharding import rules as jrules
from repro_torch import interop
from repro_torch import random as trandom
from repro_torch.core import distributed as tdist
from repro_torch.core import simulator as tsim
from repro_torch.core import traffic as ttr
from repro_torch.launch import fleet as tfleet
from repro_torch.launch import mesh as tmesh
from repro_torch.sharding import rules as trules

REPO = Path(__file__).resolve().parent.parent
CPU4 = ["cpu"] * 4
RTOL = 1e-6


def _sims(arch="resipi"):
    return (jsim.SimConfig().with_arch(jsim.Arch(arch)),
            tsim.SimConfig().with_arch(tsim.Arch(arch)))


def _equal(got, want, path=""):
    """Bitwise equality of nested results (tensors, arrays, scalars)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want or (got != got and want != want), (path, got,
                                                              want)


def _close(got, want, path=""):
    """The port's records / summaries against the reference's: integers
    and booleans exact, floats at 1e-6."""
    got = interop.records_to_numpy(got)
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        assert g.shape == w.shape, (path + k, g.shape, w.shape)
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=path + k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL,
                                       err_msg=path + k)


def _unsharded(out):
    """A sharded result without its sharding notes, to hold against the
    one-device call."""
    out = dict(out)
    out.pop("sharding")
    out["summary"] = {k: v for k, v in out["summary"].items()
                      if k != "pad_lanes"}
    return out


# ---------------------------------------------------------------------------
# partition_bounds, init_distributed, GridSharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 5, 8, 13, 64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_partition_bounds_is_the_references(k, n):
    got = [tdist.partition_bounds(k, n, i) for i in range(n)]
    assert got == [jdist.partition_bounds(k, n, i) for i in range(n)]
    assert [j for a, b in got for j in range(a, b)] == list(range(k))


def test_partition_bounds_rejects_out_of_range_shard():
    with pytest.raises(ValueError):
        tdist.partition_bounds(8, 2, 2)


def test_init_distributed_single_process_is_noop_and_idempotent():
    tdist.shutdown_distributed()
    with pytest.raises(ValueError, match="collectives"):
        tdist.init_distributed(collectives="mpi")
    info = tdist.init_distributed()
    assert info["distributed"] is False
    assert info["num_processes"] == 1 and info["process_id"] == 0
    assert not tdist.is_distributed()
    assert tdist.process_index() == 0 and tdist.process_count() == 1
    assert tdist.init_distributed() == info
    tdist.shutdown_distributed()


def test_grid_sharding_single_device_is_passthrough():
    gs = tdist.GridSharding(5, devices=["cpu"])
    assert gs.describe() == {"grid_points": 5, "pad_lanes": 0,
                             "devices": 1, "processes": 1}
    assert gs.devices == [torch.device("cpu")]
    x = torch.arange(10.0).reshape(5, 2)
    (dev, block), = gs.shard(x)
    assert dev == torch.device("cpu") and torch.equal(block, x)
    (_, same), = gs.replicate({"a": x, "b": None})
    assert same["a"] is x and same["b"] is None
    assert torch.equal(gs.gather([block]), x)
    with pytest.raises(ValueError):
        tdist.GridSharding(4, devices=[])


def test_grid_sharding_pads_by_repeating_the_last_row():
    gs = tdist.GridSharding(3, devices=CPU4)
    assert gs.describe() == {"grid_points": 3, "pad_lanes": 1,
                             "devices": 4, "processes": 1}
    x = np.arange(6.0).reshape(3, 2)
    padded = gs.pad_tree(x)
    assert padded.shape == (4, 2)
    np.testing.assert_array_equal(padded[3], x[-1])
    assert [list(i) for _, i in gs.local_blocks()] == [[0], [1], [2], [2]]
    blocks = [b for _, b in gs.shard({"x": x, "t": torch.as_tensor(x)})]
    out = gs.gather(blocks)
    np.testing.assert_array_equal(out["x"], x)
    assert torch.equal(out["t"], torch.as_tensor(x))
    # [N, K] results gather along the grid axis 1.
    y = torch.arange(12.0).reshape(2, 3, 2)
    got = gs.gather([y[:, [int(i[0])]] for _, i in gs.local_blocks()],
                    axis=1)
    assert torch.equal(got, y)


# ---------------------------------------------------------------------------
# The rules table and the meshes
# ---------------------------------------------------------------------------

def test_rules_table_and_overlays_are_the_references():
    assert trules.DEFAULT_RULES == jrules.DEFAULT_RULES
    assert trules.SP_OVERLAY == jrules.SP_OVERLAY
    assert trules.TP_ONLY_OVERLAY == jrules.TP_ONLY_OVERLAY


@pytest.mark.parametrize("overrides", [None, jrules.SP_OVERLAY,
                                       {"sweep": ("grid",)}])
def test_rules_resolve_as_the_references(overrides):
    """`spec` and `spec_for_shape` on the host mesh (data, model) and on a
    one-device fleet mesh (grid) give the reference's PartitionSpecs."""
    cases = [("batch", "seq", "heads"), ("sweep",), ("islands", None),
             ("experts", "model_d", "ff"), ("vocab", "model_d"),
             ("kv_seq", "kv"), ("seq_outer", "heads"), ("archive",)]
    fleet_j = jmesh.make_fleet_mesh(jax.devices()[:1])
    for jm, tm in ((jmesh.make_host_mesh(), tmesh.make_host_mesh()),
                   (fleet_j, tmesh.make_fleet_mesh(["cpu"]))):
        jr, tr = jrules.Rules(jm, overrides), trules.Rules(tm, overrides)
        for axes in cases:
            assert tr.spec(*axes) == tuple(jr.spec(*axes)), axes
            shape = (8, 3, 16)[:len(axes)]
            assert tr.spec_for_shape(shape, *axes) == \
                tuple(jr.spec_for_shape(shape, *axes)), axes
            assert tr.sharding(*axes).spec == tr.spec(*axes)


def test_core_distributed_imports_nothing_of_the_launcher():
    """The fleet's device list lives in `core.distributed`; the launcher's
    mesh reads it, never the other way round."""
    code = ("import sys, repro_torch.core.distributed\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.startswith(('repro_torch.launch',\n"
            "                              'repro_torch.sharding'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_meshes():
    m = tmesh.make_fleet_mesh(CPU4)
    assert m.axis_names == ("grid",) and m.shape == (4,) and m.size == 4
    assert m.local_devices(0) == ["cpu"] * 4
    h = tmesh.make_host_mesh()
    assert (h.axis_names, h.shape) == (("data", "model"), (1, 1))
    with trules.use_rules(trules.Rules(m)) as r:
        assert trules.active_rules() is r
        x = torch.ones(2)
        assert trules.shard(x, "sweep") is x
    assert trules.active_rules() is None
    # The production meshes are logical: the reference's axes and shape
    # (`repro.launch.mesh.make_production_mesh`, which needs 256 / 512
    # devices to build) for spec derivation, with no device to place a
    # tensor on.
    for multi_pod, axes, shape in (
            (False, ("data", "model"), (16, 16)),
            (True, ("pod", "data", "model"), (2, 16, 16))):
        pm = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert (pm.axis_names, pm.shape) == (axes, shape)
        assert pm.size == int(np.prod(shape))
        with pytest.raises(ValueError, match="logical mesh"):
            trules.place(x, trules.Rules(pm).sharding("batch"))
    assert trules.place(x, trules.Rules(h).sharding("batch")).device.type \
        == "cpu"


# ---------------------------------------------------------------------------
# The sharded entry points
# ---------------------------------------------------------------------------

SPECS = [ttr.UniformSpec(n_intervals=6), ttr.BurstySpec(n_intervals=6),
         ttr.UniformSpec(n_intervals=6)]


def _specs_j():
    return [getattr(jtr, type(s).__name__)(**dataclasses.asdict(s))
            for s in SPECS]


@pytest.mark.parametrize("arch,dest", [("resipi", False), ("resipi", True),
                                       ("prowaves", True)])
def test_sharded_sweep_workload(arch, dest):
    """3 points on 4 emulated devices: one padded lane, reported; the
    result bitwise the one-device call's and the reference's at 1e-6."""
    jc, tc = _sims(arch)
    grid = dict(n_chiplets=[4, 9, 16])
    one = tsim.sweep_workload(SPECS, tc, dest=dest, device="cpu", **grid)
    got = tsim.sweep_workload(SPECS, tc, dest=dest, devices=CPU4, **grid)
    assert "sharding" not in one
    assert got["sharding"] == {"grid_points": 3, "pad_lanes": 1,
                               "devices": 4, "processes": 1}
    assert got["summary"]["pad_lanes"] == 1
    _equal(_unsharded(got), one)
    want = jsim.sweep_workload(_specs_j(), jc, dest=dest, **grid)
    _close(got["records"], want["records"], "records.")
    _close(_unsharded(got)["summary"], want["summary"], "summary.")


def test_sharded_workload_blocks_hold_only_their_traces(monkeypatch):
    """Lane k reads trace k, so each block of a sharded workload sweep
    holds only its own lanes' traces and destination matrices (the
    per-device footprint shrinks with the device count); a shard_sweep
    block, whose lanes read every trace, holds them all."""
    _, tc = _sims()
    seen = []
    real = tsim._scan_trace

    def recorded(state, xs, sim, tables, **kw):
        seen.append((int(xs[0].shape[0]), int(kw["dest"].shape[0]),
                     kw["lane_trace"].tolist(), kw["pair_trace"].tolist()))
        return real(state, xs, sim, tables, **kw)

    monkeypatch.setattr(tsim, "_scan_trace", recorded)
    specs = SPECS + [ttr.BurstySpec(n_intervals=6)]
    tsim.sweep_workload(specs, tc, dest=True, devices=["cpu"] * 2,
                        n_chiplets=[4, 9, 16, 9])
    assert seen == [(2, 2, [0, 1], [0, 1])] * 2
    seen.clear()
    batch = [ttr.generate(s, trandom.prng_key(i, device="cpu"),
                          tc.cfg.with_topology(n_chiplets=9), dest=True,
                          device="cpu") for i, s in enumerate(SPECS[:2])]
    tsim.shard_sweep(batch, tc, devices=["cpu"] * 2, n_chiplets=[4, 9])
    assert [s[0] for s in seen] == [2, 2]


def _small_traces(c):
    cfg = tsim.SimConfig().cfg.with_topology(n_chiplets=c)
    return [ttr.generate(s, trandom.prng_key(i, device="cpu"), cfg,
                         device="cpu") for i, s in enumerate(SPECS[:2])]


# Each one-device entry point on small traces, and one split run.
ONE_DEVICE_CALLS = {
    "simulate": lambda tc: tsim.simulate(_small_traces(4)[0], tc,
                                         device="cpu"),
    "simulate_batch": lambda tc: tsim.simulate_batch(_small_traces(4), tc,
                                                     device="cpu"),
    "sweep": lambda tc: tsim.sweep(_small_traces(4)[0], tc, device="cpu",
                                   l_m=[0.006, 0.02]),
    "sweep_batch": lambda tc: tsim.sweep_batch(
        _small_traces(4), tc, device="cpu", l_m=[0.006, 0.02]),
    "sweep_topology": lambda tc: tsim.sweep_topology(
        _small_traces(9)[0], tc, device="cpu", n_chiplets=[4, 9]),
    "sweep_topology_batch": lambda tc: tsim.sweep_topology_batch(
        _small_traces(9), tc, device="cpu", n_chiplets=[4, 9]),
    "sweep_workload_runtime": lambda tc: tsim.sweep_workload(
        SPECS, tc, device="cpu", l_m=[0.006, 0.02, 0.012]),
    "sweep_workload_topology": lambda tc: tsim.sweep_workload(
        SPECS, tc, dest=True, device="cpu", n_chiplets=[4, 9, 16]),
    "shard_sweep_one_device": lambda tc: tsim.shard_sweep(
        _small_traces(9), tc, devices=["cpu"], n_chiplets=[4, 9]),
    "shard_sweep_two_devices": lambda tc: tsim.shard_sweep(
        _small_traces(9), tc, devices=["cpu"] * 2, n_chiplets=[4, 9]),
}


@pytest.mark.parametrize("entry", sorted(ONE_DEVICE_CALLS))
def test_one_device_runs_call_the_interval_loop_directly(entry, monkeypatch):
    """A one-device run is one run of its lanes: it builds no lane index
    and takes no blocks and gathers none (here they raise); a split run
    still runs through `GridSharding.local_blocks`."""
    class Refused(Exception):
        pass

    def refuse(*args, **kwargs):
        raise Refused

    for name in ("padded_index", "local_blocks", "gather"):
        monkeypatch.setattr(tdist.GridSharding, name, refuse)
    _, tc = _sims()
    if entry == "shard_sweep_two_devices":
        with pytest.raises(Refused):
            ONE_DEVICE_CALLS[entry](tc)
        return
    out = ONE_DEVICE_CALLS[entry](tc)
    assert set(out["summary"]) >= set(tsim.SUMMARY_KEYS)
    if entry == "shard_sweep_one_device":
        assert out["sharding"] == {"grid_points": 2, "pad_lanes": 0,
                                   "devices": 1, "processes": 1}


def test_sharded_sweep_workload_runtime_grid():
    jc, tc = _sims()
    grid = dict(l_m=np.float32([0.006, 0.02, 0.012]))
    one = tsim.sweep_workload(SPECS, tc, seed=3, device="cpu", **grid)
    got = tsim.sweep_workload(SPECS, tc, seed=3, devices=["cpu"] * 2, **grid)
    assert got["sharding"]["pad_lanes"] == 1
    _equal(_unsharded(got), one)
    want = jsim.sweep_workload(_specs_j(), jc, seed=3, **grid)
    _close(got["records"], want["records"], "records.")


def test_sharded_shard_sweep():
    jc, tc = _sims()
    cfg = jc.cfg.with_topology(n_chiplets=9)
    trs = [{k: (v if k == "app" else np.asarray(v)) for k, v in
            jtr.generate(jtr.ParsecSpec(app, 6), jax.random.PRNGKey(i), cfg,
                         dest=True).items()}
           for i, app in enumerate(("dedup", "canneal"))]
    grid = dict(n_chiplets=[4, 9, 6], gateways_per_chiplet=[4, 2, 3])
    port = [interop.trace_from_numpy(t, "cpu") for t in trs]
    one = tsim.shard_sweep(port, tc, device="cpu", **grid)
    assert one["sharding"] == {"grid_points": 3, "pad_lanes": 0,
                               "devices": 1, "processes": 1}
    got = tsim.shard_sweep(port, tc, devices=CPU4, **grid)
    assert got["sharding"] == {"grid_points": 3, "pad_lanes": 1,
                               "devices": 4, "processes": 1}
    _equal(_unsharded(got), _unsharded(one))
    _equal(tsim.sweep_topology_batch(port, tc, devices=CPU4, **grid), got)
    want = jsim.shard_sweep(trs, jc, **grid)
    _close(got["records"], want["records"], "records.")
    single = tsim.shard_sweep(port[0], tc, devices=["cpu"] * 2, **grid)
    _equal(_unsharded(single)["records"],
           tsim.sweep_topology(port[0], tc, device="cpu", **grid)["records"])


def test_sharded_island_search():
    jc, tc = _sims()
    tr = {k: (v if k == "app" else np.asarray(v)) for k, v in jtr.generate(
        jtr.ParsecSpec("dedup", 8), jax.random.PRNGKey(0), jc.cfg).items()}
    kw = dict(islands=4, generations=3, population=4, seed=1,
              l_m=[0.008, 0.012, 0.02, 0.03])
    port = interop.trace_from_numpy(tr, "cpu")
    one = tsim.search_placement_islands(port, tc, device="cpu", **kw)
    tsim.reset_engine_stats()
    got = tsim.search_placement_islands(port, tc, devices=["cpu"] * 2, **kw)
    assert tsim.engine_stats()["search_dispatches"] == 1
    assert got.pop("sharding") == {"grid_points": 4, "pad_lanes": 0,
                                   "devices": 2, "processes": 1}
    _equal(got, one)
    want = jsim.search_placement_islands(tr, jc, **kw)
    for key in ("best_placement", "island_best_placements",
                "island_incumbents", "default_placement"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["island_best_scores"],
                               want["island_best_scores"], rtol=RTOL)
    # 3 islands on 2 devices: the last island's chain runs twice.
    odd = tsim.search_placement_islands(port, tc, devices=["cpu"] * 2,
                                        **dict(kw, islands=3,
                                               l_m=kw["l_m"][:3]))
    assert odd.pop("sharding")["pad_lanes"] == 1
    _equal(odd, tsim.search_placement_islands(
        port, tc, device="cpu", **dict(kw, islands=3, l_m=kw["l_m"][:3])))


def test_sharded_codesign():
    """Islands split over 2 devices, the ring migration crossing the
    blocks every generation: the one-device search, bit for bit; islands
    that do not divide the devices run unsharded, as the reference's."""
    jc, tc = _sims()
    cfg = jc.cfg.with_topology(n_chiplets=9)
    trs = [{k: (v if k == "app" else np.asarray(v)) for k, v in
            jtr.generate(spec, jax.random.PRNGKey(i), cfg,
                         dest=True).items()}
           for i, spec in enumerate((jtr.ParsecSpec("canneal", 6),
                                     jtr.UniformSpec(n_intervals=5)))]
    port = [interop.trace_from_numpy(t, "cpu") for t in trs]
    kw = dict(n_chiplets=[4, 9], islands=4, generations=4, population=3,
              migrate_every=1, archive=16, seed=2)
    one = tsim.search_codesign(port, tc, device="cpu", **kw)
    tsim.reset_engine_stats()
    got = tsim.search_codesign(port, tc, devices=["cpu"] * 2, **kw)
    assert tsim.engine_stats()["search_dispatches"] == 1
    assert got.pop("sharding") == {"grid_points": 4, "pad_lanes": 0,
                                   "devices": 2, "processes": 1}
    _equal(got, one)
    want = jsim.search_codesign(trs, jc, **kw)
    assert [(e["placement"], e["topology_index"], e["island"])
            for e in got["front"]] == \
        [(e["placement"], e["topology_index"], e["island"])
         for e in want["front"]]
    odd = tsim.search_codesign(port, tc, devices=["cpu"] * 3, **kw)
    assert "sharding" not in odd and "sharding" not in want
    _equal(odd, one)


# ---------------------------------------------------------------------------
# The fleet launcher
# ---------------------------------------------------------------------------

def test_fleet_grid_is_the_references():
    jc, tc = _sims()
    for seed in (0, 7):
        for count in (1, 4):
            assert tfleet.sample_placements(tc.cfg, count, seed) == \
                jfleet.sample_placements(jc.cfg, count, seed)
    kw = dict(chiplets=[4, 16, 36, 64], placements=4,
              workloads=["uniform", "bursty", "dedup", "canneal"],
              intervals=24, seed=0)
    got, want = tfleet.build_grid(tc.cfg, **kw), \
        jfleet.build_grid(jc.cfg, **kw)
    assert got["k"] == want["k"] == 64
    assert got["labels"] == want["labels"]
    assert got["grids"] == want["grids"]
    assert [dataclasses.asdict(s) for s in got["specs"]] == \
        [dataclasses.asdict(s) for s in want["specs"]]
    for i in range(3):
        a, b = tdist.partition_bounds(64, 3, i), \
            jdist.partition_bounds(64, 3, i)
        assert tfleet.slice_grid(got, *a)["labels"] == \
            jfleet.slice_grid(want, *b)["labels"]


def _fleet_args(*extra):
    return tfleet.build_parser().parse_args(
        ["--device", "cpu", "--intervals", "6", "--no-cache",
         "--dump-points", *extra])


def test_fleet_shards_concatenate_to_the_full_grid():
    """`--shard i:3` runs the rows a fleet member owns: the three shards'
    points, concatenated, are the full 64-point run's bit for bit."""
    full = tfleet.run_sweep(_fleet_args())
    assert full["grid_points"] == 64 and full["mode"] == "local"
    parts = [tfleet.run_sweep(_fleet_args(), shard=(i, 3)) for i in range(3)]
    assert [p["grid_points"] for p in parts] == [22, 22, 20]
    for key in ("labels", "mean_latency", "mean_power_mw", "mean_energy"):
        assert [v for p in parts for v in p[key]] == full[key], key
    emulated = tfleet.run_sweep(_fleet_args("--local-device-count", "3"))
    assert emulated["device_count"] == 3 and emulated["pad_lanes"] == 2
    for key in ("mean_latency", "mean_power_mw", "mean_energy"):
        assert emulated[key] == full[key], key


def test_two_process_gloo_fleet_equals_one_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    outs = {}
    for name, extra in (("one", []), ("two", ["--processes", "2"])):
        out = tmp_path / f"{name}.json"
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.fleet", "--device",
             "cpu", "--intervals", "6", "--no-cache", "--dump-points",
             "--out", str(out), *extra], cwd=REPO, env=env, timeout=300,
            capture_output=True, text=True)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        outs[name] = json.loads(out.read_text())
    one, two = outs["one"], outs["two"]
    assert two["mode"] == "distributed" and two["process_count"] == 2
    assert two["device_count"] == 2 and two["pad_lanes"] == 0
    assert two["distributed"]["collectives"] == "gloo"
    for key in ("labels", "mean_latency", "mean_power_mw", "mean_energy"):
        assert two[key] == one[key], key
