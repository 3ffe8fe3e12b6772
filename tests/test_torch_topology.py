"""Padded topology and workload sweeps: the port against the JAX reference
on the CPU.

`sweep_topology`, `sweep_topology_batch`, `shard_sweep` (one device) and
`sweep_workload` for all four architectures, with destination matrices, a
ragged batch, a `mesh_radix` grid, runtime knobs zipped in and a point past
128 chiplets; a point padded to its own size against the port's unpadded
`simulate`; every validation error; the padded selection tables array for
array. Traces are made by the reference from numpy-seeded keys and carried
across with `interop`. Tolerance rtol = atol = 1e-6 with integer g and
boolean saturation exact, and padded chiplet columns exactly 0.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.core import simulator as jsim
from repro.core import traffic as jtr
from repro.core.constants import NETWORK as JNET
from repro_torch import backend, interop
from repro_torch.core import selection as tsel
from repro_torch.core import simulator as tsim
from repro_torch.core import traffic as ttr
from repro_torch.core.constants import NETWORK as TNET

ARCHS = [a.value for a in jsim.Arch]
GRID_C = [4, 6, 9]
GRID_G = [4, 2, 3]
T = 8


def _np(tr):
    return {k: (v if k == "app" else np.asarray(v)) for k, v in tr.items()}


def _trace(app="dedup", c=9, t=T, seed=0, dest=False):
    cfg = JNET.with_topology(n_chiplets=c)
    return _np(jtr.generate(jtr.ParsecSpec(app, t), jax.random.PRNGKey(seed),
                            cfg, dest=dest))


def _port(tr):
    return interop.trace_from_numpy(tr, "cpu")


def _cfgs(arch):
    return (jsim.SimConfig().with_arch(jsim.Arch(arch)),
            tsim.SimConfig().with_arch(tsim.Arch(arch)))


def _match(got, want, path=""):
    got = interop.records_to_numpy(got)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        name = f"{path}{k}"
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def _match_out(got, want):
    assert set(got["records"]) == set(want["records"])
    assert set(got["summary"]) == set(want["summary"])
    _match(got["records"], want["records"], "records.")
    _match(got["summary"], want["summary"], "summary.")


def _padded_columns_zero(out, n_chiplets):
    """Every per-chiplet record of point k is exactly 0 past its chiplets."""
    recs = out["records"]
    for k, c in enumerate(n_chiplets):
        for name in ("g", "gw_load", "wavelengths"):
            assert torch.all(recs[name][..., k, :, c:] == 0), (name, k)


@pytest.mark.parametrize("dest", [False, True], ids=["uniform", "dest"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sweep_topology_matches_the_reference(arch, dest):
    tr = _trace(dest=dest, seed=1)
    jc, tc = _cfgs(arch)
    grid = dict(n_chiplets=GRID_C, gateways_per_chiplet=GRID_G)
    backend.reset_counters()
    got = tsim.sweep_topology(_port(tr), tc, device="cpu", **grid)
    # One plain-loop run for the whole grid on the CPU.
    assert backend.COUNTERS["loop_runs"] == 1
    _match_out(got, jsim.sweep_topology(tr, jc, **grid))
    _padded_columns_zero({"records": {k: v[None] for k, v in
                                      got["records"].items()}}, GRID_C)


@pytest.mark.parametrize("arch", ARCHS)
def test_point_padded_to_its_own_size_equals_unpadded_simulate(arch):
    """A grid whose maxima equal its one point: the port's padded run
    equals its own unpadded `simulate` of topology_point_config."""
    tr = _trace(seed=2, dest=arch == "resipi")
    _, tc = _cfgs(arch)
    got = tsim.sweep_topology(_port(tr), tc, device="cpu", n_chiplets=[9],
                              gateways_per_chiplet=[4])
    point = tsim.topology_point_config(tc, n_chiplets=9,
                                       gateways_per_chiplet=4)
    want = tsim.simulate(_port(tr), point, device="cpu")
    _match({k: v[0] for k, v in got["records"].items()},
           interop.records_to_numpy(want["records"]), "records.")
    _match({k: v[0] for k, v in got["summary"].items()},
           interop.records_to_numpy(want["summary"]), "summary.")


def test_mesh_radix_sweep_matches_the_reference():
    tr = _trace(seed=3, c=4)
    jc, tc = _cfgs("resipi")
    grid = dict(n_chiplets=[4, 4, 2], mesh_radix=[4, 6, 3])
    _match_out(tsim.sweep_topology(_port(tr), tc, device="cpu", **grid),
               jsim.sweep_topology(tr, jc, **grid))


def test_radix_sweep_resets_an_explicit_base_placement():
    """A mesh_radix grid drops the base config's explicit placement, as
    topology_point_config does, and matches the reference."""
    tr = _trace(seed=4, c=4)
    jc, tc = _cfgs("resipi")
    center = ((1, 1), (2, 2), (1, 2), (2, 1))
    jc = dataclasses.replace(jc, cfg=jc.cfg.with_placement(center))
    tc = dataclasses.replace(tc, cfg=tc.cfg.with_placement(center))
    got = tsim.sweep_topology(_port(tr), tc, device="cpu", mesh_radix=[4, 6])
    _match_out(got, jsim.sweep_topology(tr, jc, mesh_radix=[4, 6]))
    point = tsim.topology_point_config(tc, mesh_radix=6)
    assert point.cfg.gateway_positions is None
    want = tsim.simulate(_port(tr), point, device="cpu")
    np.testing.assert_allclose(
        got["summary"]["mean_latency"][1].numpy(),
        want["summary"]["mean_latency"].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["resipi", "prowaves"])
def test_sweep_topology_batch_ragged_matches_the_reference(arch):
    trs = [_trace("dedup", t=T, seed=5, dest=True),
           _trace("canneal", t=T - 3, seed=6, dest=True)]
    jc, tc = _cfgs(arch)
    grid = dict(n_chiplets=GRID_C, gateways_per_chiplet=GRID_G)
    backend.reset_counters()
    got = tsim.sweep_topology_batch([_port(t) for t in trs], tc,
                                    device="cpu", **grid)
    assert backend.COUNTERS["loop_runs"] == 1
    assert got["summary"]["mean_latency"].shape == (2, len(GRID_C))
    _match_out(got, jsim.sweep_topology_batch(trs, jc, **grid))
    _padded_columns_zero(got, GRID_C)


def test_destination_matrices_one_per_trace_and_chiplet_count():
    """The padded inputs hold one destination matrix per distinct (trace,
    chiplet count) pair, and each matrix names its trace: every lane's
    matrix belongs to the trace the lane reads."""
    trs = [_trace("dedup", seed=5, dest=True),
           _trace("canneal", seed=6, dest=True)]
    grid = dict(n_chiplets=[4, 9, 4, 6], gateways_per_chiplet=[4, 2, 3, 3])
    kw = tsim.topology_inputs([_port(t) for t in trs], tsim.SimConfig(),
                              device="cpu", **grid)[3]
    assert kw["dest"].shape == (2 * 3, 9, 9)
    assert torch.equal(kw["pair_trace"].long()[kw["dest_index"].long()],
                       kw["lane_trace"].long())
    lane_c = kw["topo"]["n_chiplets"]
    for p in range(kw["dest"].shape[0]):
        c = int(lane_c[kw["dest_index"] == p][0])
        assert torch.all(lane_c[kw["dest_index"] == p] == c)
        assert torch.all(kw["dest"][p, c:] == 0)
        assert torch.all(kw["dest"][p, :, c:] == 0)


def test_point_past_128_chiplets_matches_the_reference():
    tr = _trace(c=144, t=6, seed=7, dest=True)
    jc, tc = _cfgs("resipi")
    grid = dict(n_chiplets=[4, 144])
    got = tsim.sweep_topology(_port(tr), tc, device="cpu", **grid)
    _match_out(got, jsim.sweep_topology(tr, jc, **grid))
    assert torch.all(got["records"]["g"][0, :, 4:] == 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_runtime_fields_zipped_with_dest_traces(arch):
    tr = _trace(seed=8, dest=True)
    jc, tc = _cfgs(arch)
    grid = dict(n_chiplets=[4, 9, 6, 9], gateways_per_chiplet=[2, 4, 3, 1],
                l_m=np.float32([0.006, 0.02, 0.0152, 0.01]),
                max_gateways=np.int32([4, 3, 4, 2]),
                min_gateways=np.int32([1, 2, 3, 1]),
                wavelengths=np.int32([4, 2, 8, 4]),
                prowaves_rho_lo=np.float32([0.3, 0.2, 0.4, 0.3]))
    _match_out(tsim.sweep_topology(_port(tr), tc, device="cpu", **grid),
               jsim.sweep_topology(tr, jc, **grid))


def test_shard_sweep_on_one_device_and_its_multi_device_error():
    tr = _trace(seed=9)
    jc, tc = _cfgs("resipi")
    got = tsim.shard_sweep(_port(tr), tc, device="cpu", n_chiplets=GRID_C)
    want = jsim.shard_sweep(tr, jc, n_chiplets=GRID_C)
    assert got["sharding"] == want["sharding"]
    assert got["summary"]["pad_lanes"] == want["summary"]["pad_lanes"] == 0
    got["summary"].pop("pad_lanes")
    want["summary"].pop("pad_lanes")
    _match_out(got, want)
    batched = tsim.shard_sweep([_port(tr), _port(tr)], tc, devices=["cpu"],
                               n_chiplets=GRID_C)
    assert batched["summary"]["mean_latency"].shape == (2, 3)
    # Two devices shard the 3 points (one padded lane, reported): the
    # one-device records, bit for bit.
    for out in (tsim.shard_sweep(_port(tr), tc, devices=["cpu", "cpu"],
                                 n_chiplets=GRID_C),
                tsim.sweep_topology_batch([_port(tr)], tc,
                                          devices=["cpu", "cpu"],
                                          n_chiplets=GRID_C)):
        assert out["sharding"] == {"grid_points": 3, "pad_lanes": 1,
                                   "devices": 2, "processes": 1}
        assert out["summary"]["pad_lanes"] == 1
        ref = got if out["records"]["g"].dim() == 3 else \
            tsim.sweep_topology_batch([_port(tr)], tc, device="cpu",
                                      n_chiplets=GRID_C)
        for k, v in ref["records"].items():
            assert torch.equal(out["records"][k], v), k


VALIDATION = {
    "nothing swept": ({}, "at least one"),
    "unknown field": ({"bogus_field": [1, 2]}, "non-sweepable"),
    "length mismatch": ({"n_chiplets": [4, 8], "gateways_per_chiplet": [2]},
                        "share one length"),
    "too many gateways": ({"gateways_per_chiplet": [6]}, "exceeds"),
    "trace too narrow": ({"n_chiplets": [17]}, "covers"),
    "runtime only": ({"l_m": np.float32([0.01])}, "no topology fields"),
    "scalar grid": ({"n_chiplets": 4}, "1-D grid"),
    "placements not a list": ({"gateway_positions": np.zeros((1, 4, 2))},
                              "list of placements"),
    "invalid topology": ({"n_chiplets": [0]}, "invalid topology grid"),
    "placement outside": ({"gateway_positions": [((9, 9), (1, 1), (2, 2),
                                                  (0, 2))]}, "outside"),
}


@pytest.mark.parametrize("case", list(VALIDATION))
def test_validation_errors_match_the_reference(case):
    tr = _trace(seed=10)
    grid, msg = VALIDATION[case]
    jc, tc = _cfgs("resipi")
    with pytest.raises(ValueError, match=msg):
        jsim.sweep_topology(tr, jc, **grid)
    with pytest.raises(ValueError, match=msg):
        tsim.sweep_topology(_port(tr), tc, device="cpu", **grid)


def test_fault_frames_are_refused_on_padded_paths():
    tr = _trace(seed=11, c=4)
    tc = tsim.SimConfig()
    g = tc.cfg.max_gateways_per_chiplet
    faulted = dict(_port(tr), gw_ok=torch.ones(T, 4, g),
                   stuck_on=torch.zeros(T, 4, g), drift_db=torch.zeros(T))
    with pytest.raises(ValueError, match="fault frames are not supported"):
        tsim.sweep_topology(faulted, tc, device="cpu", n_chiplets=[4])


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card the default device raises; nothing runs on the CPU
    unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = _port(_trace(seed=12, c=4))
    tc = tsim.SimConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.sweep_topology(tr, tc, n_chiplets=[4])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.sweep_workload(["dedup"], tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsel.padded_selection_tables_torch((TNET,))


def _table_cfgs(pkg_net):
    return tuple(pkg_net.with_topology(n_chiplets=c, gateways_per_chiplet=g,
                                       mesh_radix=r)
                 for c, g, r in [(4, 4, 4), (16, 2, 4), (64, 4, 6),
                                 (9, 3, 5)])


@pytest.mark.parametrize("pad_to", [None, (4, 64)], ids=["max", "explicit"])
def test_padded_tables_equal_the_reference(pad_to):
    want = jsel.build_selection_tables_padded(_table_cfgs(JNET), pad_to)
    got = tsel.build_selection_tables_padded(_table_cfgs(TNET), pad_to)
    for name in tsel.PaddedSelectionTables.FIELDS:
        w, g = getattr(want, name), getattr(got, name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # Memoized per (cfgs, pad_to); the device view likewise per device.
    assert tsel.build_selection_tables_padded(_table_cfgs(TNET), pad_to) \
        is got
    view = tsel.padded_selection_tables_torch(_table_cfgs(TNET), pad_to,
                                              "cpu")
    assert view is tsel.padded_selection_tables_torch(_table_cfgs(TNET),
                                                      pad_to, "cpu")
    np.testing.assert_array_equal(view["src_hops"].numpy(), want.src_hops)


def test_padded_tables_build_each_mesh_once_and_reject_a_small_pad():
    before = tsel.build_selection_tables.cache_info().misses
    cfgs = tuple(TNET.with_topology(n_chiplets=c, gateways_per_chiplet=3,
                                    mesh_radix=7) for c in (4, 16, 64, 256))
    tsel.build_selection_tables_padded(cfgs)
    assert tsel.build_selection_tables.cache_info().misses == before + 1
    with pytest.raises(ValueError, match="smaller than topology"):
        tsel.build_selection_tables_padded((TNET,), (2, 16))


SPECS_J = [jtr.ParsecSpec("dedup", 10), jtr.UniformSpec(n_intervals=6),
           jtr.PermutationSpec(pattern="transpose", n_intervals=8),
           jtr.BurstySpec(n_intervals=7)]


def _specs_t():
    return [getattr(ttr, type(s).__name__)(**dataclasses.asdict(s))
            for s in SPECS_J]


@pytest.mark.parametrize("dest", [False, True], ids=["uniform", "dest"])
@pytest.mark.parametrize("arch", ["resipi", "awgr"])
def test_sweep_workload_runtime_branch_matches_the_reference(arch, dest):
    jc, tc = _cfgs(arch)
    grid = dict(l_m=np.float32([0.006, 0.02, 0.0152, 0.01]))
    backend.reset_counters()
    got = tsim.sweep_workload(_specs_t(), tc, seed=3, dest=dest,
                              device="cpu", **grid)
    assert backend.COUNTERS["loop_runs"] == 1
    _match_out(got, jsim.sweep_workload(SPECS_J, jc, seed=3, dest=dest,
                                        **grid))


@pytest.mark.parametrize("arch", ARCHS)
def test_sweep_workload_topology_branch_matches_the_reference(arch):
    jc, tc = _cfgs(arch)
    grid = dict(n_chiplets=[4, 8, 6, 8], gateways_per_chiplet=[4, 2, 4, 3])
    got = tsim.sweep_workload(_specs_t(), tc, seed=5, dest=True,
                              device="cpu", **grid)
    _match_out(got, jsim.sweep_workload(SPECS_J, jc, seed=5, dest=True,
                                        **grid))


def test_sweep_workload_explicit_twin_keys_and_gen_chiplets():
    """Explicit keys (the reference's jax keys as numpy, and the same keys
    as a twin tensor) and a generation width past the grid's give the
    reference's lanes. Synthetic specs at 4 chiplets, which the twin
    generates bit for bit (PARSEC traces and wider rows differ by a few
    ulps: ROADMAP queue 3, P2, bounded by test_torch_traffic.py)."""
    jc, tc = _cfgs("resipi")
    keys = jax.random.split(jax.random.PRNGKey(11), 4)[1:3]
    specs = [jtr.HotspotSpec(n_intervals=6), jtr.UniformSpec(n_intervals=5)]
    specs_t = [ttr.HotspotSpec(n_intervals=6), ttr.UniformSpec(n_intervals=5)]
    grid = dict(n_chiplets=[2, 3])
    want = jsim.sweep_workload(specs, jc, keys=keys, gen_chiplets=4,
                               dest=True, **grid)
    for k in (np.asarray(keys), interop.key_from_jax(keys, "cpu")):
        got = tsim.sweep_workload(specs_t, tc, keys=k, gen_chiplets=4,
                                  dest=True, device="cpu", **grid)
        _match_out(got, want)


def test_sweep_workload_takes_app_names():
    tc = tsim.SimConfig()
    by_name = tsim.sweep_workload(["canneal", "facesim"], tc, seed=2,
                                  device="cpu", n_chiplets=[4, 6])
    by_spec = tsim.sweep_workload([ttr.ParsecSpec("canneal", 64),
                                   ttr.ParsecSpec("facesim", 64)], tc, seed=2,
                                  device="cpu", n_chiplets=[4, 6])
    for part in ("records", "summary"):
        for k, v in by_spec[part].items():
            assert torch.equal(by_name[part][k], v), (part, k)


def test_sweep_workload_validation():
    tc = tsim.SimConfig()
    cases = [(([],), {}, "at least one traffic spec"),
             ((["dedup"],), {"keys": np.zeros((2, 2), np.uint32)},
              "keys for"),
             ((["dedup", "facesim"],), {"l_m": [0.01]}, "zips element-wise"),
             ((["dedup"],), {"n_chiplets": [8], "gen_chiplets": 4},
              "gen_chiplets"),
             ((["dedup"],), {"bogus": [1]}, "non-sweepable")]
    for args, kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tsim.sweep_workload(*args, tc, device="cpu", **kw)
    # The sharded path validates alike.
    for args, kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tsim.sweep_workload(*args, tc, devices=["cpu", "cpu"], **kw)
