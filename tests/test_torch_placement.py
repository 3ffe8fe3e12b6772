"""Placement sweeps and the host placement search: the port against the JAX
reference on the CPU.

`sweep_placement` per architecture and composed with topology and runtime
grids, `sweep_placement_batch`, `search.repair_placement`, and
`search_placement(engine="host")`: the same candidates in every generation,
the same accepted flags and best placement as the reference's host engine,
scores at 1e-5 relative. The reference's traces are carried across with
`interop`; records and summaries at rtol = atol = 1e-6 with integer g exact.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import search as jsearch
from repro.core import simulator as jsim
from repro.core import traffic as jtr
from repro.core.constants import NETWORK as JNET
from repro_torch import backend, interop
from repro_torch.core import search as tsearch
from repro_torch.core import selection as tsel
from repro_torch.core import simulator as tsim
from repro_torch.core.constants import NETWORK as TNET

ARCHS = [a.value for a in jsim.Arch]
CENTER = ((1, 1), (2, 2), (1, 2), (2, 1))
CORNERS = ((0, 0), (3, 3), (0, 3), (3, 0))
PLACEMENTS = [None, CENTER, CORNERS, ((1, 0), (2, 3), (0, 2), (3, 1))]


def _np(tr):
    return {k: (v if k == "app" else np.asarray(v)) for k, v in tr.items()}


def _trace(app="dedup", t=8, seed=0, c=4, dest=False):
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
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def _match_out(got, want):
    assert set(got["records"]) == set(want["records"])
    _match(got["records"], want["records"], "records.")
    _match(got["summary"], want["summary"], "summary.")


@pytest.mark.parametrize("arch", ARCHS)
def test_sweep_placement_matches_the_reference(arch):
    tr = _trace(seed=1, dest=arch == "resipi")
    jc, tc = _cfgs(arch)
    backend.reset_counters()
    got = tsim.sweep_placement(_port(tr), tc, PLACEMENTS, device="cpu")
    assert backend.COUNTERS["loop_runs"] == 1
    _match_out(got, jsim.sweep_placement(tr, jc, PLACEMENTS))
    # Lane k is the port's own unpadded simulate with that placement.
    for k, p in enumerate(PLACEMENTS):
        sim_k = dataclasses.replace(tc, cfg=tc.cfg.with_placement(
            tsel.normalize_placement(p)))
        want = tsim.simulate(_port(tr), sim_k, device="cpu")["summary"]
        for key, v in want.items():
            np.testing.assert_allclose(got["summary"][key][k].numpy(),
                                       v.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=f"lane {k} {key}")


@pytest.mark.parametrize("arch", ["resipi", "resipi_all", "awgr"])
def test_sweep_placement_composes_with_topology_and_runtime(arch):
    tr = _trace("canneal", seed=2, c=9, dest=True)
    jc, tc = _cfgs(arch)
    grid = dict(n_chiplets=[4, 9, 6], mesh_radix=[4, 4, 5],
                l_m=np.float32([0.008, 0.02, 0.012]))
    cands = [CENTER, None, ((0, 0), (4, 4), (0, 4), (4, 0))]
    _match_out(tsim.sweep_placement(_port(tr), tc, cands, device="cpu",
                                    **grid),
               jsim.sweep_placement(tr, jc, cands, **grid))


def test_sweep_placement_batch_matches_the_reference():
    trs = [_trace(seed=3), _trace("facesim", t=6, seed=4)]
    jc, tc = _cfgs("resipi")
    got = tsim.sweep_placement_batch([_port(t) for t in trs], tc, PLACEMENTS,
                                     device="cpu")
    assert got["summary"]["mean_latency"].shape == (2, len(PLACEMENTS))
    _match_out(got, jsim.sweep_placement_batch(trs, jc, PLACEMENTS))


def test_sweep_placement_validation():
    tr = _port(_trace(seed=5))
    tc = tsim.SimConfig()
    with pytest.raises(ValueError, match="outside"):
        tsim.sweep_placement(tr, tc, [((9, 9), (1, 1), (2, 2), (0, 2))],
                             device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        tsim.sweep_topology(tr, tc, device="cpu", gateways_per_chiplet=[3],
                            gateway_positions=[((1, 1), (2, 2))])
    with pytest.raises(ValueError, match="share one length"):
        tsim.sweep_placement(tr, tc, [CENTER], device="cpu",
                             n_chiplets=[4, 4])


REPAIRS = {
    "none blocked": (CENTER, [], 4),
    "one blocked": (CENTER, [(1, 1)], 4),
    "all blocked": (CORNERS, list(CORNERS), 4),
    "ties": (((2, 2), (1, 1), (0, 0), (3, 3)), [(2, 2), (1, 2), (2, 1)], 4),
    "radix 6": (((1, 1), (4, 4), (1, 4), (4, 1)), [(1, 1), (4, 4)], 6),
}


@pytest.mark.parametrize("case", list(REPAIRS))
def test_repair_placement_matches_the_reference(case):
    placement, blocked, radix = REPAIRS[case]
    jcfg = JNET.with_topology(mesh_radix=radix)
    tcfg = TNET.with_topology(mesh_radix=radix)
    assert tsearch.repair_placement(placement, blocked, tcfg) \
        == jsearch.repair_placement(placement, blocked, jcfg)


def test_repair_placement_raises_without_room():
    cfg = TNET.with_topology(mesh_radix=2, gateways_per_chiplet=2)
    with pytest.raises(ValueError, match="no free position"):
        tsearch.repair_placement(((0, 0), (1, 1)), [(0, 0), (0, 1), (1, 0)],
                                 cfg)


def _record_candidates(monkeypatch, module):
    seen = []
    real = module.sweep_placement

    def recorded(trace, sim, placements, **kw):
        seen.append(list(placements))
        return real(trace, sim, placements, **kw)

    monkeypatch.setattr(module, "sweep_placement", recorded)
    return seen


SEARCHES = {
    "inter_latency": dict(objective="inter_latency", generations=4,
                          population=6, seed=0),
    "energy": dict(objective="energy", generations=3, population=5, seed=3),
    "blocked": dict(objective="latency", generations=3, population=6,
                    seed=1, blocked_positions=[(1, 0), (3, 1)]),
    "init": dict(objective="power", generations=3, population=4, seed=2,
                 init=CENTER, temperature=0.5),
}


@pytest.mark.parametrize("case", list(SEARCHES))
def test_host_search_follows_the_reference_trajectory(monkeypatch, case):
    tr = _trace(t=10, seed=6)
    jc, tc = _cfgs("resipi")
    kw = SEARCHES[case]
    want_cands = _record_candidates(monkeypatch, jsim)
    got_cands = _record_candidates(monkeypatch, tsim)
    want = jsim.search_placement(tr, jc, engine="host", **kw)
    backend.reset_counters()
    got = tsim.search_placement(_port(tr), tc, engine="host", device="cpu",
                                **kw)
    # One plain-loop run (one sweep_placement call) per generation.
    assert backend.COUNTERS["loop_runs"] == kw["generations"]
    assert got_cands == want_cands
    assert got["best_placement"] == want["best_placement"]
    assert got["default_placement"] == want["default_placement"]
    for key in ("objective", "generations", "population", "engine"):
        assert got[key] == want[key], key
    for key in ("best_score", "default_score", "improvement_frac"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-9, err_msg=key)
    assert set(got["best_summary"]) == set(want["best_summary"])
    for key, v in want["best_summary"].items():
        np.testing.assert_allclose(got["best_summary"][key], v, rtol=1e-5,
                                   err_msg=key)
    assert len(got["history"]) == len(want["history"])
    for g, w in zip(got["history"], want["history"]):
        assert g["generation"] == w["generation"]
        assert g["accepted"] == w["accepted"]
        for key in ("parent_score", "best_candidate_score", "best_score",
                    "latency", "power_mw", "energy"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=key)


def test_search_engines_and_parameters():
    tr = _port(_trace(seed=7))
    tc = tsim.SimConfig()
    # The reference's default engine is the device one.
    default = tsim.search_placement(tr, tc, generations=2, population=3,
                                    device="cpu")
    assert default["engine"] == "device"
    assert default == tsim.search_placement(tr, tc, engine="device",
                                            generations=2, population=3,
                                            device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tsim.search_placement(tr, tc, engine="gpu", device="cpu")
    for kw, msg in ((dict(population=1), "population"),
                    (dict(generations=0), "generations"),
                    (dict(objective="speed"), "unknown placement objective"),
                    (dict(init=((1, 0), (2, 3), (0, 2), (3, 1)),
                          blocked_positions=[(1, 0)]), "repair it first"),
                    (dict(blocked_positions=[(x, y) for x in range(4)
                                             for y in range(4)][:13]),
                     "allowed positions")):
        with pytest.raises(ValueError, match=msg):
            tsim.search_placement(tr, tc, engine="host", device="cpu", **kw)


def test_summary_schema_and_objectives_match_the_reference():
    assert tsim.SUMMARY_KEYS == jsim.SUMMARY_KEYS
    assert tsim.PLACEMENT_OBJECTIVE_ALIASES \
        == jsim.PLACEMENT_OBJECTIVE_ALIASES
    for objective in ("inter_latency", "latency", "power", "energy",
                      "mean_gateways", "valid_intervals"):
        tsim.check_placement_objective(objective)
    with pytest.raises(ValueError, match="unknown placement objective"):
        tsim.check_placement_objective("throughput")
    summary = {k: np.arange(3, dtype=np.float32) + i
               for i, k in enumerate(tsim.SUMMARY_KEYS)}
    inter = np.arange(12, dtype=np.float32).reshape(3, 4)
    for objective in ("inter_latency", "energy", "mean_wavelengths"):
        np.testing.assert_array_equal(
            tsim._placement_scores(summary, inter, objective),
            jsim._placement_scores(summary, inter, objective))


def test_rebuild_selection_tables_bypasses_the_caches():
    cfg = TNET.with_placement(CENTER)
    fresh = tsim.rebuild_selection_tables(cfg, device="cpu")
    cached = tsel.selection_tables_torch(cfg, "cpu")
    assert fresh is not tsim.rebuild_selection_tables(cfg, device="cpu")
    for k, v in cached.items():
        np.testing.assert_array_equal(fresh[k].numpy(), v.numpy(),
                                      err_msg=k)
    want = jsim.rebuild_selection_tables(JNET.with_placement(CENTER))
    for k in ("src_hops", "gw_loss_db"):
        np.testing.assert_array_equal(fresh[k].numpy(), np.asarray(want[k]))
