"""The Pareto co-design of the port against the JAX reference on the CPU.

The host-side pieces (`island_weights`, `hypervolume`, the numpy archive)
equal the reference's exactly; the tensor archive equals the reference's
jnp and numpy archives exactly on adversarial batches (duplicates, exact
ties, inf / nan rows, overflow past capacity); `_activation_order_mesh`,
the five draws, the scalarization, the eviction key and the mean over
workloads are bit for bit the reference's (run under `jax.jit`, as its
engine runs them). `search_codesign` on both engines visits the
reference's trajectory on the reference test's `CODESIGN_KW` and on a grid
whose mesh radix changes along it: front placements, topology, island,
knobs, archive-size history, island incumbents and every generation's
decisions equal, objectives and scores at rtol 1e-6 (the port scores
through the plain loop of `epoch_step`, the reference through its scan
body). The reference's walkthrough and DSE-size co-design pin
`chip_smoke.py`'s phase 10 gates (PARETO_*_REFERENCE).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import pareto as jpar
from repro.core import simulator as jsim
from repro.core import traffic as jtr
from repro_torch import backend, interop
from repro_torch import random as trandom
from repro_torch.core import pareto as tpar
from repro_torch.core import search as tsearch
from repro_torch.core import selection as tsel
from repro_torch.core import simulator as tsim

RTOL = 1e-6
OBJ_KEYS = ("latency", "power_mw", "energy")

CODESIGN_KW = dict(n_chiplets=[8, 16], mesh_radix=[4, 4], islands=2,
                   generations=3, population=3, archive=16,
                   knob_grids={"l_m": [0.01, 0.02]}, seed=1)
RADIX_KW = dict(n_chiplets=[4, 8, 16], mesh_radix=[3, 4, 5], islands=3,
                generations=4, population=4, archive=4, migrate_every=1,
                seed=0)


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int64)


def _np(tr):
    return {k: (v if k == "app" else np.asarray(v)) for k, v in tr.items()}


def _sims():
    return (jsim.SimConfig().with_arch(jsim.Arch.RESIPI),
            tsim.SimConfig().with_arch(tsim.Arch.RESIPI))


@functools.lru_cache(maxsize=None)
def _traces(case):
    """Each case's workloads, drawn by the reference as numpy."""
    cfg = jsim.SimConfig().cfg
    if case == "codesign_kw":
        cfg16 = cfg.with_topology(n_chiplets=16)
        return tuple(_np(jtr.generate_trace(app, 6, jax.random.PRNGKey(i),
                                            cfg16))
                     for i, app in enumerate(("dedup", "streamcluster")))
    if case == "radix":
        return (_np(jtr.generate(jtr.ParsecSpec("canneal", 8),
                                 jax.random.PRNGKey(3),
                                 cfg.with_topology(n_chiplets=16),
                                 dest=True)),)
    n_int, seed, dest = chip_smoke.PARETO_TRACES[case]
    cfg = cfg.with_topology(n_chiplets=max(chip_smoke.PARETO_COUNTS))
    keys = jax.random.split(jax.random.PRNGKey(seed),
                            len(chip_smoke.PARETO_APPS))
    return tuple(_np(jtr.generate(jtr.ParsecSpec(a, n_int), k, cfg,
                                  dest=dest))
                 for a, k in zip(chip_smoke.PARETO_APPS, keys))


def _kw(case):
    if case in chip_smoke.PARETO_RUNS:
        return dict(chip_smoke.PARETO_RUNS[case],
                    n_chiplets=list(chip_smoke.PARETO_COUNTS))
    return {"codesign_kw": CODESIGN_KW, "radix": RADIX_KW}[case]


class _Spy:
    """`jax.numpy` for the reference's co-design module that also hands the
    host each generation's scalarized scores (its `argmin` over
    candidates) and Metropolis thresholds (its `exp`), in scan order."""

    def __init__(self):
        self.s, self.e = [], []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmin(self, a, axis=None, **kw):
        if axis == 1:
            jax.debug.callback(lambda v: self.s.append(np.asarray(v)), a,
                               ordered=True)
        return jnp.argmin(a, axis=axis, **kw)

    def exp(self, a):
        out = jnp.exp(a)
        jax.debug.callback(lambda v: self.e.append(np.asarray(v)), out,
                           ordered=True)
        return out


@functools.lru_cache(maxsize=None)
def _reference(case, engine="device"):
    """The reference's result, on the device engine its decisions
    (`chip_smoke.codesign_decisions` of the scores and thresholds its scan
    computed), and its archive's fingerprint after each insert."""
    kw = _kw(case)
    jsim_cfg, _ = _sims()
    traces = list(_traces(case))
    t_pts, gens = len(kw["n_chiplets"]), kw["generations"]
    prints = []

    def keep(arch):
        prints.append(chip_smoke.archive_print(
            arch["topo"], arch["island"], arch["pos"], arch["valid"]))

    if engine == "host":
        real_np = jpar._archive_insert_np

        def insert_np(*a):
            out = real_np(*a)
            keep(out)
            return out

        jpar._archive_insert_np = insert_np
        try:
            res = jsim.search_codesign(traces, jsim_cfg, engine="host", **kw)
        finally:
            jpar._archive_insert_np = real_np
        return res, None, _rows(prints, t_pts, gens)

    def insert(*a, **k):
        out = real_insert(*a, **k)
        jax.debug.callback(lambda *v: keep(dict(zip(
            ("topo", "island", "pos", "valid"), v))), out["topo"],
            out["island"], out["pos"], out["valid"], ordered=True)
        return out

    spy, real, real_insert = _Spy(), jpar.jnp, jpar._archive_insert
    jpar.jnp, jpar._archive_insert = spy, insert
    jpar.clear_codesign_caches()
    try:
        res = jsim.search_codesign(traces, jsim_cfg, **kw)
    finally:
        jpar.jnp, jpar._archive_insert = real, real_insert
        jpar.clear_codesign_caches()
    k = res["islands"]
    s = np.stack(spy.s).reshape(t_pts, gens, k, kw["population"])
    e = np.stack(spy.e).reshape(t_pts, gens, k)
    u = np.asarray(jax.random.uniform(
        jax.random.split(jax.random.PRNGKey(kw["seed"]), 5)[4],
        (t_pts, gens, k)))
    return (res, chip_smoke.codesign_decisions(s, e, u, _temps(gens)),
            _rows(prints, t_pts, gens))


def _rows(prints, t_pts, gens):
    assert len(prints) == t_pts * gens
    return [prints[t * gens:(t + 1) * gens] for t in range(t_pts)]


def _temps(gens):
    h = tsearch._hyper(0.05, 0.7, 0.25)
    return tsearch._temperatures(h["temperature"], h["cooling"], gens)


def _port(case, engine="device", trail=None):
    """The port's search on the CPU (the reference's traces), and with
    `trail` (a list) the device engine's trail appended to it."""
    _, tcfg = _sims()
    traces = [interop.trace_from_numpy(t, "cpu") for t in _traces(case)]
    real = tpar._codesign_core

    def keep(*a, **k):
        packed, tr = real(*a, **k)
        trail.append(tr)
        return packed, tr

    if trail is not None:
        tpar._codesign_core = keep
    try:
        return tsim.search_codesign(traces, tcfg, engine=engine,
                                    device="cpu", **_kw(case))
    finally:
        tpar._codesign_core = real


def _objs(res):
    return np.array([[e["objectives"][k] for k in OBJ_KEYS]
                     for e in res["front"]], np.float64)


def _same_search(got, want):
    assert set(got) == set(want)
    assert len(got["front"]) == len(want["front"]) > 0
    for g, w in zip(got["front"], want["front"]):
        for key in ("placement", "topology", "knobs", "topology_index",
                    "island"):
            assert g[key] == w[key], (key, g, w)
    np.testing.assert_allclose(_objs(got), _objs(want), rtol=RTOL)
    np.testing.assert_array_equal(got["history"]["archive_size"],
                                  want["history"]["archive_size"])
    np.testing.assert_allclose(got["history"]["best_scalar"],
                               want["history"]["best_scalar"], rtol=RTOL)
    assert got["island_incumbents"] == want["island_incumbents"]
    np.testing.assert_allclose(got["island_scores"], want["island_scores"],
                               rtol=RTOL)
    np.testing.assert_array_equal(got["weights"], want["weights"])
    for key in ("objectives", "grid", "knob_grids", "islands", "engine",
                "generations", "population", "migrate_every",
                "archive_capacity", "workloads", "candidate_evals"):
        assert got[key] == want[key], key
    arch_g, arch_w = got["archive"], want["archive"]
    np.testing.assert_array_equal(arch_g["valid"], arch_w["valid"])
    for key in ("topology_index", "island"):
        np.testing.assert_array_equal(arch_g[key], arch_w[key])
    assert [p for p, v in zip(arch_g["placements"], arch_g["valid"]) if v] \
        == [p for p, v in zip(arch_w["placements"], arch_w["valid"]) if v]


# ---------------------------------------------------------------------------
# Host-side pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 16, 31])
def test_island_weights_equal_the_reference(k):
    got, want = tpar.island_weights(k), jpar.island_weights(k)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_hypervolume_equals_the_reference(seed):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0.1, 5.0, size=(12, 3))
    pts[3] = pts[2]                               # a duplicate
    pts[5, 0] = pts[4, 0]                         # an exact tie
    pts[6] = np.inf
    for ref in ((6.0, 6.0, 6.0), (3.0, 4.0, 5.0), (0.05, 1.0, 1.0)):
        assert tpar.hypervolume(pts, ref) == jpar.hypervolume(pts, ref)
    assert tpar.hypervolume(np.empty((0, 3)), (1, 1, 1)) == 0.0


def _batches(seed, n_batches=6, g=2):
    """Adversarial archive offers: duplicates within and across batches,
    exact ties in one objective, inf and nan rows, more survivors than
    capacity."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_batches):
        n = int(rng.randint(3, 10))
        obj = rng.uniform(0.1, 10.0, size=(n, 3)).astype(np.float32)
        obj[rng.randint(n)] = obj[rng.randint(n)]
        obj[rng.randint(n), 1] = obj[rng.randint(n), 1]
        if out and rng.rand() < 0.7:
            obj[0] = out[-1][0][rng.randint(len(out[-1][0]))]
        if rng.rand() < 0.5:
            obj[rng.randint(n), rng.randint(3)] = np.inf
        if rng.rand() < 0.5:
            obj[rng.randint(n), rng.randint(3)] = np.nan
        # A staircase: mutually non-dominated, to overflow the capacity.
        xs = np.arange(1, n + 1, dtype=np.float32) + i
        if rng.rand() < 0.5:
            obj = np.stack([xs, 100.0 / xs, np.full(n, 2.0, np.float32)],
                           axis=-1).astype(np.float32)
        pos = rng.randint(0, 5, size=(n, g, 2)).astype(np.int32)
        out.append((obj, pos, np.full((n,), i, np.int32),
                    rng.randint(0, 4, size=n).astype(np.int32)))
    return out


@pytest.mark.parametrize("capacity", [1, 4, 8, 32])
@pytest.mark.parametrize("seed", range(3))
def test_archive_equals_the_reference(seed, capacity):
    g = 2
    a_np_t = tpar._empty_archive_np(capacity, g)
    a_np_j = jpar._empty_archive_np(capacity, g)
    a_t = tpar._empty_archive(capacity, g, "cpu")
    a_j = jpar._empty_archive(capacity, g)
    insert_j = jax.jit(functools.partial(jpar._archive_insert,
                                         capacity=capacity))
    for obj, pos, tix, kix in _batches(seed, g=g):
        a_np_t = tpar._archive_insert_np(a_np_t, obj, pos, tix, kix,
                                         capacity)
        a_np_j = jpar._archive_insert_np(a_np_j, obj, pos, tix, kix,
                                         capacity)
        a_t = tpar._archive_insert(
            a_t, torch.as_tensor(obj), torch.as_tensor(pos),
            torch.as_tensor(tix), torch.as_tensor(kix), capacity=capacity)
        a_j = insert_j(a_j, obj, pos, tix, kix)
        for k in ("obj", "pos", "topo", "island", "valid"):
            assert a_np_t[k].dtype == a_np_j[k].dtype, k
            np.testing.assert_array_equal(a_np_t[k], a_np_j[k], err_msg=k)
            np.testing.assert_array_equal(a_t[k].numpy(),
                                          np.asarray(a_j[k]), err_msg=k)
            np.testing.assert_array_equal(a_t[k].numpy(), a_np_j[k],
                                          err_msg=k)
        valid = a_t["valid"].numpy()
        assert valid.sum() <= capacity
        assert np.isfinite(a_t["obj"].numpy()[valid]).all()


def test_archive_key_is_xlas_log_sum_bitwise():
    rng = np.random.RandomState(4)
    obj = np.exp(rng.uniform(-40.0, 40.0, size=(4096, 3))).astype(np.float32)
    obj[:8] = [0.0, 1e-13, 1e-45]                # floored at 1e-12
    obj[8:16, 1] = np.inf
    want = jax.jit(lambda o: jnp.sum(jnp.log(jnp.maximum(o, 1e-12)),
                                     axis=-1))(obj)
    np.testing.assert_array_equal(
        _bits(tpar._archive_key(torch.as_tensor(obj))), _bits(want))


# ---------------------------------------------------------------------------
# The traced-topology twins, the draws and the scalarization
# ---------------------------------------------------------------------------

def test_activation_order_mesh_exact_at_radix_2_to_8():
    radices = list(range(2, 9))
    a_bound = max(_centrality_bound(r) for r in radices)
    big_bound = 4 * 2 * max(radices)
    rng = np.random.RandomState(9)
    pos, mx, want = [], [], []
    for r in radices:
        for _ in range(12):
            flat = rng.choice(r * r, size=4, replace=False)
            p = np.stack([flat // r, flat % r], axis=-1).astype(np.int32)
            pos.append(p)
            mx.append(r)
            want.append(np.asarray(jpar._activation_order_mesh(
                jnp.asarray(p), jnp.int32(r), jnp.int32(r),
                a_bound=a_bound, big_bound=big_bound)))
    got = tpar._activation_order_mesh(
        torch.as_tensor(np.stack(pos)), torch.as_tensor(mx),
        torch.as_tensor(mx), a_bound=a_bound, big_bound=big_bound)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def _centrality_bound(r):
    from repro_torch.core import topology as ttopo
    from repro_torch.core.constants import NETWORK
    return ttopo.centrality_bound(NETWORK.with_topology(mesh_radix=r))


@pytest.mark.parametrize("case", ["codesign_kw", "radix", "a"])
def test_draws_bitwise_at_the_engine_shapes(case):
    kw = _kw(case)
    _, tcfg = _sims()
    t_pts, gens, k = len(kw["n_chiplets"]), kw["generations"], \
        kw.get("islands")
    n_prop = kw["population"] - 1
    sim_p, rows, _, _, _ = tpar._prepare_codesign(
        tcfg, kw["n_chiplets"], [4] * t_pts,
        kw.get("mesh_radix", [4] * t_pts), "cpu")
    r_pad = int(rows["coords"].shape[1])
    got = tpar._draws(trandom.prng_key(kw["seed"], device="cpu"), t_pts,
                      gens, k, n_prop, r_pad, 4, np.float32(0.25))
    shape = (t_pts, gens, k, n_prop)

    @jax.jit
    def reference_draws(key, blocked):
        ks = jax.random.split(key, 5)
        out = {
            "restart": jax.random.bernoulli(ks[0], jnp.float32(0.25), shape),
            "rest_gum": jax.random.gumbel(ks[1], shape + (r_pad,)),
            "move_i": jax.random.randint(ks[2], shape + (2,), 0, 4),
            "move_gum": jax.random.gumbel(ks[3], shape + (2, r_pad)),
            "acc_u": jax.random.uniform(ks[4], (t_pts, gens, k))}
        # Restart placements: Gumbel-top-g over each point's real routers.
        gum = jnp.where(blocked[:, None, None, None, :], -jnp.inf,
                        out["rest_gum"])
        return out, jax.lax.top_k(gum, 4)[1]

    want, ridx = reference_draws(jax.random.PRNGKey(kw["seed"]),
                                 np.asarray(rows["blocked"]))
    for name, w in want.items():
        np.testing.assert_array_equal(_bits(got[name]), _bits(w),
                                      err_msg=name)
    coords = np.asarray(rows["coords"])
    want_pos = np.stack([coords[t][np.asarray(ridx[t])]
                         for t in range(t_pts)])
    np.testing.assert_array_equal(
        tpar._restart_positions(got, rows, 4).numpy(), want_pos)


@pytest.mark.parametrize("seed", range(3))
def test_scalarization_and_workload_mean_bitwise(seed):
    rng = np.random.RandomState(seed)
    objs = np.exp(rng.uniform(0, 18, size=(3, 4, 6, 3))).astype(np.float32)
    norm = np.exp(rng.uniform(0, 18, size=(3, 4, 3))).astype(np.float32)
    weights = jpar.island_weights(4)
    want = jax.jit(jax.vmap(lambda o, n: jnp.sum(
        weights[:, None, :] * o / jnp.maximum(jnp.abs(n), 1e-12)[:, None, :],
        axis=-1)))(objs, norm)
    got = tpar._scalarize(torch.as_tensor(objs), torch.as_tensor(weights),
                          torch.clamp_min(torch.abs(torch.as_tensor(norm)),
                                          1e-12))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for w in (1, 2, 3, 5, 8):
        per_w = np.exp(rng.uniform(0, 18, size=(7, w, 3))).astype(np.float32)
        want = jax.jit(jax.vmap(lambda a: jnp.mean(a, axis=0)))(per_w)
        total = torch.as_tensor(per_w[:, 0])
        for i in range(1, w):
            total = total + torch.as_tensor(per_w[:, i])
        np.testing.assert_array_equal(
            _bits(total * float(np.float32(1.0 / w))), _bits(want))


def test_tables_per_point_equal_one_point_calls():
    _, tcfg = _sims()
    _, rows, _, _, st = tpar._prepare_codesign(tcfg, [4, 8, 16], [4] * 3,
                                               [3, 4, 5], "cpu")
    draws = tpar._draws(trandom.prng_key(2, device="cpu"), 3, 1, 2, 6,
                        int(rows["coords"].shape[1]), 4, 0.5)
    cands = tpar._restart_positions(draws, rows, 4)[:, 0]  # [T, K, n, 4, 2]
    point = torch.arange(3)[:, None, None].expand(cands.shape[:3])
    got = tsel.placement_tables_from_lut_torch(
        cands, rows["hop_lut"], rows["edge_lut"], rows["router_mask"],
        rows["caps"], d_pad=st["d_pad"], db_per_hop=st["db_per_hop"],
        point=point)
    for t in range(3):
        want = tsel.placement_tables_from_lut_torch(
            cands[t], rows["hop_lut"][t], rows["edge_lut"][t],
            rows["router_mask"][t], rows["caps"][t], d_pad=st["d_pad"],
            db_per_hop=st["db_per_hop"])
        for k in ("src_hops", "gw_loss_db"):
            np.testing.assert_array_equal(_bits(got[k][t]), _bits(want[k]))


# ---------------------------------------------------------------------------
# The searches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["codesign_kw", "radix"])
def test_device_codesign_follows_the_reference(case):
    want, want_dec, want_prints = _reference(case)
    trail = []
    tsim.reset_engine_stats()
    got = _port(case, trail=trail)
    # One plain-loop run (one launch on the card) per generation for every
    # point at once, one search.
    assert backend.COUNTERS["loop_runs"] == _kw(case)["generations"]
    assert tsim.engine_stats()["search_dispatches"] == 1
    _same_search(got, want)
    # Every generation's decisions are the reference's.
    tr = {k: v.transpose(0, 1).numpy() for k, v in trail[0].items()}
    dec = chip_smoke.codesign_decisions(tr["s"], tr["threshold"], tr["u"],
                                        _temps(_kw(case)["generations"]))
    np.testing.assert_array_equal(dec["ib"], tr["ib"])
    np.testing.assert_array_equal(dec["accepted"], tr["accepted"])
    assert chip_smoke.pack_decisions(dec) \
        == chip_smoke.pack_decisions(want_dec)
    assert chip_smoke.first_parting(
        chip_smoke.pack_decisions(dec), chip_smoke.pack_decisions(want_dec),
        tr["s"], tr["threshold"], tr["u"]) is None
    # The archive replayed from the trail is the search's, insert by insert
    # the reference's.
    cap = _kw(case)["archive"]
    plain, flipped, partings = chip_smoke.replay_archive(
        chip_smoke.trail_inserts(tr["objs"], tr["cands"]), cap, 4,
        [p for row in want_prints for p in row],
        chip_smoke.device_archive_insert(cap))
    assert partings == []
    for k in ("obj", "pos", "topo", "island", "valid"):
        np.testing.assert_array_equal(plain[k], flipped[k])
    np.testing.assert_array_equal(flipped["sizes"],
                                  want["history"]["archive_size"].ravel())
    assert [(int(t), int(k)) for t, k, v in zip(
        plain["topo"], plain["island"], plain["valid"]) if v] == [
        (int(t), int(k)) for t, k, v in zip(
            got["archive"]["topology_index"], got["archive"]["island"],
            got["archive"]["valid"]) if v]


@pytest.mark.parametrize("case", ["codesign_kw", "radix"])
def test_host_codesign_follows_the_reference(case, monkeypatch):
    want, _, want_prints = _reference(case, "host")
    inserts, real = [], tpar._archive_insert_np

    def recorded(arch, *batch):
        inserts.append(batch[:4])
        return real(arch, *batch)

    monkeypatch.setattr(tpar, "_archive_insert_np", recorded)
    got = _port(case, "host")
    _same_search(got, want)
    # The replay of what the host search offered its archive is, insert by
    # insert, the reference's.
    cap = _kw(case)["archive"]
    plain, flipped, partings = chip_smoke.replay_archive(
        inserts, cap, 4, [p for row in want_prints for p in row],
        lambda arch, *b: real(arch, *b, cap))
    assert partings == []
    np.testing.assert_array_equal(flipped["sizes"],
                                  want["history"]["archive_size"].ravel())


def test_rescore_front_host_matches_the_front_and_the_reference():
    want, _, _ = _reference("codesign_kw")
    got = _port("codesign_kw")
    jcfg, tcfg = _sims()
    traces = list(_traces("codesign_kw"))
    rescored = tsim.rescore_front_host(
        got, [interop.trace_from_numpy(t, "cpu") for t in traces], tcfg,
        device="cpu")
    np.testing.assert_allclose(rescored, _objs(got), rtol=RTOL)
    np.testing.assert_allclose(
        rescored, jsim.rescore_front_host(want, traces, jcfg), rtol=RTOL)
    assert tpar.rescore_front_host({"front": []}, traces, tcfg,
                                   device="cpu").shape == (0, 3)


def test_decision_parting_reports_the_gap():
    """`chip_smoke.first_parting` names the first decision that differs and
    the relative gap of the values it compares."""
    s = np.array([[[[1.0, 0.9, 0.95], [1.0, 1.1, 1.2]],
                   [[1.0, 0.9999999, 1.5], [1.0, 1.0, 0.5]]]], np.float32)
    thr = np.full((1, 2, 2), 0.5, np.float32)
    u = np.full((1, 2, 2), 0.7, np.float32)
    dec = chip_smoke.pack_decisions(chip_smoke.codesign_decisions(
        s, thr, u, np.float32([0.05, 0.035])))
    assert dec["ib"] == ("10 12",)
    assert chip_smoke.first_parting(dec, dec, s, thr, u) is None
    other = dict(dec, ib=("10 02",))
    t, gen, k, kind, gap = chip_smoke.first_parting(other, dec, s, thr, u)
    assert (t, gen, k, kind) == (0, 1, 0, "argmin")
    assert gap == pytest.approx(1e-7, rel=0.5)


def test_archive_replay_finds_the_near_tie_flip():
    """Two placements one ulp apart in energy, 1.3e-6 apart in latency: the
    reference keeps both, this run's objectives (energy equal) let one
    dominate the other. The replay names that dominance test and its gap,
    and carries the reference's members on."""
    ref = np.array([[2179.2617, 19489.664, 44572884.0],
                    [2179.2588, 19489.664, 44572888.0]],
                   np.float32).reshape(1, 1, 1, 2, 3)
    run = ref.copy()
    run[0, 0, 0, 1, 2] = 44572884.0
    cands = np.array([[[1, 0], [2, 3]], [[1, 0], [1, 3]]]).reshape(
        1, 1, 1, 2, 2, 2)
    zero = torch.zeros(2, dtype=torch.long)
    want = tpar._archive_insert(
        tpar._empty_archive(4, 2, "cpu"), torch.as_tensor(ref.reshape(2, 3)),
        torch.as_tensor(cands.reshape(2, 2, 2)), zero, zero, capacity=4)
    assert int(want["valid"].sum()) == 2
    prints = [chip_smoke.archive_print(want["topo"], want["island"],
                                       want["pos"], want["valid"])]
    plain, flipped, partings = chip_smoke.replay_archive(
        chip_smoke.trail_inserts(run, cands), 4, 2, prints,
        chip_smoke.device_archive_insert(4))
    assert int(plain["valid"].sum()) == 1
    assert int(flipped["valid"].sum()) == 2
    (i, kind, gap), = partings
    assert (i, kind) == (0, "dominance test")
    assert gap == 0.0                  # the energies are equal in this run
    # The moved design's objectives stay within a float32 step of its own.
    np.testing.assert_allclose(sorted(flipped["obj"][flipped["valid"]]
                                      .tolist()),
                               sorted(run.reshape(2, 3).tolist()),
                               rtol=1e-6)


def _codesign_errors():
    return [
        (dict(gateway_positions=[None]), "not a co-design axis"),
        (dict(l_m=[0.01]), "knob_grids"),
        (dict(bogus=[1, 2]), "non-sweepable"),
        (dict(n_chiplets=[8, 8], gateways_per_chiplet=[2, 4]),
         "must be constant"),
        (dict(n_chiplets=[8, 16], mesh_radix=[4]), "share one length"),
        (dict(n_chiplets=[0]), "invalid topology grid"),
        (dict(gateways_per_chiplet=[6]), "default edge slots"),
        (dict(islands=3, knob_grids={"l_m": [0.01, 0.02]}), "islands=3"),
        (dict(knob_grids={"n_chiplets": [8, 16]}), "grid axes"),
        (dict(knob_grids={"speed": [1]}), "non-sweepable knob"),
        (dict(knob_grids={"l_m": [0.01], "buffer_sat": [0.5, 0.6]}),
         "share one length"),
        (dict(knob_grids={"l_m": 0.01}), "1-D grid"),
        (dict(islands=2.5), "islands must be an int"),
        (dict(islands=True), "islands must be an int"),
        (dict(islands=0), "islands must be >= 1"),
        (dict(engine="magic"), "unknown engine"),
        (dict(population=1), "population must be >= 2"),
        (dict(generations=0), "generations must be >= 1"),
        (dict(migrate_every=-1), "migrate_every"),
        (dict(archive=0), "archive must be >= 1"),
        ("hex", "derived-mesh"),
    ]


@pytest.mark.parametrize("kw,msg", _codesign_errors(),
                         ids=[m for _, m in _codesign_errors()])
def test_validation_matches_the_reference(kw, msg):
    jcfg, tcfg = _sims()
    if kw == "hex":
        from repro.core import topology as jtopo
        from repro_torch.core import topology as ttopo
        import dataclasses
        jcfg = dataclasses.replace(jcfg, cfg=jtopo.hex_config(2))
        tcfg = dataclasses.replace(tcfg, cfg=ttopo.hex_config(2))
        kw = dict(n_chiplets=[8])
    with pytest.raises(ValueError) as want:
        jsim.search_codesign(None, jcfg, **kw)
    with pytest.raises(ValueError) as got:
        tsim.search_codesign(None, tcfg, device="cpu", **kw)
    assert msg in str(want.value)
    assert str(got.value) == str(want.value)


def test_devices_dispatch_count_and_lazy_exports():
    _, tcfg = _sims()
    traces = [interop.trace_from_numpy(t, "cpu")
              for t in _traces("codesign_kw")]
    # Two devices shard the islands: the one-device search, described.
    sharded = tsim.search_codesign(traces, tcfg, devices=["cpu", "cpu"],
                                   **CODESIGN_KW)
    assert sharded.pop("sharding") == {"grid_points": 2, "pad_lanes": 0,
                                       "devices": 2, "processes": 1}
    one = tsim.search_codesign(traces, tcfg, device="cpu", **CODESIGN_KW)
    assert sharded["front"] == one["front"]
    np.testing.assert_array_equal(sharded["island_scores"],
                                  one["island_scores"])
    assert tsim.search_codesign is tpar.search_codesign
    assert tsim.rescore_front_host is tpar.rescore_front_host
    # A raising search is not counted; each search is one dispatch.
    tsim.reset_engine_stats()
    with pytest.raises(ValueError):
        tsim.search_codesign(traces, tcfg, population=1, device="cpu")
    assert tsim.engine_stats()["search_dispatches"] == 0
    kw = dict(CODESIGN_KW, generations=1)
    a = tsim.search_codesign(traces[0], tcfg, device="cpu", **kw)
    b = tpar.search_codesign(traces, tcfg, devices=["cpu"], **kw)
    assert tsim.engine_stats()["search_dispatches"] == 2
    assert a["workloads"] == 1 and b["workloads"] == 2
    # The memoized per-point rows can be dropped.
    assert tpar._codesign_topology.cache_info().currsize >= 1
    tpar.clear_codesign_caches()
    assert tpar._codesign_topology.cache_info().currsize == 0


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 10 gates are the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,engine,pin", [
    ("a", "device", "PARETO_WALK_REFERENCE"),
    ("a", "host", "PARETO_WALK_HOST_REFERENCE"),
    ("b", "device", "PARETO_DSE_REFERENCE")])
def test_chip_smoke_pins_are_the_reference(case, engine, pin):
    res, dec, prints = _reference(case, engine)
    want = chip_smoke.pareto_pin(res, dec, prints)
    assert getattr(chip_smoke, pin) == want
    objs = _objs(res)
    assert want["hypervolume"] == jpar.hypervolume(
        objs, tuple(2.0 * objs.max(axis=0)))
