"""The device placement search of the port against the JAX reference on the
CPU.

The twin draws the engine makes (`fold_in`, `bernoulli`, `gumbel`,
`randint`, a stable `top_k`) and XLA's float32 pow are bit for bit
`jax.random` / `lax.top_k` / XLA's, at the engine's shapes. The tensor
twins `activation_order_torch`, `placement_tables_torch`,
`placement_tables_from_lut_torch` and `gateway_access_loss_db_torch` are
bitwise the reference's jnp twins (run under `jax.jit`, as the reference's
search runs them) on `tests/test_search.py`'s five meshes and hex layouts,
and `_propose` is exact on the same pre-drawn inputs. The searches
(`search_placement(engine="device", device="cpu")`,
`search_placement_islands`) visit the reference device engine's
placements: best, incumbent and default placements and every accepted flag
equal, scores at rtol 1e-6 (the port scores through the plain loop of
`epoch_step`, the reference through its scan body).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gateway_controller as jgc
from repro.core import photonics as jph
from repro.core import search as jsearch
from repro.core import selection as jsel
from repro.core import simulator as jsim
from repro.core import topology as jtopo
from repro.core import traffic as jtr
from repro.core.constants import NETWORK as JNET
from repro.core.constants import PHOTONIC_POWER as JPOWER
from repro.core.constants import NetworkConfig as JCfg
from repro_torch import backend, interop
from repro_torch import random as trandom
from repro_torch.core import gateway_controller as tgc
from repro_torch.core import photonics as tph
from repro_torch.core import search as tsearch
from repro_torch.core import selection as tsel
from repro_torch.core import simulator as tsim
from repro_torch.core import topology as ttopo
from repro_torch.core.constants import NetworkConfig as TCfg

MESHES = [(4, 4, 4), (5, 5, 4), (6, 6, 4), (4, 4, 6), (3, 3, 2)]
HEXES = [(2, 4), (3, 6)]
SEEDS = [0, 1, 7, 2 ** 31 - 1]
# The engine's draw shapes at generations x (population - 1) on a 4 x 4
# mesh (16 routers).
T, N_PROP, R = 8, 11, 16
SCORE_RTOL = 1e-6


def _key(seed):
    return trandom.prng_key(seed, device="cpu"), jax.random.PRNGKey(seed)


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int64)


# ---------------------------------------------------------------------------
# Twin draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bitwise(seed):
    key, jkey = _key(seed)
    want = jax.vmap(lambda i: jax.random.fold_in(jkey, i))(jnp.arange(64))
    got = trandom.fold_in(key, torch.arange(64))
    np.testing.assert_array_equal(got.numpy(), _bits(want))
    np.testing.assert_array_equal(trandom.fold_in(key, 5).numpy(),
                                  _bits(jax.random.fold_in(jkey, 5)))


@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_gumbel_uniform_bitwise_at_the_engine_shapes(seed):
    key, jkey = _key(seed)
    ks, jks = trandom.split(key, 5), jax.random.split(jkey, 5)
    p = np.float32(0.25)
    np.testing.assert_array_equal(
        trandom.bernoulli(ks[0], p, (T, N_PROP)).numpy(),
        np.asarray(jax.jit(lambda k: jax.random.bernoulli(
            k, p, (T, N_PROP)))(jks[0])))
    for k, jk, shape in ((ks[1], jks[1], (T, N_PROP, R)),
                         (ks[3], jks[3], (T, N_PROP, 2, R))):
        want = jax.jit(lambda k: jax.random.gumbel(k, shape))(jk)
        got = trandom.gumbel(k, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(trandom.uniform(ks[4], (T,))),
        _bits(jax.random.uniform(jks[4], (T,))))


@pytest.mark.parametrize("span", [2, 3, 4, 16, 1000, 2 ** 20])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_bitwise(seed, span):
    key, jkey = _key(seed)
    shape = (T, N_PROP, 2)
    got = trandom.randint(key, shape, 0, span)
    want = jax.jit(lambda k: jax.random.randint(k, shape, 0, span))(jkey)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.min()) >= 0 and int(got.max()) < span


def test_batched_keys_draw_as_vmap_over_keys():
    keys = trandom.fold_in(trandom.prng_key(3, device="cpu"),
                           torch.arange(4))
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(3),
                                                  i))(jnp.arange(4))
    jks = jax.vmap(lambda k: jax.random.split(k, 5))(jkeys)
    ks = trandom.split(keys, 5)
    np.testing.assert_array_equal(ks.numpy(), _bits(jks))
    np.testing.assert_array_equal(
        _bits(trandom.gumbel(ks[:, 3], (T, N_PROP, 2, R))),
        _bits(jax.vmap(lambda k: jax.random.gumbel(
            k, (T, N_PROP, 2, R)))(jks[:, 3])))
    np.testing.assert_array_equal(
        trandom.randint(ks[:, 2], (T, N_PROP, 2), 0, 4).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, (T, N_PROP, 2), 0, 4))(jks[:, 2])))
    np.testing.assert_array_equal(
        trandom.bernoulli(ks[:, 0], 0.3, (T, N_PROP)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.bernoulli(
            k, np.float32(0.3), (T, N_PROP)))(jks[:, 0])))


def test_top_k_takes_lax_top_k_tie_order():
    """Ties (and blocked -inf routers) go to the lower index first."""
    rng = np.random.RandomState(4)
    x = rng.randint(0, 4, size=(T, N_PROP, R)).astype(np.float32)
    x[x == 3] = -np.inf
    x[0, 0] = -np.inf                       # every router blocked
    for k in (1, 4, R):
        v, i = trandom.top_k(torch.as_tensor(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cooling", [0.7, 0.5, 0.95, 0.99, 1.0])
def test_temperature_schedule_is_xlas_pow(cooling):
    """temperature * cooling ** gen as the reference's compiled code gives
    it (XLA's CPU pow, denormals flushed), over 300 generations."""
    gens = jnp.arange(300, dtype=jnp.int32)
    want = jax.jit(lambda t, c, g: t * c ** g.astype(jnp.float32))(
        jnp.float32(0.05), jnp.float32(cooling), gens)
    np.testing.assert_array_equal(
        _bits(tsearch._temperatures(0.05, cooling, 300)), _bits(want))


# ---------------------------------------------------------------------------
# Table and ordering twins
# ---------------------------------------------------------------------------

def _layouts():
    out = [(f"mesh {mx}x{my} g{g}",
            JCfg(mesh_x=mx, mesh_y=my, max_gateways_per_chiplet=g),
            TCfg(mesh_x=mx, mesh_y=my, max_gateways_per_chiplet=g))
           for mx, my, g in MESHES]
    out += [(f"hex {rings} g{g}",
             jtopo.hex_config(rings, base=JCfg(max_gateways_per_chiplet=g)),
             ttopo.hex_config(rings, base=TCfg(max_gateways_per_chiplet=g)))
            for rings, g in HEXES]
    return out


LAYOUTS = _layouts()


def _placements(tcfg, n, seed) -> np.ndarray:
    coords = ttopo.router_coords(tcfg)
    g = tcfg.max_gateways_per_chiplet
    rng = np.random.RandomState(seed)
    return np.stack([coords[rng.choice(len(coords), g, replace=False)]
                     for _ in range(n)]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_twins(jcfg):
    return (jax.jit(jax.vmap(lambda p: jsel.placement_tables_jnp(p, jcfg))),
            jax.jit(jax.vmap(lambda p: jgc.activation_order_jnp(p, jcfg))),
            jax.jit(jax.vmap(
                lambda p: jph.gateway_access_loss_db_jnp(p, jcfg))))


@pytest.mark.parametrize("name,jcfg,tcfg", LAYOUTS,
                         ids=[n for n, _, _ in LAYOUTS])
def test_placement_tables_and_access_loss_bitwise(name, jcfg, tcfg):
    pos = _placements(tcfg, 300, seed=len(name))
    tables, _, loss = _jax_twins(jcfg)
    want = tables(pos)
    got = tsel.placement_tables_torch(torch.as_tensor(pos), tcfg)
    for k in ("src_hops", "gw_loss_db"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=f"{name} {k}")
    np.testing.assert_array_equal(
        _bits(tph.gateway_access_loss_db_torch(torch.as_tensor(pos), tcfg)),
        _bits(loss(pos)))
    # Leading axes batch.
    two = tsel.placement_tables_torch(torch.as_tensor(pos[:6]).reshape(
        2, 3, *pos.shape[1:]), tcfg)
    np.testing.assert_array_equal(two["src_hops"].reshape(6, -1).numpy(),
                                  got["src_hops"][:6].numpy())


@pytest.mark.parametrize("name,jcfg,tcfg", LAYOUTS,
                         ids=[n for n, _, _ in LAYOUTS])
def test_activation_order_exact(name, jcfg, tcfg):
    pos = _placements(tcfg, 300, seed=3 * len(name))
    got = tgc.activation_order_torch(torch.as_tensor(pos), tcfg).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jax_twins(jcfg)[1](pos)))
    for p, order in zip(pos[:40], got):
        np.testing.assert_array_equal(order, tgc.activation_order(p, tcfg))


def test_placement_tables_from_lut_bitwise_padded():
    """Meshes of radix 3-6 padded to one LUT box, as the co-design search
    carries them (garbage in the padded router rows, masked)."""
    radices, g = (3, 4, 5, 6), 4
    tcfgs = [TCfg().with_topology(mesh_radix=r) for r in radices]
    r_max, box = 36, (6, 6)
    d_pad = max(ttopo.max_hops(c) for c in tcfgs) + 1
    db_per_hop = TCfg().router_pitch_mm * JPOWER.waveguide_db_per_mm
    jfn = jax.jit(jax.vmap(
        lambda p, h, e, m, c: jsel.placement_tables_from_lut_jnp(
            p, h, e, m, c, d_pad=d_pad, db_per_hop=db_per_hop),
        in_axes=(0, None, None, None, None)))
    rng = np.random.RandomState(2)
    for c in tcfgs:
        r_t = c.routers_per_chiplet
        hop = rng.randint(0, d_pad + 1, (r_max,) + box).astype(np.int32)
        hop[:r_t] = d_pad
        hop[:r_t, :c.mesh_x, :c.mesh_y] = ttopo.hop_lut(c)
        edge = np.zeros(box, np.int32)
        edge[:c.mesh_x, :c.mesh_y] = ttopo.edge_lut(c)
        mask = np.zeros(r_max, np.float32)
        mask[:r_t] = 1.0
        caps = np.asarray([-(-r_t // lv) for lv in range(1, g + 1)],
                          np.int32)
        pos = _placements(c, 200, seed=c.mesh_x)
        want = jfn(pos, hop, edge, mask, caps)
        got = tsel.placement_tables_from_lut_torch(
            torch.as_tensor(pos), hop, edge, mask, caps, d_pad=d_pad,
            db_per_hop=db_per_hop)
        for k in ("src_hops", "gw_loss_db"):
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                          err_msg=f"radix {c.mesh_x} {k}")


@pytest.mark.parametrize("blocked", [(), ((1, 0), (2, 2), (3, 3))],
                         ids=["free", "blocked"])
@pytest.mark.parametrize("moves", [1, 2])
def test_propose_exact_on_the_same_draws(moves, blocked):
    cfg_j, cfg_t = JNET, TCfg()
    n, g = 64, cfg_t.max_gateways_per_chiplet
    coords = ttopo.router_coords(cfg_t).astype(np.int32)
    mask = np.zeros(R, np.float32)
    for x, y in blocked:
        mask[x * cfg_t.mesh_y + y] = 1.0
    rng = np.random.RandomState(moves)
    free = [i for i in range(R) if not mask[i]]
    parent = coords[rng.choice(free, g, replace=False)]
    restart = rng.rand(n) < 0.3
    restart_pos = np.stack([coords[rng.choice(free, g, replace=False)]
                            for _ in range(n)])
    move_i = rng.randint(0, g, (n, 2)).astype(np.int32)
    move_gum = rng.gumbel(size=(n, 2, R)).astype(np.float32)
    want = jax.jit(jax.vmap(lambda r, rp, mi, mg: jsearch._propose(
        jnp.asarray(parent), r, rp, mi, mg, jnp.int32(moves),
        jsearch._mesh_coords(cfg_j), jnp.asarray(mask), cfg_j)))(
            restart, restart_pos, move_i, move_gum)
    t = torch.as_tensor
    got = tsearch._propose(
        t(parent).long()[None].expand(n, g, 2), t(restart),
        t(restart_pos).long(), t(move_i).long(), t(move_gum), moves,
        tsearch._mesh_coords(cfg_t, "cpu"), t(mask > 0.5), cfg_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not {tuple(p) for c in got.numpy().tolist() for p in c} \
        & set(blocked)


# ---------------------------------------------------------------------------
# The searches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _trace(app="dedup", t=12, seed=0, dest=False):
    tr = jtr.generate(jtr.ParsecSpec(app, t), jax.random.PRNGKey(seed),
                      JNET, dest=dest)
    return {k: (v if k == "app" else np.asarray(v)) for k, v in tr.items()}


def _history_matches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["generation"] == w["generation"]
        assert g["accepted"] == w["accepted"], (g, w)
        for key in ("parent_score", "best_candidate_score", "best_score",
                    "latency", "power_mw", "energy"):
            np.testing.assert_allclose(g[key], w[key], rtol=SCORE_RTOL,
                                       err_msg=key)


SEARCHES = {
    "fixture": (dict(), dict(generations=4, population=6, seed=1)),
    "init+blocked": (dict(), dict(
        generations=4, population=6, seed=2,
        init=((1, 1), (2, 2), (1, 2), (2, 1)),
        blocked_positions=[(1, 0), (3, 1), (0, 0)])),
    "dest": (dict(seed=4, dest=True), dict(generations=4, population=6,
                                           seed=1)),
    "energy": (dict(), dict(generations=5, population=6, seed=3,
                            objective="energy")),
}


@pytest.mark.parametrize("case", list(SEARCHES))
def test_device_search_follows_the_reference(case):
    trace_kw, kw = SEARCHES[case]
    tr = _trace(**trace_kw)
    want = jsim.search_placement(tr, jsim.SimConfig(), **kw)
    tsim.reset_engine_stats()
    got = tsim.search_placement(interop.trace_from_numpy(tr, "cpu"),
                                tsim.SimConfig(), device="cpu", **kw)
    # One plain-loop run (one launch on the card) per generation, one
    # search.
    assert backend.COUNTERS["loop_runs"] == kw["generations"]
    assert tsim.engine_stats()["search_dispatches"] == 1
    assert set(got) == set(want)
    for key in ("best_placement", "incumbent_placement", "default_placement",
                "objective", "generations", "population", "engine"):
        assert got[key] == want[key], key
    for key in ("best_score", "default_score"):
        np.testing.assert_allclose(got[key], want[key], rtol=SCORE_RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(got["improvement_frac"],
                               want["improvement_frac"], rtol=1e-4,
                               atol=1e-6)
    for key, v in want["best_summary"].items():
        np.testing.assert_allclose(got["best_summary"][key], v,
                                   rtol=SCORE_RTOL, err_msg=key)
    _history_matches(got["history"], want["history"])
    blocked = set(map(tuple, kw.get("blocked_positions", ())))
    assert not blocked & set(got["best_placement"])


def test_island_search_follows_the_reference():
    tr = _trace()
    kw = dict(generations=4, population=6, seed=1,
              l_m=[0.008, 0.012, 0.02])
    want = jsim.search_placement_islands(tr, jsim.SimConfig(), **kw)
    tsim.reset_engine_stats()
    got = tsim.search_placement_islands(
        interop.trace_from_numpy(tr, "cpu"), tsim.SimConfig(), device="cpu",
        **kw)
    # Every island's candidates ride one run a generation.
    assert backend.COUNTERS["loop_runs"] == kw["generations"]
    assert tsim.engine_stats()["search_dispatches"] == 1
    assert set(got) == set(want)
    for key in ("best_placement", "best_island", "default_placement",
                "island_best_placements", "island_incumbents", "islands",
                "objective", "generations", "population", "engine"):
        assert got[key] == want[key], key
    for key in ("island_best_scores", "island_default_scores"):
        assert got[key].dtype == np.asarray(want[key]).dtype
        np.testing.assert_allclose(got[key], want[key], rtol=SCORE_RTOL,
                                   err_msg=key)
    assert set(got["history"]) == set(want["history"])
    for key, w in want["history"].items():
        assert got["history"][key].shape == (3, kw["generations"])
        if key in ("generation", "accepted"):
            np.testing.assert_array_equal(got["history"][key], w)
        else:
            np.testing.assert_allclose(got["history"][key], w,
                                       rtol=SCORE_RTOL, err_msg=key)
    np.testing.assert_array_equal(got["island_overrides"]["l_m"],
                                  want["island_overrides"]["l_m"])


def test_island_search_is_its_chains():
    """Island k equals a one-chain search from key fold_in(seed, k) with
    the island's knobs: checked on its best placement and score."""
    tr = interop.trace_from_numpy(_trace(), "cpu")
    sim = tsim.SimConfig()
    out = tsim.search_placement_islands(tr, sim, islands=2, generations=3,
                                        population=4, seed=5, device="cpu")
    assert out["island_best_placements"][0] != () and out["islands"] == 2
    key = trandom.fold_in(trandom.prng_key(5, device="cpu"), 1)
    host = tsearch._run(
        tr, sim, key[None], tsearch._prepare_search(sim, None, None, "cpu"),
        None, objective="inter_latency", generations=3, population=4,
        temperature=0.05, cooling=0.7, restart_frac=0.25)
    assert tsearch._as_placement(host["best_placement"][0]) \
        == out["island_best_placements"][1]
    np.testing.assert_allclose(host["best_score"][0],
                               out["island_best_scores"][1], rtol=1e-6)


def test_search_validation_matches_the_reference():
    tr = _trace()
    ttr = interop.trace_from_numpy(tr, "cpu")
    cases = [
        (dict(population=1), "population"),
        (dict(generations=0), "generations"),
        (dict(objective="speed"), "unknown placement objective"),
        (dict(init=((1, 0), (2, 3), (0, 2), (3, 1)),
              blocked_positions=[(1, 0)]), "repair it first"),
        (dict(blocked_positions=[(x, y) for x in range(4)
                                 for y in range(4)][:13]),
         "allowed positions"),
        (dict(blocked_positions=[(7, 7)]), "outside"),
        (dict(init=((1, 0), (2, 3))), "init places"),
    ]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            jsim.search_placement(tr, jsim.SimConfig(), **kw)
        with pytest.raises(ValueError, match=msg):
            tsim.search_placement(ttr, tsim.SimConfig(), device="cpu", **kw)
    island_cases = [
        (dict(islands=2.0), "islands must be an int"),
        (dict(islands=True), "islands must be an int"),
        (dict(islands=0), "islands must be >= 1"),
        (dict(islands=3, l_m=[0.01, 0.02]), "length islands=3"),
        (dict(l_m=[0.01, 0.02], buffer_sat=[0.5]), "share one length"),
        (dict(n_chiplets=[4, 8]), "non-sweepable"),
        (dict(l_m=0.01), "1-D grid"),
    ]
    for kw, msg in island_cases:
        with pytest.raises(ValueError, match=msg):
            jsim.search_placement_islands(tr, jsim.SimConfig(), **kw)
        with pytest.raises(ValueError, match=msg):
            tsim.search_placement_islands(ttr, tsim.SimConfig(),
                                          device="cpu", **kw)
        # The sharded path validates alike.
        with pytest.raises(ValueError, match=msg):
            tsim.search_placement_islands(ttr, tsim.SimConfig(),
                                          devices=["cpu", "cpu"], **kw)
    # A device the sharded path cannot reach raises; nothing falls back.
    with pytest.raises((RuntimeError, AssertionError)):
        tsim.search_placement_islands(ttr, tsim.SimConfig(), islands=2,
                                      generations=1, population=2,
                                      devices=["cpu", "cuda:7"])
    # A raising search is not counted.
    tsim.reset_engine_stats()
    with pytest.raises(ValueError):
        tsim.search_placement(ttr, tsim.SimConfig(), population=1,
                              device="cpu")
    assert tsim.engine_stats()["search_dispatches"] == 0


def test_search_entry_points_and_dispatch_count():
    ttr = interop.trace_from_numpy(_trace(), "cpu")
    sim = tsim.SimConfig()
    assert tsim.search_placement_islands is tsearch.search_placement_islands
    assert tsim.search_placement_device is tsearch.search_placement_device
    with pytest.raises(AttributeError):
        tsim.search_placement_nowhere
    tsim.reset_engine_stats()
    a = tsim.search_placement(ttr, sim, generations=2, population=3,
                              seed=4, device="cpu")
    b = tsearch.search_placement_device(ttr, sim, generations=2,
                                        population=3, seed=4, device="cpu")
    assert a == b
    tsim.search_placement_islands(ttr, sim, islands=2, generations=2,
                                  population=3, device="cpu",
                                  devices=["cpu"])
    assert tsim.engine_stats()["search_dispatches"] == 3
    # The search's device tables are memoized and can be dropped.
    assert ttopo._lut_tensors.cache_info().currsize >= 1
    tsearch.clear_search_caches()
    assert ttopo._lut_tensors.cache_info().currsize == 0
    assert tsim.search_placement(ttr, sim, generations=2, population=3,
                                 seed=4, device="cpu") == a
