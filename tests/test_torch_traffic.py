"""Traffic parity: specs, destination matrices, trace transforms and the
trace generators against the JAX reference.

Specs and destination matrices are copies and must match exactly; the
transforms must give the same arrays on the same reference-made traces.
The port's generator draws with the threefry twin, so from the same key it
gives the reference's trace: every synthetic family bit for bit; the PARSEC
family bit for bit except where libm's `sinf` (the reference) and float64
`sin` rounded (the port) part by an ulp in the phase, which moves at most
one ulp of a few elements (counted and bounded below: rtol 1e-6). It also
keeps the distributional contract: non-negative loads, a sample mean
within 5% of `expected_mean_ext_load`, and bit-identical output per key.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import traffic as jtr
from repro.core.constants import NETWORK as JNET
from repro_torch import interop
from repro_torch import random as trandom
from repro_torch.core import traffic as ttr
from repro_torch.core.constants import NETWORK as TNET


def _np_trace(tr):
    return {k: (v if k == "app" else np.asarray(v)) for k, v in tr.items()}


def _ref_trace(app="dedup", t=12, seed=0, dest=False):
    tr = jtr.generate(jtr.ParsecSpec(app, t), jax.random.PRNGKey(seed),
                      dest=dest)
    return _np_trace(tr)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_specs_are_a_faithful_copy():
    assert ttr.APP_NAMES == jtr.APP_NAMES
    assert ttr.PERMUTATION_PATTERNS == jtr.PERMUTATION_PATTERNS
    for app in jtr.APP_NAMES:
        assert dataclasses.asdict(ttr.PARSEC[app]) == \
            dataclasses.asdict(jtr.PARSEC[app])
    for js, ts in zip(jtr.ALL_SYNTHETIC_SPECS, ttr.ALL_SYNTHETIC_SPECS):
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
        assert js.name == ts.name
        for c in (4, 9, 16):
            assert ttr.expected_mean_ext_load(
                ts, TNET.with_topology(n_chiplets=c)) == \
                jtr.expected_mean_ext_load(js, JNET.with_topology(
                    n_chiplets=c))
    for pattern in jtr.PERMUTATION_PATTERNS:
        for c in (1, 2, 4, 5, 9, 16):
            _eq(ttr.permutation_destinations(pattern, c),
                jtr.permutation_destinations(pattern, c))
    with pytest.raises(ValueError):
        ttr.ParsecSpec(app="nope")
    with pytest.raises(ValueError):
        ttr.UniformSpec(mean_load=-1.0)
    assert ttr.as_spec("facesim", 7) == ttr.ParsecSpec("facesim", 7)


@pytest.mark.parametrize("c", [2, 4, 9])
def test_destination_matrices_exact(c):
    jcfg, tcfg = JNET.with_topology(n_chiplets=c), \
        TNET.with_topology(n_chiplets=c)
    specs = list(zip(jtr.ALL_SYNTHETIC_SPECS, ttr.ALL_SYNTHETIC_SPECS)) + [
        (jtr.ParsecSpec(a), ttr.ParsecSpec(a)) for a in jtr.APP_NAMES]
    for js, ts in specs:
        want = jtr.destination_matrix(js, jcfg)
        got = ttr.destination_matrix(ts, tcfg)
        assert got.dtype == want.dtype
        _eq(got, want)
        _eq(ttr.destination_matrix_torch(ts, tcfg, "cpu"), want)


def test_pad_slice_chunk_exact():
    ref = _ref_trace(t=10, dest=True)
    port = interop.trace_from_numpy(ref, "cpu")
    want = jtr.pad_trace(ref, 16)
    got = ttr.pad_trace(port, 16)
    for k in ("ext_load", "mem_load", "int_load", "t_mask", "dest"):
        _eq(got[k], want[k])
    assert ttr.trace_length(got) == jtr.trace_length(want) == 10
    want_s, got_s = jtr.slice_trace(ref, 3), ttr.slice_trace(port, 3)
    for k in ("ext_load", "int_load", "dest"):
        _eq(got_s[k], want_s[k])
    for size, pad in ((4, False), (4, True), (3, True)):
        wc = list(jtr.chunk_trace(ref, size, pad=pad))
        gc = list(ttr.chunk_trace(port, size, pad=pad))
        assert len(wc) == len(gc)
        for w, g in zip(wc, gc):
            assert set(w) == set(g)
            for k in w:
                if k != "app":
                    _eq(g[k], w[k])


def test_concat_traces_match():
    segs = [_ref_trace(a, t, s, dest=True)
            for a, t, s in (("blackscholes", 6, 1), ("facesim", 4, 2),
                            ("dedup", 5, 3))]
    segs[1] = jtr.pad_trace(segs[1], 7)
    segs = [_np_trace(s) for s in segs]
    want = jtr.concat_traces(segs)
    got = ttr.concat_traces([interop.trace_from_numpy(s, "cpu")
                             for s in segs])
    for k in ("ext_load", "mem_load", "int_load", "t_mask"):
        _eq(got[k], want[k])
    assert got["app"] == want["app"]
    # ext_frac and dest are load-weighted means: a sum over every interval
    # and chiplet, whose float32 summation order differs between XLA and
    # torch, hence 1e-6 rather than bit equality.
    np.testing.assert_allclose(got["ext_frac"].numpy(),
                               np.asarray(want["ext_frac"]), rtol=1e-6)
    np.testing.assert_allclose(got["dest"].numpy(), np.asarray(want["dest"]),
                               rtol=1e-6, atol=1e-7)


def test_validate_trace_rejects_what_the_reference_rejects():
    good = _ref_trace(t=4)
    bad_cases = [
        {k: v for k, v in good.items() if k != "mem_load"},
        dict(good, ext_load=-good["ext_load"]),
        dict(good, ext_load=good["ext_load"] * np.nan),
        dict(good, dest=np.ones((3, 3), np.float32)),
    ]
    for bad in bad_cases:
        with pytest.raises(ValueError):
            jtr.validate_trace(bad)
        with pytest.raises(ValueError):
            ttr.validate_trace(interop.trace_from_numpy(bad, "cpu"))
    with pytest.raises(TypeError):
        ttr.validate_trace([1, 2])
    with pytest.raises(ValueError):
        ttr.pad_trace(interop.trace_from_numpy(good, "cpu"), 2)


SPECS_FOR_CALIBRATION = [
    ttr.UniformSpec(mean_load=0.03, n_intervals=512),
    ttr.HotspotSpec(mean_load=0.03, n_intervals=512),
    ttr.PermutationSpec(pattern="transpose", mean_load=0.03,
                        n_intervals=512),
    ttr.PermutationSpec(pattern="tornado", mean_load=0.03, n_intervals=512),
    ttr.BurstySpec(mean_load=0.03, n_intervals=2048),
    ttr.ParsecSpec(app="blackscholes", n_intervals=2000),
    ttr.ParsecSpec(app="dedup", n_intervals=2000),
]


@pytest.mark.parametrize("spec", SPECS_FOR_CALIBRATION,
                         ids=lambda s: s.name)
def test_generator_contract(spec):
    """Non-negative, calibrated within 5% of the analytic mean, and
    reproducible per generator seed (64 chiplets keep the sample error of
    the per-chiplet imbalance and on/off chains well under the bound); an int seed is the key
    `prng_key(seed)`."""
    cfg = TNET.with_topology(n_chiplets=64)
    tr = ttr.generate(spec, 11, cfg, device="cpu")
    ext = tr["ext_load"]
    assert ext.dtype == torch.float32 and ext.shape == (spec.n_intervals, 64)
    for k in ("ext_load", "int_load", "mem_load"):
        assert bool(torch.all(tr[k] >= 0)) and bool(torch.isfinite(tr[k]).all())
    assert 0.0 < float(tr["ext_frac"]) <= 1.0
    want = ttr.expected_mean_ext_load(spec, cfg)
    got = float(ext.double().mean())
    assert abs(got - want) <= 0.05 * want, (got, want)
    again = ttr.generate(spec, trandom.prng_key(11, device="cpu"), cfg,
                         device="cpu")
    for k in ("ext_load", "int_load", "mem_load", "ext_frac"):
        assert torch.equal(tr[k], again[k])
    other = ttr.generate(spec, 12, cfg, device="cpu")
    assert not torch.equal(tr["ext_load"], other["ext_load"])


def test_generator_entry_points():
    traces = ttr.all_app_traces(8, seed=3, device="cpu", dest=True)
    assert list(traces) == ttr.APP_NAMES
    for app, tr in traces.items():
        assert tr["app"] == app and tr["ext_load"].shape == (8, 4)
        _eq(tr["dest"], jtr.destination_matrix(jtr.ParsecSpec(app)))
    again = ttr.all_app_traces(8, seed=3, device="cpu")
    assert torch.equal(again["dedup"]["ext_load"],
                       traces["dedup"]["ext_load"])
    one = ttr.generate_trace("canneal", 5, 0, device="cpu")
    assert one["ext_load"].shape == (5, 4)
    # Permutation self-pairs divert all their load to the local mesh.
    perm = ttr.generate(ttr.PermutationSpec("transpose", n_intervals=16), 0,
                        device="cpu")
    self_paired = ttr.permutation_destinations("transpose", 4) == np.arange(4)
    assert float(perm["ext_load"][:, self_paired].abs().sum()) == 0.0


# Every family at several keys and widths: (spec, chiplets).
FAMILY_CASES = [(ttr.ParsecSpec(app, 100), 4) for app in ttr.APP_NAMES] + [
    (ttr.ParsecSpec("dedup", 40), 16),
    (ttr.UniformSpec(n_intervals=64), 4),
    (ttr.UniformSpec(mean_load=0.03, cv=0.0, n_intervals=16), 4),
    (ttr.HotspotSpec(n_intervals=64), 4),
    (ttr.HotspotSpec(n_hotspots=3, n_intervals=40), 16),
    (ttr.HotspotSpec(n_hotspots=9, n_intervals=8), 9),
    (ttr.BurstySpec(n_intervals=64), 4),
    (ttr.BurstySpec(p_on=0.5, p_off=0.1, n_intervals=48), 16)] + [
    (ttr.PermutationSpec(p, n_intervals=64), c)
    for p in ttr.PERMUTATION_PATTERNS for c in (4, 9)] + [
    # Wide rows: XLA's vectorized row at 32 chiplets, its 32-wide window
    # tree past that (48 and 144 exercise the split pad).
    # LLVM's 4-lane row at 30-31 chiplets (a per-chiplet weight).
    (ttr.HotspotSpec(n_hotspots=3, n_intervals=6), 30),
    (ttr.HotspotSpec(n_hotspots=5, n_intervals=6), 31),
    (ttr.ParsecSpec("canneal", 6), 31),
    (ttr.UniformSpec(n_intervals=6), 32),
    (ttr.HotspotSpec(n_intervals=6), 32),
    (ttr.HotspotSpec(n_hotspots=3, n_intervals=6), 32),
    (ttr.BurstySpec(n_intervals=6), 32),
    (ttr.PermutationSpec("tornado", n_intervals=6), 32),
    (ttr.ParsecSpec("dedup", 6), 32),
    (ttr.UniformSpec(n_intervals=6), 48),
    (ttr.HotspotSpec(n_hotspots=5, n_intervals=6), 48),
    (ttr.PermutationSpec("transpose", n_intervals=6), 48),
    (ttr.BurstySpec(n_intervals=6), 64),
    (ttr.HotspotSpec(n_intervals=6), 64),
    (ttr.PermutationSpec("neighbor", n_intervals=6), 64),
    (ttr.UniformSpec(n_intervals=6), 128),
    (ttr.PermutationSpec("bit_complement", n_intervals=6), 128),
    (ttr.BurstySpec(n_intervals=6), 144),
    (ttr.HotspotSpec(n_hotspots=3, n_intervals=6), 144),
    (ttr.ParsecSpec("canneal", 6), 144),
    (ttr.UniformSpec(n_intervals=6), 256),
    (ttr.HotspotSpec(n_intervals=6), 256),
    (ttr.PermutationSpec("tornado", n_intervals=6), 256)]


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("spec,c", FAMILY_CASES,
                         ids=[f"{s.name}-c{c}" for s, c in FAMILY_CASES])
def test_generator_gives_the_reference_trace(spec, c):
    """The port's trace from a key equals the reference's from the same
    key (carried across with `interop.key_from_jax`): bitwise for every
    synthetic family and every destination matrix, `mem_load` included at
    every width (`random.xla_row_sum` sums the row in XLA's CPU order).
    PARSEC at rtol 1e-6: the phase's
    sin parts by an ulp now and then, and the products after it carry that
    on (at 4 chiplets, over the eight apps at these seeds, about 1% of the
    elements differ, by at most 3 ulps, 2.7e-7 relative); at most 5% of
    its `ext_load` and `int_load` elements may differ."""
    js = getattr(jtr, type(spec).__name__)(**dataclasses.asdict(spec))
    jcfg, tcfg = JNET.with_topology(n_chiplets=c), \
        TNET.with_topology(n_chiplets=c)
    for seed in (1, 2, 7, 11):
        jk = jax.random.PRNGKey(seed)
        want = _np_trace(jtr.generate(js, jk, jcfg, dest=True))
        got = ttr.generate(spec, interop.key_from_jax(jk, "cpu"), tcfg,
                           dest=True, device="cpu")
        assert got["app"] == want["app"]
        for k in ("ext_load", "mem_load", "int_load", "ext_frac", "dest"):
            a, b = got[k].numpy(), want[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            parsec = isinstance(spec, ttr.ParsecSpec) and k != "dest"
            if parsec:
                ulps = _ulps(a, b)
                assert ulps.max() <= 4, (k, int(ulps.max()))
                if parsec and k != "mem_load":
                    assert (ulps > 0).mean() <= 0.05, (k, (ulps > 0).mean())
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("c", [4, 32, 33, 100, 256])
def test_xla_row_sum_is_jitted_jnp_sum(c):
    """`random.xla_row_sum` gives a jitted `jnp.sum` over the last axis bit
    for bit: of a product (fused into the running sum up to 32 columns, a
    window tree past that) and of a plain array."""
    rng = np.random.default_rng(c)
    a = rng.lognormal(size=(40, c)).astype(np.float32)
    b = rng.uniform(0.5, 1.5, size=(40, c)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x, y: jax.numpy.sum(x * y, axis=1))(
        a, b))
    got = trandom.xla_row_sum(torch.as_tensor(a), torch.as_tensor(b))
    _eq(got, want)
    want = np.asarray(jax.jit(lambda x: jax.numpy.sum(x, axis=1))(a))
    _eq(trandom.xla_row_sum(torch.as_tensor(a)), want)


def test_figure_workloads_are_the_reference_benchmarks():
    """`figures.fig10_traces` / `fig11_traces` / `fig12_trace` draw what
    `benchmarks/fig10_lm_dse.py`, `fig11_main.py` and `fig12_adaptivity.py`
    draw (seeds 7, 1, 3), to within the PARSEC ulp note above."""
    from repro_torch import figures

    def close(got, want):
        for k in ("ext_load", "mem_load", "int_load"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=0, err_msg=k)

    want10 = jtr.all_app_traces(12, seed=7)
    for got, app in zip(figures.fig10_traces(12, device="cpu"),
                        jtr.APP_NAMES):
        close(got, want10[app])
    got11 = figures.fig11_traces(12, device="cpu")
    for app in jtr.APP_NAMES:
        close(got11[app], jtr.generate_trace(app, 12,
                                             jax.random.PRNGKey(1)))
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    want12 = jtr.concat_traces([jtr.generate_trace(a, 10, k) for a, k in
                                zip(figures.FIG12_SEQUENCE, keys)])
    close(figures.fig12_trace(10, device="cpu"), want12)


def test_generate_takes_keys_and_seeds_only():
    spec = ttr.UniformSpec(n_intervals=4)
    with pytest.raises(TypeError, match="key"):
        ttr.generate(spec, torch.Generator().manual_seed(1), device="cpu")
    with pytest.raises(ValueError, match="one threefry key"):
        ttr.generate(spec, trandom.split(trandom.prng_key(1, device="cpu")),
                     device="cpu")


@pytest.mark.parametrize("seed", [0, 5])
def test_wide_workload_sweep_matches_the_reference(seed):
    """`sweep_workload` over generated traces on wide rows (PROWAVES at 64,
    32, 64 and 48 chiplets, four synthetic specs of 24 intervals) gives the
    reference's records and summaries at 1e-6: the generated `mem_load`
    rows are the reference's bit for bit, so nothing parts the two."""
    from repro.core import simulator as jsim
    from repro_torch.core import simulator as tsim

    specs = [ttr.UniformSpec(n_intervals=24), ttr.HotspotSpec(n_intervals=24),
             ttr.BurstySpec(n_intervals=24),
             ttr.PermutationSpec("transpose", n_intervals=24)]
    specs_j = [getattr(jtr, type(s).__name__)(**dataclasses.asdict(s))
               for s in specs]
    grid = dict(n_chiplets=[64, 32, 64, 48])
    got = tsim.sweep_workload(
        specs, tsim.SimConfig().with_arch(tsim.Arch.PROWAVES), seed=seed,
        device="cpu", **grid)
    want = jsim.sweep_workload(
        specs_j, jsim.SimConfig().with_arch(jsim.Arch.PROWAVES), seed=seed,
        **grid)
    for part in ("records", "summary"):
        got_p = interop.records_to_numpy(got[part])
        assert set(got_p) == set(want[part])
        for k, w in want[part].items():
            w = np.asarray(w)
            if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(got_p[k], w, err_msg=k)
            else:
                np.testing.assert_allclose(got_p[k], w, rtol=1e-6, atol=1e-6,
                                           err_msg=k)
