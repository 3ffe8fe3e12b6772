"""Geometry parity: the port's topology and selection tables against the
JAX reference, bit for bit.

Every design-time table (router coordinates, hop matrices and LUTs, edge
distances, centrality, default placements, activation orders, access loss,
the §3.4 selection tables and their tensor views) must equal the
reference's exactly on mesh radix 2-8 and on a hexagonal layout — or both
packages must raise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import constants as jconst
from repro.core import gateway_controller as jgc
from repro.core import photonics as jph
from repro.core import selection as jsel
from repro.core import topology as jtopo
from repro_torch.core import constants as tconst
from repro_torch.core import gateway_controller as tgc
from repro_torch.core import photonics as tph
from repro_torch.core import selection as tsel
from repro_torch.core import topology as ttopo

CASES = [("mesh", r) for r in range(2, 9)] + [("hex", 2)]


def _configs(kind, radix, **kw):
    if kind == "hex":
        return (jtopo.hex_config(radix, **kw), ttopo.hex_config(radix, **kw))
    return (jconst.NETWORK.with_topology(mesh_radix=radix)
            if not kw else dataclasses.replace(
                jconst.NETWORK.with_topology(mesh_radix=radix), **kw),
            tconst.NETWORK.with_topology(mesh_radix=radix)
            if not kw else dataclasses.replace(
                tconst.NETWORK.with_topology(mesh_radix=radix), **kw))


def _same_or_both_raise(fn_ref, fn_port):
    try:
        want = fn_ref()
    except ValueError as e_ref:
        with pytest.raises(ValueError):
            fn_port()
        return None, str(e_ref)
    got = fn_port()
    return (want, got), None


def test_constants_are_a_faithful_copy():
    assert dataclasses.asdict(tconst.NETWORK) == \
        dataclasses.asdict(jconst.NETWORK)
    assert dataclasses.asdict(tconst.PHOTONIC_POWER) == \
        dataclasses.asdict(jconst.PHOTONIC_POWER)
    for name in ("RESIPI_WAVELENGTHS", "PROWAVES_MAX_WAVELENGTHS",
                 "PROWAVES_MIN_WAVELENGTHS", "AWGR_WAVELENGTHS",
                 "PAPER_L_M"):
        assert getattr(tconst, name) == getattr(jconst, name)
    assert not hasattr(tconst, "TPUv5e")
    cfg = tconst.NETWORK.with_placement([(0, 1), (3, 2), (1, 3), (2, 0)])
    assert cfg.gateway_positions == ((0, 1), (3, 2), (1, 3), (2, 0))
    assert tconst.NETWORK.total_gateways == 18


@pytest.mark.parametrize("kind,radix", CASES)
def test_topology_tables_bit_exact(kind, radix):
    jcfg, tcfg = _configs(kind, radix)
    for fn in ("router_coords", "router_index_lut", "hop_matrix", "hop_lut",
               "edge_distance", "edge_lut", "centrality_int",
               "centrality_lut"):
        want = getattr(jtopo, fn)(jcfg)
        got = getattr(ttopo, fn)(tcfg)
        assert got.dtype == want.dtype, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)
    for fn in ("mean_hops", "max_hops", "feed_width", "centrality_bound",
               "lut_shape"):
        assert getattr(ttopo, fn)(tcfg) == getattr(jtopo, fn)(jcfg), fn


@pytest.mark.parametrize("kind,radix", CASES)
def test_selection_tables_bit_exact_or_both_raise(kind, radix):
    jcfg, tcfg = _configs(kind, radix)
    pair, err = _same_or_both_raise(
        lambda: jsel.build_selection_tables(jcfg),
        lambda: tsel.build_selection_tables(tcfg))
    if pair is None:
        assert "gateway" in err or "layout" in err
        return
    want, got = pair
    for f in ("src_map", "dst_map", "src_hops", "dst_hops", "gw_loss_db",
              "gw_pos"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    tj = jsel.selection_tables_jax(jcfg)
    tt = tsel.selection_tables_torch(tcfg, "cpu")
    assert tsel.selection_tables_torch(tcfg, "cpu") is tt     # memoized
    assert set(tt) == set(tj)
    for k in tj:
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(tj[k]))
    g = torch.arange(0, tcfg.max_gateways_per_chiplet + 2, dtype=torch.int32)
    np.testing.assert_array_equal(
        tsel.mean_access_hops(tt, g).numpy(),
        np.asarray(jsel.mean_access_hops(tj, g.numpy())))


@pytest.mark.parametrize("kind,radix", CASES)
def test_placements_and_activation_orders_bit_exact(kind, radix):
    jcfg, tcfg = _configs(kind, radix)
    pair, _ = _same_or_both_raise(
        lambda: jsel.resolve_gateway_positions(jcfg),
        lambda: tsel.resolve_gateway_positions(tcfg))
    if pair is not None:
        want, got = pair
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tgc.activation_order(got, tcfg), jgc.activation_order(want, jcfg))
        np.testing.assert_array_equal(
            tph.gateway_access_loss_db(got, tcfg),
            jph.gateway_access_loss_db(want, jcfg))
    # Seeded random placements on the layout's routers (interior ones
    # included, so the access-loss column is non-zero).
    rng = np.random.RandomState(radix)
    routers = jtopo.router_coords(jcfg)
    for _ in range(3):
        n_gw = int(min(len(routers), rng.randint(1, 6)))
        pos = routers[rng.choice(len(routers), n_gw, replace=False)]
        np.testing.assert_array_equal(
            tgc.activation_order(pos, tcfg), jgc.activation_order(pos, jcfg))
        np.testing.assert_array_equal(
            tph.gateway_access_loss_db(pos, tcfg),
            jph.gateway_access_loss_db(pos, jcfg))
        placed = (dataclasses.replace(jcfg, gateway_positions=tuple(
                      map(tuple, pos)), max_gateways_per_chiplet=n_gw),
                  dataclasses.replace(tcfg, gateway_positions=tuple(
                      map(tuple, pos)), max_gateways_per_chiplet=n_gw))
        want = jsel.build_selection_tables(placed[0])
        got = tsel.build_selection_tables(placed[1])
        for f in ("src_map", "src_hops", "gw_loss_db", "gw_pos"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("bad", [((0, 0), (0, 0)), ((9, 9), (0, 1)),
                                 ((-1, 0), (1, 1))])
def test_invalid_placements_raise_in_both(bad):
    jcfg = dataclasses.replace(jconst.NETWORK, gateway_positions=bad,
                               max_gateways_per_chiplet=2)
    tcfg = dataclasses.replace(tconst.NETWORK, gateway_positions=bad,
                               max_gateways_per_chiplet=2)
    with pytest.raises(ValueError):
        jsel.build_selection_tables(jcfg)
    with pytest.raises(ValueError):
        tsel.build_selection_tables(tcfg)
