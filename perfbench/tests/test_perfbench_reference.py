"""The plain reference held to `repro_torch` at small sizes on the CPU:
its selection tables, destination matrices, interval loop, co-design
objectives and flit model against the program's own (the program runs its
plain versions on CPU tensors)."""
import numpy as np
import pytest
import torch

from perfbench.reference import codesign as cref
from perfbench.reference import epoch as ref
from perfbench.reference import flit as fref
from perfbench.traffic.flit import arrivals
from perfbench.traffic.parsec import PARSEC, app_batch, stacked

TABLE1 = {"mesh_x": 4, "mesh_y": 4, "max_gateways_per_chiplet": 4,
          "memory_gateways": 2, "packet_flits": 8, "flit_bits": 32,
          "reconfig_interval_cycles": 1000000,
          "link_gbps_per_wavelength": 12.0, "noc_freq_ghz": 1.0,
          "router_buffer_flits": 4, "gateway_buffer_flits": 8}


@pytest.mark.parametrize("radix", [4, 5, 8])
def test_selection_columns_match_the_program(radix):
    from repro_torch.core.constants import NETWORK
    from repro_torch.core.selection import build_selection_tables

    rng = np.random.default_rng(radix)
    cells = [(x, y) for x in range(radix) for y in range(radix)]
    placements = [None] + [
        [cells[i] for i in rng.choice(len(cells), 4, replace=False)]
        for _ in range(4)]
    for pos in placements:
        cfg = NETWORK.with_topology(mesh_radix=radix)
        if pos is not None:
            cfg = cfg.with_placement(tuple(pos))
        want = build_selection_tables(cfg)
        mine = ref.default_positions(radix, radix, 4) if pos is None else pos
        src, loss = ref.selection_columns(radix, radix, mine)
        np.testing.assert_array_equal(src, want.src_hops)
        np.testing.assert_array_equal(loss, want.gw_loss_db)


@pytest.mark.parametrize("c", [4, 16, 64])
def test_parsec_destinations_match_the_program(c):
    from repro_torch.core.constants import NETWORK
    from repro_torch.core.traffic.dest import destination_matrix

    cfg = NETWORK.with_topology(n_chiplets=c)
    for app, prof in PARSEC.items():
        np.testing.assert_array_equal(
            ref.parsec_destinations(prof[3], c),
            destination_matrix(app, cfg))


def test_interval_loop_matches_sweep_batch():
    from repro_torch.core import simulator as S

    apps = ["blackscholes", "facesim", "canneal"]
    traces = app_batch(apps, 24, 4, 11, 0, "cpu")
    lm = np.linspace(0.004, 0.032, 5, dtype=np.float32)
    bs = np.linspace(0.5, 0.95, 5, dtype=np.float32)
    out = S.sweep_batch(traces, S.SimConfig(), device="cpu", l_m=lm,
                        buffer_sat=bs)
    arrs = stacked(traces)
    b = len(apps) * len(lm)
    tr = torch.arange(len(apps)).repeat_interleave(len(lm))
    src, loss = ref.selection_columns(4, 4, ref.default_positions(4, 4, 4))
    full = lambda v, dt=torch.float32: torch.full((b,), v, dtype=dt)  # noqa
    lanes = {"ext": arrs["ext"][tr], "intra": arrs["intra"][tr],
             "mem": arrs["mem"][tr], "t_mask": arrs["t_mask"][tr],
             "dest": arrs["dest"][tr],
             "l_m": torch.as_tensor(np.tile(lm, len(apps))),
             "buffer_sat": torch.as_tensor(np.tile(bs, len(apps))),
             "wavelengths": full(4.0), "max_gateways": full(4, torch.int32),
             "min_gateways": full(1, torch.int32),
             "src_hops": torch.as_tensor(src).expand(b, -1),
             "gw_loss_db": torch.as_tensor(loss).expand(b, -1),
             "n_chiplets": full(4.0)}
    want = ref.run_lanes(lanes, TABLE1)
    for k, v in want["records"].items():
        got = out["records"][k].reshape((b,) + v.shape[1:])
        assert torch.equal(got, v.to(got.dtype)), k
    for k, v in want["summary"].items():
        assert torch.equal(out["summary"][k].reshape(-1), v), k
    assert int((want["records"]["g"] != 4).sum()) > 0   # decisions ran


@pytest.mark.parametrize("dest", [True, False])
def test_codesign_objectives_match_the_search(dest):
    from repro_torch.core import pareto as P
    from repro_torch.core import simulator as S
    from repro_torch.core.constants import NETWORK

    from perfbench.drivers.search_codesign import history_faults

    apps = ["blackscholes", "canneal"]
    traces = app_batch(apps, 12, 16, 3, 0, "cpu", dest=dest)
    lm = [0.004, 0.012, 0.032]
    sim = S.SimConfig(cfg=NETWORK.with_topology(n_chiplets=16))
    res = P.search_codesign(traces, sim, device="cpu", seed=7,
                            n_chiplets=[4, 9, 16], islands=3, population=4,
                            generations=3, archive=16, migrate_every=2,
                            knob_grids={"l_m": lm})
    arch = res["archive"]
    rows = np.flatnonzero(arch["valid"])
    designs = [([4, 9, 16][arch["topology_index"][i]],
                np.asarray(arch["placements"][i]),
                {"l_m": float(np.float32(lm[arch["island"][i]]))})
               for i in rows]
    cfg = dict(TABLE1, router_pitch_mm=1.0, l_m=0.0152, buffer_sat=0.55,
               wavelengths=4, min_gateways=1)
    want = cref.objectives(stacked(traces), designs, cfg)
    np.testing.assert_allclose(arch["objectives"][rows], want, rtol=1e-6)
    assert len({tuple(map(tuple, d[1])) for d in designs}) > 1
    assert cref.dominated(arch["objectives"][rows]) == 0
    assert sum(cref.placement_faults(d[1], 4, 4) for d in designs) == 0
    assert history_faults(res) == 0
    best = res["history"]["best_scalar"]
    best[0, -1] = best[0, 0] + 1.0       # a rise, and a last best off
    assert history_faults(res) == 2


@pytest.mark.parametrize("islands", [1, 3, 8, 11])
def test_island_weights_match_the_program(islands):
    from repro_torch.core.pareto import island_weights

    np.testing.assert_array_equal(cref.island_weights(islands),
                                  island_weights(islands))


def test_activation_order_matches_the_controller():
    from repro_torch.core.constants import NETWORK
    from repro_torch.core.gateway_controller import activation_order

    rng = np.random.default_rng(0)
    for radix in (4, 6):
        cfg = NETWORK.with_topology(mesh_radix=radix)
        cells = np.array([(x, y) for x in range(radix)
                          for y in range(radix)])
        for _ in range(20):
            pos = cells[rng.choice(len(cells), 4, replace=False)]
            np.testing.assert_array_equal(
                cref.activation_order(pos, radix, radix),
                activation_order(pos, cfg))


def test_flit_topology_and_run_match_the_program():
    from repro_torch.core.constants import NETWORK
    from repro_torch.kernels.noc_step import ops as nops

    runs = [(r, g, w) for r in (4, 8) for g in (1, 2, 3, 4) for w in (2, 16)]
    mine, prog = [], []
    for r, g, w in runs:
        mine.append(fref.topology(r, g, w, TABLE1, 68))
        prog.append(nops.build_topology_padded(
            g, w, NETWORK.with_topology(mesh_radix=r), pad_to=68))
        for a, b in zip(mine[-1], prog[-1]):
            np.testing.assert_array_equal(a, b)
    arr = arrivals([0.6] * len(runs), [r * r for r, _, _ in runs], 96, 68,
                   8, 5, 0, "cpu")
    topo = [torch.as_tensor(np.stack([t[i] for t in mine]))
            for i in range(4)]
    want = fref.run(arr, *topo)
    got = nops.noc_run(arr, topo[0], topo[1], topo[2], valid_mask=topo[3])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(want[2].sum()) > 0.0
