"""The topology DSE cell (`c256_topology_dse`) at small sizes on the CPU:
`correct` on the program as it is, false with the control (the reference
in bfloat16) and with each fault of `topology_faults` planted under the
timed path; the plain reference against `sweep_topology_batch` lane for
lane; the cell's work at its full shape; its traced run's new metrics."""
import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.checks import scaled_error
from perfbench.drivers.sweep_topology_batch import cell_work, network_config
from perfbench.reference import epoch as ref
from perfbench.reference import topology as tref
from perfbench.tests.topology_faults import FAULTS, plant
from perfbench.traffic.parsec import app_batch, stacked

CELL = "c256_topology_dse"
SMALL = {"n_chiplets": [4, 9, 16], "gateways_per_chiplet": [1, 2, 3, 4],
         "apps": ["blackscholes", "canneal", "dedup"], "intervals": 12,
         "batches": 2}


def run(monkeypatch, *, patch=None, trace=False) -> dict:
    real = harness.load_config
    monkeypatch.setattr(harness, "load_config", lambda bench, name: dict(
        real(bench, name), **({"n_chiplets": 16}
                              if name == "resipi-c256-topo" else {})))
    return harness.run_cell(CELL, 20261018, 0.3, trace, device="cpu",
                            overrides=SMALL, patch=patch)


def test_clean_run_is_correct(monkeypatch):
    out = run(monkeypatch)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out["checks"]) == ["int_mismatch", "record_err",
                                   "summary_err", "padding_leak"]
    assert out["checks"]["padding_leak"]["value"] == 0.0


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_caught(monkeypatch, fault):
    undo = []
    out = run(monkeypatch, patch=lambda drv: undo.append(plant(fault, drv)))
    undo[0]()
    assert not out["correct"], (fault, out["checks"])
    if fault == "padding_leak":
        assert out["checks"]["padding_leak"]["value"] > 0


def test_control_fails(monkeypatch):
    drivers = []
    out = run(monkeypatch, patch=drivers.append)
    assert out["correct"]
    control = drivers[0].readings(torch.bfloat16)
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    assert any(control[k] > limits[k] for k in limits), control
    assert control["padding_leak"] == 0


@pytest.mark.parametrize("dest", [True, False], ids=["dest", "uniform"])
def test_reference_matches_sweep_topology_batch(dest):
    from repro_torch.core import simulator as S

    config = dict(harness.load_config(harness.load_benchmark(),
                                      "resipi-c256-topo"), n_chiplets=16)
    apps = SMALL["apps"]
    traces = app_batch(apps, 24, 16, 13, 0, "cpu", dest=dest)
    cs = [c for c in (4, 9, 16) for _ in range(4)]
    gs = [g for _ in range(3) for g in (1, 2, 3, 4)]
    sim = S.SimConfig(cfg=network_config(config)).with_arch(S.Arch.RESIPI)
    out = S.sweep_topology_batch(traces, sim, device="cpu", n_chiplets=cs,
                                 gateways_per_chiplet=gs)
    n, k = len(apps), len(cs)
    want = tref.run_topology(stacked(traces), np.repeat(np.arange(n), k),
                             np.tile(cs, n), np.tile(gs, n), config, 16)
    for key, w in want["records"].items():
        got = out["records"][key].flatten(0, 1)
        if key in ref.RECORD_INTS:
            assert torch.equal(got, w), key
        else:
            assert scaled_error(got, w) <= 1e-6, key
    for key, w in want["summary"].items():
        assert scaled_error(out["summary"][key].reshape(-1), w) <= 1e-6, key
    g = want["records"]["g"]
    assert int((g[:, 1:] != g[:, :1]).sum()) > 0        # decisions ran


def test_work_at_the_cell_shape():
    """224 lanes x 100 intervals at 16-256 real chiplets padded to 256, 56
    destination matrices: 1.635 GFLOP, bound by operations (PERF.md's
    kernel table, phase 7's DSE)."""
    cell = harness.load_cell(CELL)
    lane_intervals, bound = cell_work(cell)
    assert lane_intervals == 224 * 100
    assert bound * 1e3 == pytest.approx(0.0244, abs=5e-5)
    assert bound == pytest.approx(1.635e9 / 67e12, rel=5e-4)


def test_a_traced_run_and_the_topology_readers(monkeypatch):
    """The cell's traced run reports the program's span and counter
    metrics it is listed for; the readers of the topology stages' self
    time and of the padded tables' builds (not yet entries of
    BENCHMARK.json, PERF.md §7) read the same calls."""
    drivers = []
    out = run(monkeypatch, patch=drivers.append, trace=True)
    assert out["correct"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert got["host_ms.entry.epoch"] > 0.0
    assert got["host_ms.tables.epoch"] > 0.0
    assert got["rebuilds_per_call.epoch"] == 0.0
    assert got["host_reads_per_call.epoch"] == 0.0   # no card here
    drv = drivers[0]
    before = drv.counters()
    calls = [harness.Call(0.0, 1.0, drv.call(i)) for i in range(3)]
    ctx = harness.Context(CELL, 1.0, calls, 1.0, before, drv.counters())
    tables = harness.metric_reader("host_ms.tables.epoch")(ctx)
    topo = harness.metric_reader("host_ms.topology.epoch")(ctx)
    assert 0.0 < topo <= tables
    assert harness.metric_reader("table_builds_per_call.topology")(ctx) \
        == 0.0


def test_a_program_without_the_counter_reports_no_builds():
    parent = {"selection_table_builds": 1, "spans": {}}
    ctx = harness.Context(CELL, 1.0, [harness.Call(0.0, 1.0, {})], 1.0,
                          parent, dict(parent))
    read = harness.metric_reader("table_builds_per_call.topology")
    assert read(ctx) is None
    assert harness.metric_reader("host_ms.topology.epoch")(ctx) == 0.0
