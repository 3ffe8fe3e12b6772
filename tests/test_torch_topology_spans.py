"""The padded topology entry points' span and the padded tables' build
counter: `sweep_topology`, `sweep_topology_batch` and `shard_sweep` open
the entry span `sweep_topology` once a call, around the five `topology.*`
input stages; `engine_stats()["padded_table_builds"]` counts each miss of
the padded tables' device-view cache and `reset_engine_stats()` zeroes
it. On the card (marker `cuda`): the benchmark's `c256_topology_dse` cell
at its full size, every lane against the plain reference and each planted
fault caught. This file imports no JAX."""
import pytest
import torch

from repro_torch import backend
from repro_torch.core import selection
from repro_torch.core import simulator as tsim
from repro_torch.core import traffic

ENTRY, TABLES = backend.LAYER_ENTRY, backend.LAYER_TABLES
STAGES = ("prepare", "trace_arrays", "lanes", "dest_pairs", "initial_state")
GRID = {"n_chiplets": [4, 9, 16, 16], "gateways_per_chiplet": [4, 2, 1, 3]}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `python -m pytest -m cuda "
                    "tests/test_torch_topology_spans.py` on a machine with "
                    "a card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_counters():
    tsim.reset_engine_stats()
    yield
    tsim.reset_engine_stats()


def _sim():
    return tsim.SimConfig().with_arch(tsim.Arch.RESIPI)


def _traces(n: int = 2) -> list:
    cfg16 = _sim().cfg.with_topology(n_chiplets=16)
    return [traffic.generate(traffic.ParsecSpec(app, 6), i, cfg16,
                             dest=True, device="cpu")
            for i, app in enumerate(("dedup", "canneal")[:n])]


def _counts() -> dict:
    return {k: (v["layer"], v["n"])
            for k, v in tsim.engine_stats()["spans"].items()}


@pytest.mark.parametrize("entry", ["sweep_topology", "sweep_topology_batch",
                                   "shard_sweep", "sharded_batch"])
def test_each_padded_entry_opens_sweep_topology_once(entry):
    traces = _traces()
    if entry == "sweep_topology":
        tsim.sweep_topology(traces[0], _sim(), device="cpu", **GRID)
    elif entry == "sweep_topology_batch":
        tsim.sweep_topology_batch(traces, _sim(), device="cpu", **GRID)
    elif entry == "shard_sweep":
        tsim.shard_sweep(traces, _sim(), device="cpu", **GRID)
    else:   # two devices: sweep_topology_batch hands over to shard_sweep
        tsim.sweep_topology_batch(traces, _sim(), devices=["cpu", "cpu"],
                                  **GRID)
    counts = _counts()
    assert counts["sweep_topology"] == (ENTRY, 1)
    assert {f"topology.{k}": (TABLES, 1) for k in STAGES}.items() \
        <= counts.items()
    spans = tsim.engine_stats()["spans"]
    inner = sum(r["total_s"] for k, r in spans.items()
                if k.startswith("topology."))
    assert spans["sweep_topology"]["total_s"] >= inner
    # Every stage of the call runs inside the entry span.
    assert sum(r["self_s"] for r in spans.values()) == pytest.approx(
        spans["sweep_topology"]["total_s"], abs=1e-9)


def test_padded_table_builds_count_each_miss():
    traces = _traces(1)
    selection.clear_padded_table_caches()
    tsim.sweep_topology_batch(traces, _sim(), device="cpu", **GRID)
    assert tsim.engine_stats()["padded_table_builds"] == 1
    tsim.sweep_topology_batch(traces, _sim(), device="cpu", **GRID)
    assert tsim.engine_stats()["padded_table_builds"] == 1   # a repeat
    tsim.reset_engine_stats()
    assert tsim.engine_stats()["padded_table_builds"] == 0
    tsim.sweep_topology_batch(traces, _sim(), device="cpu", **GRID)
    assert tsim.engine_stats()["padded_table_builds"] == 0
    tsim.sweep_topology_batch(traces, _sim(), device="cpu",
                              n_chiplets=[9, 16], gateways_per_chiplet=[1, 1])
    assert tsim.engine_stats()["padded_table_builds"] == 1   # a new grid
    tsim.clear_engine_caches()
    tsim.sweep_topology_batch(traces, _sim(), device="cpu", **GRID)
    assert tsim.engine_stats()["padded_table_builds"] == 2


@pytest.mark.cuda
def test_the_cell_at_full_size_on_the_card(cuda_device):
    """Every one of the 224 lanes of two calls against the reference within
    the cell's limits; each planted fault breaks a limit."""
    from perfbench import harness
    from perfbench.tests.topology_faults import FAULTS, readings

    bench = harness.load_benchmark()
    entry = harness.cell_entry(bench, "c256_topology_dse")
    cell = harness.load_cell(entry["traffic"])
    config = harness.load_config(bench, entry["config"])
    drv = harness.driver_class(cell["entry"])(cell, config, 4294967311,
                                               cuda_device)
    drv.setup()
    limits = cell["limits"]
    clean = readings(drv)
    assert all(clean[k] <= limits[k] for k in limits), clean
    assert clean["padding_leak"] == 0
    assert tsim.engine_stats()["epoch_step_launches"] > 0
    faulty = {fault: readings(drv, fault) for fault in FAULTS}
    for fault, got in faulty.items():
        assert any(got[k] > limits[k] for k in limits), (fault, got)
    assert faulty["padding_leak"]["padding_leak"] > 0
