"""Host spans and device-to-host read counts (`backend.span`,
`backend.count_host_read`): nesting and self time, a raising body,
snapshots and reset, profiler ranges only while the profiler runs, reads
counted only for tensors on the card; then where the entry points of the
benchmark's cells open their spans. This file imports no JAX."""
import time

import numpy as np
import pytest
import torch

from repro_torch import backend
from repro_torch.core import pareto
from repro_torch.core import simulator as tsim
from repro_torch.core import traffic
from repro_torch.core.traffic.transform import CHECK_READ, _np
from repro_torch.kernels.noc_step import ops as nops

ENTRY, TABLES, KERNELS = (backend.LAYER_ENTRY, backend.LAYER_TABLES,
                          backend.LAYER_KERNELS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `python -m pytest -m cuda "
                    "tests/test_torch_spans.py` on a machine with a card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_counters():
    backend.reset_counters()
    yield
    backend.reset_counters()


def _spans() -> dict:
    return tsim.engine_stats()["spans"]


def _counts(spans: dict) -> dict:
    return {k: (v["layer"], v["n"]) for k, v in spans.items()}


def _layer_sums(spans: dict) -> dict:
    out = {}
    for rec in spans.values():
        out[rec["layer"]] = out.get(rec["layer"], 0.0) + rec["self_s"]
    return out


def test_nesting_and_self_time():
    with backend.span("t.outer", ENTRY):
        time.sleep(0.01)
        with backend.span("t.inner", TABLES):
            time.sleep(0.02)
            with backend.span("t.leaf", KERNELS):
                time.sleep(0.005)
        with backend.span("t.inner", TABLES):
            pass
    s = _spans()
    assert _counts(s) == {"t.outer": (ENTRY, 1), "t.inner": (TABLES, 2),
                          "t.leaf": (KERNELS, 1)}
    outer, inner, leaf = s["t.outer"], s["t.inner"], s["t.leaf"]
    assert leaf["self_s"] == leaf["total_s"] >= 0.005
    assert inner["self_s"] == pytest.approx(
        inner["total_s"] - leaf["total_s"], abs=1e-9)
    assert inner["self_s"] >= 0.02
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"], abs=1e-9)
    assert 0.01 <= outer["self_s"] < outer["total_s"] - 0.025
    # Every span's self time lands in exactly one layer, once.
    sums = _layer_sums(s)
    assert sums == {ENTRY: outer["self_s"], TABLES: inner["self_s"],
                    KERNELS: leaf["self_s"]}
    assert sum(sums.values()) == pytest.approx(outer["total_s"], abs=1e-9)


def test_a_raising_body_closes_its_spans():
    with pytest.raises(ZeroDivisionError):
        with backend.span("t.outer", ENTRY):
            with backend.span("t.inner", TABLES):
                1 / 0
    assert backend._OPEN.stack == []
    assert _counts(_spans()) == {"t.outer": (ENTRY, 1),
                                 "t.inner": (TABLES, 1)}
    with backend.span("t.outer", ENTRY):
        pass
    assert _spans()["t.outer"]["n"] == 2


def test_a_name_keeps_one_layer_of_the_known_ones():
    with pytest.raises(ValueError, match="layer"):
        backend.span("t.bad", "device")
    backend.span("t.once", ENTRY)
    with pytest.raises(ValueError, match="one layer"):
        backend.span("t.once", KERNELS)


def test_a_snapshot_does_not_move_and_reset_clears():
    with backend.span("t.a", ENTRY):
        pass
    backend.count_host_read("t.read", 8)
    before = tsim.engine_stats()
    kept = {k: dict(v) for k, v in before["spans"].items()}
    with backend.span("t.a", ENTRY):
        with backend.span("t.b", TABLES):
            pass
    backend.count_host_read("t.read", 4)
    assert before["spans"] == kept
    assert before["host_reads"] == {"t.read": {"n": 1, "bytes": 8}}
    after = tsim.engine_stats()
    assert after["spans"]["t.a"]["n"] == 2 and "t.b" in after["spans"]
    assert after["host_reads"] == {"t.read": {"n": 2, "bytes": 12}}
    tsim.reset_engine_stats()
    cleared = tsim.engine_stats()
    assert cleared["spans"] == {} and cleared["host_reads"] == {}


def test_spans_are_profiler_ranges_only_while_it_runs(monkeypatch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with backend.span("t.profiled", ENTRY):
            with backend.span("t.profiled.inner", KERNELS):
                torch.ones(4).add_(1)
    names = {e.name for e in prof.events()}
    assert {"t.profiled", "t.profiled.inner"} <= names
    assert _spans()["t.profiled"]["n"] == 1

    opened = []
    real = torch.autograd.profiler.record_function
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or real(*a, **k))
    with backend.span("t.quiet", ENTRY):
        torch.ones(4).add_(1)
    assert opened == [] and _spans()["t.quiet"]["n"] == 1


def test_host_reads_count_only_tensors_on_the_card():
    backend.count_host_read("t.read", 3)
    backend.count_host_read("t.read", 5)
    assert tsim.engine_stats()["host_reads"] == {
        "t.read": {"n": 2, "bytes": 8}}
    backend.reset_counters()
    tr = traffic.generate(traffic.ParsecSpec("dedup", 6), 1, dest=True,
                          device="cpu")
    traffic.validate_trace(tr)
    assert np.array_equal(_np(tr["ext_load"]), tr["ext_load"].numpy())
    nops.routing(torch.as_tensor(nops.build_topology(2, 4)[0])[None])
    assert tsim.engine_stats()["host_reads"] == {}


@pytest.mark.cuda
def test_host_reads_are_counted_on_the_card(cuda_device):
    x = torch.ones(3, device=cuda_device)
    _np(x)
    nops.routing(torch.as_tensor(nops.build_topology(2, 4)[0],
                                 device=cuda_device)[None])
    assert tsim.engine_stats()["host_reads"] == {
        "traffic._np": {"n": 1, "bytes": 12},
        "noc_step.routing": {"n": 3, "bytes": 6}}


# -- where the entry points open their spans ---------------------------------

def _dse_traces(device):
    return [traffic.generate(traffic.ParsecSpec(app, 8), 20 + i, dest=True,
                             device=device)
            for i, app in enumerate(("dedup", "canneal"))]


def _sweep_batch(device):
    sim = tsim.SimConfig().with_arch(tsim.Arch.RESIPI)
    tsim.sweep_batch(_dse_traces(device), sim, device=device,
                     l_m=np.float32([0.01, 0.02, 0.03]))


def test_sweep_batch_opens_each_stage_once():
    _sweep_batch("cpu")
    s = _spans()
    # On the CPU the wrapper runs its plain version, which builds the
    # records itself: there is no reassembly.
    assert _counts(s) == {"sweep_batch": (ENTRY, 1),
                          "stack_traces": (TABLES, 1),
                          "epoch_inputs": (TABLES, 1),
                          "selection_tables": (TABLES, 1),
                          "epoch_step": (KERNELS, 1),
                          "summaries": (ENTRY, 1)}
    assert sum(_layer_sums(s).values()) == pytest.approx(
        s["sweep_batch"]["total_s"], abs=1e-9)
    assert tsim.engine_stats()["host_reads"] == {}


@pytest.mark.cuda
def test_sweep_batch_opens_each_stage_once_on_the_card(cuda_device):
    _sweep_batch(cuda_device)
    backend.reset_counters()
    _sweep_batch(cuda_device)
    s = _spans()
    assert _counts(s) == {"sweep_batch": (ENTRY, 1),
                          "stack_traces": (TABLES, 1),
                          "epoch_inputs": (TABLES, 1),
                          "selection_tables": (TABLES, 1),
                          "epoch_step": (KERNELS, 1),
                          "epoch_step.reassemble": (KERNELS, 1),
                          "summaries": (ENTRY, 1)}
    # The values of both traces checked once, on the stacked arrays: their
    # six extremes (four loads' minima, the destination matrices' minimum
    # and maximum, float32) read back in one copy; no array read back.
    reads = tsim.engine_stats()["host_reads"]
    assert reads[CHECK_READ] == {"n": 1, "bytes": 24}
    assert "traffic._np" not in reads


def test_the_padded_entry_points_open_topology_stages():
    sim = tsim.SimConfig().with_arch(tsim.Arch.RESIPI)
    cfg16 = sim.cfg.with_topology(n_chiplets=16)
    tr = traffic.generate(traffic.ParsecSpec("dedup", 6), 3, cfg16,
                          dest=True, device="cpu")
    tsim.sweep_topology(tr, sim, device="cpu", n_chiplets=[4, 16],
                        gateways_per_chiplet=[4, 2])
    stages = ("prepare", "trace_arrays", "lanes", "dest_pairs",
              "initial_state")
    counts = _counts(_spans())
    assert {f"topology.{k}": (TABLES, 1) for k in stages}.items() \
        <= counts.items()
    assert counts["epoch_step"] == (KERNELS, 1)
    assert counts["summaries"] == (ENTRY, 1)


def test_search_codesign_opens_each_generation_stage():
    sim = tsim.SimConfig().with_arch(tsim.Arch.RESIPI)
    cfg16 = sim.cfg.with_topology(n_chiplets=16)
    traces = [traffic.generate(traffic.ParsecSpec(app, 6), i, cfg16,
                               device="cpu")
              for i, app in enumerate(("dedup", "streamcluster"))]
    kw = dict(n_chiplets=[8, 16], mesh_radix=[4, 4], islands=2,
              generations=3, population=3, archive=16, seed=1)
    pareto.clear_codesign_caches()
    builds = tsim.engine_stats()["codesign_topology_builds"]
    pareto.search_codesign(traces, sim, device="cpu", **kw)
    assert tsim.engine_stats()["codesign_topology_builds"] == builds + 1
    backend.reset_counters()
    pareto.search_codesign(traces, sim, device="cpu", **kw)
    stats = tsim.engine_stats()
    assert stats["codesign_topology_builds"] == builds + 1
    gens = kw["generations"]
    want = {"search_codesign": (ENTRY, 1), "stack_traces": (TABLES, 1),
            "codesign.prepare": (TABLES, 1),
            "codesign.proposals": (TABLES, gens),
            "codesign.tables": (TABLES, gens),
            "codesign.score": (TABLES, gens),
            "epoch_step": (KERNELS, gens),
            "codesign.acceptance": (TABLES, gens),
            "codesign.archive": (TABLES, 1), "codesign.result": (ENTRY, 1)}
    assert _counts(stats["spans"]) == want
    assert sum(_layer_sums(stats["spans"]).values()) == pytest.approx(
        stats["spans"]["search_codesign"]["total_s"], abs=1e-9)


def test_noc_run_opens_its_spans():
    next_mat, drain, buf, mask = nops.build_topology_padded(2, 4,
                                                            pad_to=20)
    arrivals = torch.zeros((2, 16, 20))
    arrivals[:, ::3, :4] = 4.0
    nops.noc_run(arrivals, torch.as_tensor(next_mat),
                 torch.as_tensor(drain), torch.as_tensor(buf),
                 valid_mask=torch.as_tensor(mask))
    assert _counts(_spans()) == {"noc_run": (ENTRY, 1),
                                 "noc_step": (KERNELS, 1)}


@pytest.mark.cuda
def test_noc_run_opens_its_spans_on_the_card(cuda_device):
    next_mat, drain, buf, mask = (
        torch.as_tensor(a, device=cuda_device)
        for a in nops.build_topology_padded(2, 4, pad_to=20))
    arrivals = torch.zeros((2, 16, 20), device=cuda_device)
    arrivals[:, ::3, :4] = 4.0
    nops.noc_run(arrivals, next_mat, drain, buf, valid_mask=mask)
    stats = tsim.engine_stats()
    assert _counts(stats["spans"]) == {"noc_run": (ENTRY, 1),
                                       "noc_step.prepare": (KERNELS, 1),
                                       "noc_step": (KERNELS, 1)}
    assert stats["host_reads"] == {"noc_step.routing": {"n": 3, "bytes": 6}}
