"""The per-layer metrics that read the program's spans and counters: each
cell's traced run reports every one it lists, and a program without the
totals (the parent of these metrics) leaves each out."""
import json
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.tests import small

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = ("host_ms.entry.epoch", "host_ms.tables.epoch",
                "host_ms.wrapper.epoch", "host_reads_per_call.epoch",
                "rebuilds_per_call.epoch", "host_ms.wrapper.flit",
                "host_reads_per_call.flit")
PROGRAM = [m for m in BENCH["per_layer"] if m["name"] in SPAN_METRICS]


@pytest.mark.parametrize("cell", ["t1_dse", "t1_noc_dse"])
def test_a_traced_run_reports_the_program_metrics(monkeypatch, cell):
    out = small.run(monkeypatch, cell, trace=True)
    assert out["correct"]
    want = {m["name"] for m in PROGRAM if cell in m["workloads"]}
    got = {k: v["value"] for k, v in out["metrics"].items() if k in want}
    assert set(got) == want
    assert all(v >= 0.0 for v in got.values())
    if cell == "t1_dse":
        assert got["rebuilds_per_call.epoch"] == 0.0
        assert got["host_ms.entry.epoch"] > 0.0
        assert got["host_ms.tables.epoch"] > 0.0
        assert got["host_ms.wrapper.epoch"] > 0.0
        reads = got["host_reads_per_call.epoch"]
    else:
        assert got["host_ms.wrapper.flit"] > 0.0
        reads = got["host_reads_per_call.flit"]
    assert reads == 0.0                  # no read crosses from a card here


def test_the_metrics_are_listed():
    assert [m["name"] for m in PROGRAM] == list(SPAN_METRICS)


def test_a_program_without_the_totals_reports_nothing():
    parent = {"epoch_step_launches": 3, "kernel_launches": {},
              "kernel_builds": {}, "loop_runs": 0,
              "selection_table_builds": 1, "search_dispatches": 0}
    calls = [harness.Call(0.0, 1.0, {})]
    ctx = harness.Context("t1_dse", 1.0, calls, 1.0, parent, dict(parent))
    for m in PROGRAM:
        assert harness.metric_reader(m["name"])(ctx) is None, m["name"]
