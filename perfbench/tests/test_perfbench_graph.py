"""The reader of `graph_replays_per_call.codesign`: the program's replay
count over the window's calls, and nothing for a program without the
counter."""
import json
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = "graph_replays_per_call.codesign"


def _ctx(before: dict, after: dict, calls: int):
    return harness.Context("c64_codesign", 1.0,
                           [harness.Call(float(i), i + 1.0, {})
                            for i in range(calls)],
                           float(calls), before, after)


@pytest.mark.parametrize("replays, calls, want", [
    ((3, 13), 10, 1.0),       # every search of the window replayed
    ((0, 1), 4, 0.25),        # one replay in four calls
    ((5, 5), 2, 0.0),         # every search eager
])
def test_it_reads_the_replays_a_call(replays, calls, want):
    before = {"codesign_graph_replays": replays[0],
              "codesign_graph_captures": 1, "search_dispatches": 7}
    after = dict(before, codesign_graph_replays=replays[1])
    got = harness.metric_reader(NAME)(_ctx(before, after, calls))
    assert got == pytest.approx(want)


def test_a_program_without_the_counter_reports_nothing():
    parent = {"epoch_step_launches": 6, "search_dispatches": 1,
              "spans": {}, "host_reads": {}}
    assert harness.metric_reader(NAME)(_ctx(parent, dict(parent), 3)) \
        is None
    after = {"codesign_graph_replays": 2}
    assert harness.metric_reader(NAME)(_ctx(after, after, 0)) is None


def test_it_is_listed_for_the_codesign_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert len(m) == 1 and m[0]["workloads"] == ["c64_codesign"]
    assert m[0]["moves"] == "lane_intervals_per_s"
    assert bench["per_layer"][-1]["name"] == NAME
