"""The harness and BENCHMARK.json: the contract's rules on names, keys and
limits; every configuration, traffic mix, driver and metric found by its
name; a new cell and metric added as new files only; the trace reduction;
and run.py refusing to run without a card."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.trace import CALL_TAG, WINDOW_TAG, kernel_time, read_trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("part", list(KEYS))
def test_entries_and_names(part):
    names = [e["name"] for e in BENCH[part]]
    assert len(names) == len(set(names))
    for e in BENCH[part]:
        extra = {"workloads"} if part in ("end_to_end", "per_layer") else set()
        assert KEYS[part] <= set(e) <= KEYS[part] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and part != "end_to_end" and part != "per_layer":
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert len(m["layer"]) <= 200 and "\n" not in m["layer"]
        for c in m["workloads"]:
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", [c])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_report_enough():
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200
        e2e = harness.cell_metrics(BENCH, w["name"], False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_run_seconds_fits_the_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_are_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith("perfbench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert c["source"].startswith(("http", "ReSiPI"))


def test_every_piece_found_by_name():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["traffic"])
        assert harness.driver_class(cell["entry"]).__name__ == "Driver"
        assert harness.load_config(BENCH, w["config"])["name"] == w["config"]
        assert set(cell["limits"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_readers_leave_out_what_they_cannot_read():
    ctx = harness.Context("c", 1.0, [], 1.0, {}, {})
    for m in BENCH["per_layer"]:
        assert harness.metric_reader(m["name"])(ctx) is None


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [_event(WINDOW_TAG, "user_annotation", 0, 1000),
              _event(CALL_TAG, "user_annotation", 0, 1000),
              _event("aten::copy_", "cpu_op", 100, 200),
              _event("epoch_metrics_kernel<4>", "kernel", 300, 400),
              _event("other_kernel", "kernel", 600, 200),
              _event("Memcpy DtoH", "gpu_memcpy", 900, 50),
              _event("outside_kernel", "kernel", 2000, 10)]
    t = read_trace(events)
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(550e-6)
    assert kernel_time(t, r"\bepoch_\w*kernel") == pytest.approx(400e-6)
    gaps = dict(t["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(300e-6)
    assert gaps["python"] == pytest.approx(150e-6)
    assert read_trace(events[1:]) is None


def test_run_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for root in (ROOT, tmp_path):
        if root == tmp_path:
            shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        p = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", "t1_noc_dse",
             "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
            capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and p.stdout.strip() == ""


NEW_CELL = {"name": "t1_dse_narrow", "config": "resipi-table1",
            "traffic": "t1_dse_narrow", "chips": 1,
            "why": "a test cell: a narrower knob grid"}
NEW_METRIC = {"name": "calls_per_s.test", "unit": "calls/s",
              "better": "higher", "source": "host_clock",
              "layer": "entry points", "moves": "lane_intervals_per_s",
              "workloads": ["t1_dse_narrow"]}


def test_a_cell_and_a_metric_added_as_new_files(tmp_path):
    """A later cell and per-layer metric arrive as new files and new
    BENCHMARK.json entries, no existing file edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(NEW_CELL)
    bench["per_layer"].append(NEW_METRIC)
    for m in bench["end_to_end"]:
        if m["name"] in ("lane_intervals_per_s", "call_p95_ms"):
            m["workloads"].append(NEW_CELL["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = json.loads((ROOT / "perfbench/workloads/t1_dse.json").read_text())
    cell.update({"grid": {"l_m": [0.004, 0.032, 4],
                          "buffer_sat": [0.5, 0.95, 2]},
                 "batches": 1, "intervals": 8,
                 "check": {"calls": 1, "lanes": 64}})
    (tmp_path / "perfbench/workloads/t1_dse_narrow.json").write_text(
        json.dumps(cell))
    (tmp_path / "perfbench/metrics/calls_per_s.test.py").write_text(
        "def read(ctx):\n    return len(ctx.calls) / ctx.window_s\n")
    code = ("import json, sys\n"
            f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]\n"
            "from perfbench import harness\n"
            "out = harness.run_cell('t1_dse_narrow', 3, 0.2, True, "
            "device='cpu')\n"
            "print(json.dumps(out))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert out["metrics"]["calls_per_s.test"]["value"] > 0
    assert list(out)[-1] == "checks"
