"""`correct` on small CPU runs of every cell: true on the program as it is,
false with each fault a cell can have planted under its timed path
(`perfbench/faults.py`), and false with the control (the reference in
bfloat16) in the program's place. A fault the comparison cannot see
(`UNCOVERED`) is shown to change the program's answers."""
import numpy as np
import pytest
import torch

from perfbench.faults import FAULTS, UNCOVERED, plant
from perfbench.tests import small

CELL_ENTRY = {"t1_dse": "sweep_batch", "c64_codesign": "search_codesign",
              "t1_noc_dse": "noc_run"}
CASES = [(c, f) for c, e in CELL_ENTRY.items() for f in FAULTS[e]]


@pytest.mark.parametrize("cell", list(CELL_ENTRY))
def test_clean_run_is_correct(monkeypatch, cell):
    out = small.run(monkeypatch, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(monkeypatch, cell, fault):
    undo = []
    out = small.run(monkeypatch, cell,
                    patch=lambda drv: undo.append(plant(fault, drv)))
    undo[0]()
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("cell", list(CELL_ENTRY))
def test_control_fails(monkeypatch, cell):
    drivers = []
    out = small.run(monkeypatch, cell, patch=drivers.append)
    assert out["correct"]
    control = drivers[0].readings(torch.bfloat16)
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c, e in CELL_ENTRY.items() for f in UNCOVERED.get(e, ())])
def test_uncovered_fault_changes_the_answers(monkeypatch, cell, fault):
    """The fault is real: the same search with it planted reports other
    designs. `correct` may stay true (PERF.md lists what it cannot see)."""
    drivers = []
    small.run(monkeypatch, cell, patch=drivers.append)
    drv = drivers[0]
    clean = drv._run(0)
    undo = plant(fault, drv)
    try:
        broken = drv._run(0)
    finally:
        undo()
    assert (clean["archive"]["placements"] != broken["archive"]["placements"]
            or not np.array_equal(clean["island_scores"],
                                  broken["island_scores"]))
