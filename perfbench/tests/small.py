"""Small sizes of the benchmark's cells for CPU tests: every cell's traffic
file with its sizes cut, and the configuration of the 64-chiplet cell cut
to 16 chiplets. The sample of answers compared covers every lane here."""
from __future__ import annotations

from perfbench import harness

CELLS = {
    "t1_dse": {"grid": {"l_m": [0.004, 0.032, 6],
                        "buffer_sat": [0.5, 0.95, 4]},
               "batches": 2, "intervals": 12,
               "check": {"calls": 2, "lanes": 4096}},
    "c64_codesign": {"n_chiplets": [4, 9, 16], "intervals": 12,
                      "islands": 4, "population": 4, "generations": 3,
                      "archive": 12, "migrate_every": 2,
                      "l_m": [0.008, 0.012, 0.02, 0.03],
                      "apps": ["blackscholes", "canneal", "dedup"]},
    "t1_noc_dse": {"loads": [0.02, 0.64, 3], "cycles": 48,
                   "gateways": [1, 4], "wavelengths": [2, 16]},
}
CONFIGS = {"resipi-c64": {"n_chiplets": 16}}


def small_config(monkeypatch) -> None:
    """Cut the configurations for this test (harness.load_config)."""
    real = harness.load_config
    monkeypatch.setattr(harness, "load_config", lambda bench, name: dict(
        real(bench, name), **CONFIGS.get(name, {})))


def run(monkeypatch, cell: str, seed: int = 20261018, *, patch=None,
        trace: bool = False, seconds: float = 0.3) -> dict:
    small_config(monkeypatch)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            overrides=CELLS[cell], patch=patch)
