"""The frozen work formulas, pinned to the counts the port's per-kernel
bounds were taken with (PERF.md's kernel table)."""
import numpy as np
import pytest

from perfbench.work import HBM_BYTES_PER_S, PEAK_F32_FLOPS, bound_s
from perfbench.work.epoch import epoch_work, padded_epoch_work
from perfbench.work.noc import noc_work

TOPO_C, TOPO_G = (16, 36, 64, 100, 144, 196, 256), (1, 2, 3, 4)
SPLIT_C, SPLIT_G, KNOB_LM = (4, 8, 12, 16), (1, 2, 3, 4), 64


def _padded(n, t, c, points):
    lane_c = np.array([pc for _ in range(n) for pc, _ in points])
    lane_g = np.array([pg for _ in range(n) for _, pg in points])
    pair_c = np.array([pc for _ in range(n)
                       for pc in sorted({pc for pc, _ in points})])
    return padded_epoch_work(n, t, c, 4, lane_c, lane_g, pair_c)


def test_topology_dse_at_256_chiplets_is_1635_mflop():
    points = [(c, g) for c in TOPO_C for g in TOPO_G]
    nbytes, ops = _padded(8, 100, 256, points)
    assert ops / 1e9 == pytest.approx(1.635, abs=5e-4)
    assert bound_s(nbytes, ops) * 1e3 == pytest.approx(0.0244, abs=5e-5)


def test_split_dse_at_16_chiplets_is_126_mb():
    points = [(c, g) for c in SPLIT_C for g in SPLIT_G
              for _ in range(KNOB_LM)]
    nbytes, ops = _padded(8, 100, 16, points)
    assert nbytes / 1e6 == pytest.approx(126.3, abs=0.05)
    assert bound_s(nbytes, ops) * 1e3 == pytest.approx(0.0377, abs=5e-5)


@pytest.mark.parametrize("lanes,bound_ms", [(32768, 0.0553),
                                            (524288, 0.0553 * 16)])
def test_table1_dse_bound_is_bytes(lanes, bound_ms):
    nbytes, ops = epoch_work(8, 100, 4, 4, lanes, dest=True)
    assert nbytes / HBM_BYTES_PER_S > ops / PEAK_F32_FLOPS
    assert bound_s(nbytes, ops) * 1e3 == pytest.approx(bound_ms, rel=2e-3)


def test_codesign_launch_bound_is_operations():
    """Phase 10 (b): 1536 lanes x 100 intervals at 64 / 144 / 256 real
    chiplets padded to 256, 8 workloads' matrices at each count."""
    pts = (64, 144, 256)
    lane_c = np.repeat(pts, 8 * 8 * 8)
    nbytes, ops = padded_epoch_work(8, 100, 256, 4, lane_c,
                                    np.full(len(lane_c), 4),
                                    np.tile(pts, 8))
    assert ops / PEAK_F32_FLOPS > nbytes / HBM_BYTES_PER_S
    assert bound_s(nbytes, ops) * 1e3 == pytest.approx(0.1880, abs=5e-5)


def test_noc_dse_bound():
    """Phase 4's flit DSE: 512 runs (radix 4 / 8 x g 1-4 x W 2 / 16 x 32
    loads) x 8192 cycles padded to 68 nodes; live nodes r^2 + g."""
    runs = [(r, g) for r in (4, 8) for g in (1, 2, 3, 4) for _ in (2, 16)
            for _ in range(32)]
    live = sum(r * r + g for r, g in runs)
    nbytes, ops = noc_work(len(runs), 8192, 68, live)
    assert bound_s(nbytes, ops) * 1e3 == pytest.approx(0.2134, abs=5e-5)
