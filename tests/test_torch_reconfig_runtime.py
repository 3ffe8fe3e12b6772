"""The Level-2 lane runtime of the port against `repro.core.reconfig_runtime`
on numpy-seeded inputs: lane widths, controller decisions and switch counts
exact, power and energy at 1e-6, `chunk_pytree` bins the reference's; and
`laned_all_reduce` over a 2-rank gloo group gives the bits of one
`all_reduce` at lanes 1, 2 and 4, and the numpy sum.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reconfig_runtime as jrr
from repro_torch.core import reconfig_runtime as trr

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-6


def test_lane_widths_and_config_are_the_references():
    assert trr.LANE_WIDTHS == jrr.LANE_WIDTHS
    tc, jc = trr.LaneConfig(), jrr.LaneConfig()
    assert (tc.max_lanes, tc.min_lanes, tc.l_m, tc.lane_bytes_per_step) == \
        (jc.max_lanes, jc.min_lanes, jc.l_m, jc.lane_bytes_per_step)
    assert (tc.controller().l_m, tc.controller().max_gateways,
            tc.controller().min_gateways) == \
        (jc.controller().l_m, jc.controller().max_gateways,
         jc.controller().min_gateways)


@pytest.mark.parametrize("widths", [None, (1, 2, 4, 8), (2, 8), (3,)])
def test_nearest_compiled_width(widths):
    kw = {} if widths is None else {"widths": widths}
    for lanes in range(-1, 12):
        assert trr.nearest_compiled_width(lanes, **kw) == \
            jrr.nearest_compiled_width(lanes, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_trajectory_is_the_references(seed):
    """meter_step / epoch_update over 12 epochs of numpy-seeded traffic:
    lanes, reconfigured flags and epochs exact, loads at 1e-6."""
    rng = np.random.default_rng(seed)
    cfg_kw = [{}, {"l_m": 0.3, "max_lanes": 8, "min_lanes": 2}][seed % 2]
    tc, jc = trr.LaneConfig(**cfg_kw), jrr.LaneConfig(**cfg_kw)
    ts, js = trr.LaneState.init(tc), jrr.LaneState.init(jc)
    for _ in range(12):
        steps = int(rng.integers(1, 5))
        scale = float(rng.choice([1e6, 1e7, 5e7, 2e8]))
        for b in rng.uniform(0.2, 1.8, steps).astype(np.float32) * scale:
            ts, js = trr.meter_step(ts, float(b)), jrr.meter_step(js, b)
        assert int(ts.steps_seen) == int(js.steps_seen)
        np.testing.assert_allclose(float(ts.bytes_seen),
                                   float(js.bytes_seen), rtol=RTOL)
        ts, trec = trr.epoch_update(ts, tc)
        js, jrec = jrr.epoch_update(js, jc)
        for k in ("lanes_before", "lanes_after", "reconfigured"):
            assert int(trec[k]) == int(jrec[k]), k
        np.testing.assert_allclose(float(trec["load"]), float(jrec["load"]),
                                   rtol=RTOL)
        assert (int(ts.lanes), int(ts.epoch), int(ts.steps_seen)) == \
            (int(js.lanes), int(js.epoch), int(js.steps_seen))
        assert ts.lanes.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 3])
def test_lane_energy_report_is_the_references(seed):
    rng = np.random.default_rng(seed)
    hist = rng.choice([1, 2, 4], size=20).astype(np.int32)
    for h in (hist, np.full(5, 2, np.int32), np.asarray([4, 4, 2, 2, 1, 4, 4],
                                                        np.int32)):
        got = trr.lane_energy_report(torch.as_tensor(h), trr.LaneConfig())
        want = jrr.lane_energy_report(jnp.asarray(h), jrr.LaneConfig())
        assert set(got) == set(want)
        for k in ("switch_count", "cum_switches"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        for k in ("mean_power_mw", "reconfig_nj", "cum_pcm_nj",
                  "mean_lanes"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, err_msg=k)


def _trees(seed):
    """A tree of float32 / float16 / int32 tensors of numpy-seeded sizes,
    as torch and as jax (dtypes both keep with jax's 64-bit types off)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 40, size=7)
    arrs = {f"p{i}": rng.standard_normal(s).astype(
        np.float16 if i == 3 else np.float32) for i, s in enumerate(sizes)}
    arrs["nested"] = [rng.standard_normal((3, 5)).astype(np.float32),
                      rng.integers(0, 9, 6).astype(np.int32)]
    to_t = lambda t: {k: ([torch.as_tensor(x) for x in v]  # noqa: E731
                          if isinstance(v, list) else torch.as_tensor(v))
                      for k, v in t.items()}
    to_j = lambda t: {k: ([jnp.asarray(x) for x in v]  # noqa: E731
                          if isinstance(v, list) else jnp.asarray(v))
                      for k, v in t.items()}
    return arrs, to_t(arrs), to_j(arrs)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("lanes", [1, 2, 3, 4, 12])
def test_chunk_pytree_bins_are_the_references(seed, lanes):
    _, tt, jt = _trees(seed)
    got, want = trr.chunk_pytree(tt, lanes), jrr.chunk_pytree(jt, lanes)
    assert [sorted(b) for b in got] == [sorted(b) for b in want]
    merged = trr.merge_chunks(got, tt)
    assert list(merged) == list(tt)
    for k in tt:
        for a, b in zip(trr._leaves(merged[k]), trr._leaves(tt[k])):
            assert a is b
    with pytest.raises(ValueError, match="lanes >= 1"):
        trr.chunk_pytree(tt, 0)


def test_collective_bytes_and_identity_without_a_group():
    _, tt, jt = _trees(2)
    for n in (2, 4, 16):
        np.testing.assert_allclose(float(trr.collective_bytes_of(tt, n)),
                                   float(jrr.collective_bytes_of(jt, n)),
                                   rtol=RTOL)
    assert trr.laned_all_reduce(tt, None, 4) is tt
    assert trr.laned_psum is trr.laned_all_reduce


_CHILD = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core import reconfig_runtime as rr
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
def tree(r):
    rng = np.random.default_rng(10 + r)
    return {"w": torch.as_tensor(rng.standard_normal((7, 5))
                                 .astype(np.float32)),
            "b": [torch.as_tensor(rng.standard_normal(13).astype(np.float32)),
                  torch.as_tensor(rng.standard_normal(3).astype(np.float64))],
            "n": torch.as_tensor(rng.integers(0, 50, 9).astype(np.int64))}
mine = tree(rank)
want = {k: (np.asarray(tree(0)[k]) + np.asarray(tree(1)[k])) if k != "b"
        else None for k in mine}
one = {}
for k, v in {"w": mine["w"], "b0": mine["b"][0], "b1": mine["b"][1],
             "n": mine["n"]}.items():
    x = v.clone()
    dist.all_reduce(x)
    one[k] = x
ok = True
for lanes in (1, 2, 4):
    out = rr.laned_all_reduce(mine, dist.group.WORLD, lanes)
    got = {"w": out["w"], "b0": out["b"][0], "b1": out["b"][1],
           "n": out["n"]}
    for k in one:
        ok &= bool(torch.equal(got[k], one[k]))
    ok &= bool(np.array_equal(out["w"].numpy(), want["w"]))
    ok &= bool(np.array_equal(out["n"].numpy(), want["n"]))
    ok &= bool(np.array_equal(
        out["b"][0].numpy(),
        np.asarray(tree(0)["b"][0]) + np.asarray(tree(1)["b"][0])))
ok &= bool(torch.equal(mine["w"], tree(rank)["w"]))   # not changed in place
dist.destroy_process_group()
print("RESULT", ok)
"""


def test_laned_all_reduce_over_two_gloo_ranks():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(r), port],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "RESULT True" in out, out
