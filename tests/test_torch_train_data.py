"""The trainer's host-side modules against the JAX reference, on the CPU:
`SyntheticLM` batches bit for bit (dense, VLM, encoder-decoder; steps and
hosts), checkpoints (a bitwise round trip, the reference's layout and leaf
names, `keep`, a checkpoint written by each package restored by the
other), the fault-tolerance guards and elastic re-meshing (the cases of
`tests/test_fault_tolerance.py` and `tests/test_checkpoint_runtime.py`),
and `launch/specs.py` against the reference's shapes, dtypes and specs for
every arch x cell on both production meshes.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import ARCH_NAMES, SHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.data import pipeline as jpipe
from repro.launch import specs as JS
from repro.models import get_model as jget_model
from repro.runtime import fault_tolerance as jft
from repro.sharding.rules import Rules as JRules
from repro.train import train_step as jts
from repro_torch.checkpoint import ckpt
from repro_torch.configs import cell_applicable, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.core.reconfig_runtime import (LANE_WIDTHS, LaneConfig,
                                               nearest_compiled_width)
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import get_model
from repro_torch.models.layers import KVCache
from repro_torch.random import prng_key
from repro_torch.runtime import elastic
from repro_torch.runtime.fault_tolerance import (Heartbeat, StepGuard,
                                                 StragglerMonitor)
from repro_torch.sharding.rules import Rules, to_shardings
from repro_torch.train import train_step as tts
from torch_train_parity import (  # noqa: F401
    keyed, keyed_torch, one_torch_thread)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-3b", "pixtral-12b",
                                  "seamless-m4t-large-v2", "mamba2-130m"])
def test_synthetic_batches_are_the_references(arch):
    for seed, batch, seq in ((0, 8, 32), (3, 6, 17)):
        jd = jpipe.SyntheticLM(jget_smoke(arch),
                               jpipe.DataConfig(batch, seq, seed=seed))
        td = tpipe.SyntheticLM(get_smoke_config(arch),
                               tpipe.DataConfig(batch, seq, seed=seed))
        for step, host, count in ((0, 0, 1), (5, 0, 1), (5, 1, 2)):
            want = jd.host_slice(step, host, count)
            got = td.host_slice(step, host, count)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        it = td.iter_batches(start_step=4)
        for step in (4, 5):
            got = next(it)
            want = jd.host_slice(step, 0, 1)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"a": torch.randn((4, 8), generator=gen),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "c": torch.tensor(3.5)}}


def test_checkpoint_roundtrip_bitwise(tmp_path):
    tree = _tree()
    path = ckpt.save_checkpoint(tree, str(tmp_path), step=10)
    like = {"a": torch.empty((4, 8), device="meta"),
            "nested": {"b": torch.empty(6, dtype=torch.int32, device="meta"),
                       "c": torch.empty(())}}
    got = ckpt.restore_checkpoint(like, str(tmp_path))
    assert torch.equal(got["a"], tree["a"])
    for k in ("b", "c"):
        assert got["nested"][k].dtype == tree["nested"][k].dtype
        assert torch.equal(got["nested"][k], tree["nested"][k])
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    assert set(manifest["entries"]) == {"['a']", "['nested']['b']",
                                        "['nested']['c']"}
    assert manifest["entries"]["['a']"]["key"] == "a0"
    assert (Path(path) / "shard_0.npz").exists()


def test_checkpoint_latest_gc_and_shape_mismatch(tmp_path):
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tree, str(tmp_path), step=s, keep=3)
    assert ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(p.name for p in Path(tmp_path).glob("step_*"))
    assert kept == ["step_00000003", "step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    bad = dict(tree, a=torch.empty((5, 8)))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(bad, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(tree, str(tmp_path / "none"))


@pytest.mark.parametrize("arch", ["stablelm-3b", "grok-1-314b"])
def test_checkpoints_cross_between_the_packages(arch, tmp_path):
    """A train state written by the port restores in the reference and one
    written by the reference restores in the port, every leaf bit for bit
    (AdamW / Adafactor state included; both from the same key)."""
    jm, tm = jget_model(jget_smoke(arch)), get_model(get_smoke_config(arch))
    js = jts.init_train_state(jm, jax.random.PRNGKey(0))
    ts = tts.init_train_state(tm, prng_key(0, device="cpu"))
    # Distinct values in the optimizer state, written by one package.
    ts["opt"]["step"].fill_(7)
    ts["step"].fill_(9)
    ckpt.save_checkpoint(ts, str(tmp_path / "port"), step=9)
    got = jckpt.restore_checkpoint(js, str(tmp_path / "port"))
    assert set(keyed(got)) == set(keyed_torch(ts))
    for k, v in keyed(got).items():
        np.testing.assert_array_equal(v, keyed_torch(ts)[k], err_msg=k)
    js = dict(js, step=jnp.int32(4))
    jckpt.save_checkpoint(js, str(tmp_path / "ref"), step=4)
    back = ckpt.restore_checkpoint(tts.abstract_train_state(tm),
                                   str(tmp_path / "ref"))
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 4
    for k, v in keyed(js).items():
        np.testing.assert_array_equal(keyed_torch(back)[k], v, err_msg=k)


def test_restore_places_on_a_mesh_of_this_process_only(tmp_path):
    """Restore with placements onto the host mesh (this process's CPU) and
    `restore_elastic` onto the production mesh, which is logical: it raises
    naming the mesh."""
    model = get_model(get_smoke_config("stablelm-3b"))
    state = tts.init_train_state(model, prng_key(0, device="cpu"))
    ckpt.save_checkpoint(state, str(tmp_path), step=1)
    mesh = make_host_mesh()
    sh = to_shardings(tts.state_pspecs(model, Rules(mesh)), mesh)
    got = ckpt.restore_checkpoint(tts.abstract_train_state(model),
                                  str(tmp_path), shardings=sh)
    for k, v in keyed_torch(state).items():
        np.testing.assert_array_equal(keyed_torch(got)[k], v)
    with pytest.raises(ValueError, match=r"'data': 16, 'model': 16"):
        elastic.restore_elastic(model, str(tmp_path), multi_pod=False)
    mesh2, rules2 = elastic.replan_mesh(multi_pod=True)
    assert mesh2.shape == (2, 16, 16) and rules2.mesh is mesh2


# ---------------------------------------------------------------------------
# Fault tolerance and elastic re-meshing
# ---------------------------------------------------------------------------

def test_heartbeat_matches_the_reference():
    seqs = [[0.1] * 10 + [1.0, 0.1], [100.0, 150.0, 10_000.0],
            [0.1 * 1.05 ** i for i in range(60)], [1.0, 1.1, 10.0]]
    for seq in seqs:
        for factor in (2.0, 3.0, 5.0):
            th, jh = Heartbeat(timeout_factor=factor), \
                jft.Heartbeat(timeout_factor=factor)
            assert [th.beat(t) for t in seq] == [jh.beat(t) for t in seq]
            assert th.degraded == jh.degraded


def test_step_guard_matches_the_reference():
    nan, inf = float("nan"), float("inf")
    seq = [(1.0, 0.5)] * 5 + [(nan, 1.0), (1.0, 1.0), (1.0, inf),
                              (1.0, 100.0), (1.0, 1.0), (inf, 1.0)]
    for max_skips, spike in ((10, 50.0), (3, 10.0), (2, 50.0)):
        tg = StepGuard(max_skips=max_skips, grad_spike_factor=spike)
        jg = jft.StepGuard(max_skips=max_skips, grad_spike_factor=spike)
        for loss, gnorm in seq:
            try:
                want = jg.check(loss, gnorm)
            except RuntimeError:
                with pytest.raises(RuntimeError, match="bad steps"):
                    tg.check(loss, gnorm)
                break
            assert tg.check(loss, gnorm) is want
            assert tg.skips == jg.skips
    assert StepGuard().check(1.0, 1e9) is True   # no EWMA yet: no spike


def test_straggler_monitor_matches_the_reference():
    rng = np.random.RandomState(4)
    tm = StragglerMonitor(n_pods=4, threshold=1.3, escalate_after=2)
    jm = jft.StragglerMonitor(n_pods=4, threshold=1.3, escalate_after=2)
    for epoch in range(5):
        slow = 3 if epoch < 3 else -1
        for pod in range(4):
            for _ in range(5):
                t = (2.0 if pod == slow else 1.0) * (1 + 0.05 * rng.rand())
                tm.record(pod, t)
                jm.record(pod, t)
        got, want = tm.epoch_verdict(), jm.epoch_verdict()
        np.testing.assert_array_equal(got["pod_means"], want["pod_means"])
        for k in ("slow_pods", "narrow_lanes_for", "escalate"):
            assert got[k] == want[k]
        if epoch == 1:
            assert got["escalate"] == [3]
    # The response path: narrow to a compiled lane width.
    assert nearest_compiled_width(max(1, LaneConfig().max_lanes // 2)) \
        in LANE_WIDTHS


def test_rescale_batch_matches_the_reference():
    from repro.runtime.elastic import rescale_batch as jrescale

    for args in ((256, 32, 16), (256, 16, 32), (64, 4, 4), (8, 8, 1)):
        assert elastic.rescale_batch(*args) == jrescale(*args)
    with pytest.raises(AssertionError):
        elastic.rescale_batch(global_batch=256, old_dp=32, new_dp=7)


# ---------------------------------------------------------------------------
# launch/specs.py
# ---------------------------------------------------------------------------

class _FakeMesh:
    """The reference's production mesh without its devices (as
    `tests/test_specs.py` builds it)."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))
        self.size = int(self.devices.size)


MESHES = {"1pod": {"data": 16, "model": 16},
          "2pod": {"pod": 2, "data": 16, "model": 16}}


def _jleaves(tree):
    is_leaf = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    return jax.tree_util.tree_leaves(tree, is_leaf=is_leaf)


def _tpairs(tree, specs):
    """[(meta tensor, spec)] of a port cache tree and its spec tree, walked
    together in the reference's leaf order."""
    if isinstance(tree, KVCache):
        return [p for f in ("k", "v", "length")
                for p in _tpairs(getattr(tree, f), getattr(specs, f))]
    if isinstance(tree, tuple):
        return [p for t, s in zip(tree, specs) for p in _tpairs(t, s)]
    if tree is None:
        return []
    return [(tree, specs)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cell", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_are_the_references(arch, cell, mesh):
    """Every input's shape, dtype and partition spec, and every cache
    leaf's, equal the reference's; a cell the reference skips is skipped
    for the same reason here."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jcell = next(s for s in SHAPES if s.name == cell)
    ok, why = cell_applicable(tcfg, jcell)
    from repro.configs import cell_applicable as jcell_applicable
    assert (ok, why) == jcell_applicable(jcfg, jcell)
    if not ok:
        return
    multi = mesh == "2pod"
    jr, tr = JRules(_FakeMesh(MESHES[mesh])), \
        Rules(make_production_mesh(multi_pod=multi))
    if jcell.kind in ("train", "prefill"):
        jb, jps = JS.batch_specs(jcfg, jcell, jr)
        tb, tps = TS.batch_specs(tcfg, jcell, tr)
        assert set(tb) == set(jb) == set(tps)
        for k in jb:
            assert tb[k].device.type == "meta"
            assert tuple(tb[k].shape) == jb[k].shape
            assert str(tb[k].dtype).split(".")[1] == str(jb[k].dtype)
            assert tps[k] == tuple(jps[k])
        return
    jt, jtp = JS.decode_tokens_specs(jcfg, jcell, jr)
    tt, ttp = TS.decode_tokens_specs(tcfg, jcell, tr)
    assert tuple(tt.shape) == jt.shape and ttp == tuple(jtp)
    jc, jcs = JS.decode_cache_specs(jcfg, jcell, jr)
    tc, tcs = TS.decode_cache_specs(tcfg, jcell, tr)
    jl, pairs = jax.tree_util.tree_leaves(jc), _tpairs(tc, tcs)
    assert [tuple(x.shape) for x, _ in pairs] == [x.shape for x in jl]
    assert [str(x.dtype).split(".")[1] for x, _ in pairs] == \
        [str(x.dtype) for x in jl]
    assert all(x.device.type == "meta" for x, _ in pairs)
    assert [spec for _, spec in pairs] == [tuple(x) for x in _jleaves(jcs)]
