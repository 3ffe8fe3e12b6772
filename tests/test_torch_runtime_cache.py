"""The port's warm-start contract (`repro_torch.runtime.cache`) on the CPU:
the shared kernel-library cache directory, the memoized entry points
(`aot_compile`: the plain call's bits, one handle per config and shapes)
and `warmup`, with the reference's entry names and errors.
"""
import ctypes.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.runtime import cache as jcache
from repro_torch import backend
from repro_torch import random as trandom
from repro_torch.core import pareto as tpar
from repro_torch.core import simulator as S
from repro_torch.core import traffic
from repro_torch.runtime import cache as rcache

REPO = Path(__file__).resolve().parent.parent


def _sim():
    return S.SimConfig().with_arch(S.Arch.RESIPI)


def _trace(n=8, seed=0, c=4):
    sim = _sim()
    return traffic.generate(traffic.UniformSpec(n_intervals=n),
                            trandom.prng_key(seed, device="cpu"),
                            sim.cfg.with_topology(n_chiplets=c),
                            device="cpu")


def _equal(a, b, path=""):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(b, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif hasattr(b, "__dataclass_fields__"):
        for k in b.__dataclass_fields__:
            _equal(getattr(a, k), getattr(b, k), f"{path}.{k}")
    else:
        assert a == b, path


@pytest.fixture
def cache_tmp(tmp_path):
    """Point the kernel-library cache at a throwaway dir, restore after."""
    prev_dir, prev_build = rcache.cache_dir(), backend.BUILD_DIR
    rcache.clear_aot_cache()
    try:
        yield rcache.enable_persistent_cache(tmp_path / "kernels")
    finally:
        rcache._CACHE["dir"] = prev_dir
        backend.BUILD_DIR = prev_build
        rcache.clear_aot_cache()


def test_entry_points_are_the_references():
    assert rcache.AOT_ENTRY_POINTS == jcache.AOT_ENTRY_POINTS
    assert rcache.ENV_CACHE_DIR == jcache.ENV_CACHE_DIR


def test_enable_persistent_cache_redirects_the_library_dir(cache_tmp):
    assert cache_tmp.is_dir() and backend.BUILD_DIR == cache_tmp
    assert rcache.cache_dir() == cache_tmp
    stats = rcache.persistent_cache_stats()
    assert stats == {"enabled": True, "dir": str(cache_tmp), "entries": 0,
                     "bytes": 0}
    (cache_tmp / "epoch_step-0123456789abcdef.so").write_bytes(b"x" * 10)
    (cache_tmp / "epoch_step-0123456789abcdef.log").write_text("ptxas")
    stats = rcache.persistent_cache_stats()
    assert (stats["entries"], stats["bytes"]) == (1, 10)
    assert rcache.persistent_cache_stats(cache_tmp / "nope")["entries"] == 0


def test_a_cached_library_loads_without_a_build(cache_tmp, tmp_path):
    """A library already in the shared directory under its build key is
    loaded as it is: no nvcc, no build counted (the warm worker)."""
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    source = src_dir / "probe.cu"
    source.write_text("// probe\n")
    key = backend.build_key(source, backend.NVCC_FLAGS)
    libm = ctypes.util.find_library("m")
    assert libm is not None
    found = next(Path(d) / libm for d in ("/lib/x86_64-linux-gnu",
                                          "/usr/lib/x86_64-linux-gnu",
                                          "/lib64", "/usr/lib64", "/lib",
                                          "/usr/lib")
                 if (Path(d) / libm).exists())
    shutil.copy(found, cache_tmp / f"probe-{key}.so")
    backend.reset_counters()
    try:
        lib = backend.build_library("probe", source)
        assert lib.cos is not None
        assert backend.COUNTERS["builds"] == {}
    finally:
        backend._LIBS.pop("probe", None)


def test_the_environment_names_the_cache(tmp_path):
    code = ("from repro_torch import backend; "
            "from repro_torch.runtime import cache; "
            "print(backend.BUILD_DIR); print(cache.enable_persistent_cache())")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               REPRO_CACHE_DIR=str(tmp_path / "shared"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path / "shared")] * 2


def test_aot_simulate_sweep_and_topology_match_the_plain_calls():
    sim = _sim()
    tr = _trace()
    exe = rcache.aot_compile("simulate", tr, sim, device="cpu")
    _equal(exe(tr, sim, device="cpu"), S.simulate(tr, sim, device="cpu"))
    exe = rcache.aot_compile("sweep", tr, sim, device="cpu",
                             l_m=[0.01, 0.02])
    _equal(exe(tr, sim, device="cpu", l_m=[0.01, 0.02]),
           S.sweep(tr, sim, device="cpu", l_m=[0.01, 0.02]))
    tr9 = _trace(c=9)
    exe = rcache.aot_compile("sweep_topology", tr9, sim, device="cpu",
                             n_chiplets=[4, 9])
    _equal(exe(tr9, sim, device="cpu", n_chiplets=[4, 9]),
           S.sweep_topology(tr9, sim, device="cpu", n_chiplets=[4, 9]))


def test_aot_session_tick_and_search_match_the_plain_calls():
    sim = _sim()
    tr = _trace()
    states = S.init_session_states(sim, 1, device="cpu")
    batch = {"ext_load": tr["ext_load"][None], "mem_load": tr["mem_load"][None],
             "int_load": tr["int_load"][None],
             "ext_frac": tr["ext_frac"].reshape(1),
             "t_mask": torch.ones((1, 8))}
    tables = S.selection_tables_torch(sim.cfg, "cpu")
    exe = rcache.aot_compile("session_tick", states, batch, tables, sim)
    _equal(exe(states, batch, tables, sim),
           S.session_tick(states, batch, tables, sim))
    tr9 = _trace(c=9)
    kw = dict(n_chiplets=[4, 9], islands=2, generations=2, population=2,
              archive=8, seed=5, device="cpu")
    exe = rcache.aot_compile("search", tr9, sim, **kw)
    _equal(exe(tr9, sim, **kw), tpar.search_codesign(tr9, sim, **kw))
    assert rcache.aot_compile("search", tr9, sim, **kw) is exe


def test_aot_memoizes_on_config_and_shapes():
    rcache.clear_aot_cache()
    sim = _sim()
    a = rcache.aot_compile("simulate", _trace(), sim, device="cpu")
    assert rcache.aot_compile("simulate", _trace(seed=3), sim,
                              device="cpu") is a
    c = rcache.aot_compile("simulate", _trace(n=12), sim, device="cpu")
    assert c is not a
    d = rcache.aot_compile("simulate", _trace(), sim.with_arch(S.Arch.AWGR),
                           device="cpu")
    assert d is not a
    assert rcache.aot_cache_stats() == {"entries": 3,
                                        "by_entry": {"simulate": 3}}
    rcache.clear_aot_cache()
    assert rcache.aot_cache_stats()["entries"] == 0


def test_unknown_entries_raise():
    with pytest.raises(ValueError, match="unknown AOT entry"):
        rcache.aot_compile("nope", None, _sim())
    with pytest.raises(ValueError, match="unknown warmup entry"):
        rcache.warmup(_sim(), entries=("bogus",), device="cpu")


def test_warmup_runs_every_entry_point():
    walls = rcache.warmup(_sim(), n_intervals=8,
                          entries=rcache.AOT_ENTRY_POINTS, device="cpu")
    assert set(walls) == set(rcache.AOT_ENTRY_POINTS)
    assert all(w > 0.0 for w in walls.values())
