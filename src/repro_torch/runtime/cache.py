"""Warm starts: a shared kernel-library cache and memoized entry points
(port of `repro.runtime.cache`).

The reference removes XLA's cold compiles twice over: a persistent
compilation cache on disk, and AOT-compiled executables memoized per
(entry, config, shapes) and serialized to disk. What a fresh process of
the port pays before its first result is different: `nvcc` building the
kernel libraries (seconds to minutes), then the first uses of the memoized
device tables (selection tables, the search's gather tables). So:

  * `enable_persistent_cache` points the kernel-library cache
    (`backend.BUILD_DIR`, keyed by `backend.build_key`) at a shared
    directory; `REPRO_CACHE_DIR` in the environment does the same for a
    process from its start. A process that finds `<name>-<key>.so` there
    loads it and runs no `nvcc` (`backend.COUNTERS["builds"]` stays empty);
    builds write through a temporary file and a rename, so concurrent
    workers never see a partial library;
  * `aot_compile` returns an `AotEntry` for one entry point, config and
    input shapes, with the kernel library loaded and the entry point's
    device tables built, memoized on that key; calling it is calling the
    entry point, so the results are the same bits;
  * `warmup` runs entry points once on representative inputs.

XLA's `jax_compilation_cache_dir` and its serialized executables have no
counterpart: a CUDA module is loaded from the cached library, and there is
no CUDA state worth pickling.
"""
from __future__ import annotations

import logging
import os
import pathlib
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import backend

log = logging.getLogger("repro_torch.runtime.cache")

ENV_CACHE_DIR = backend.ENV_CACHE_DIR

_CACHE = {"dir": None}
_AOT: Dict[tuple, "AotEntry"] = {}

#: Entry points `aot_compile` / `warmup` know.
AOT_ENTRY_POINTS = ("simulate", "sweep", "sweep_topology", "session_tick",
                    "search")


# ---------------------------------------------------------------------------
# The shared kernel-library cache
# ---------------------------------------------------------------------------

def enable_persistent_cache(cache_dir: Optional[str] = None) -> pathlib.Path:
    """Point the kernel-library cache at `cache_dir` (created if missing;
    default $REPRO_CACHE_DIR, else the checkout's `build/kernels/`).
    Libraries this process loaded already stay loaded. Idempotent;
    returns the resolved directory."""
    path = pathlib.Path(
        cache_dir or os.environ.get(ENV_CACHE_DIR)
        or backend.DEFAULT_BUILD_DIR).expanduser()
    path.mkdir(parents=True, exist_ok=True)
    backend.BUILD_DIR = path
    _CACHE["dir"] = path
    log.info("kernel-library cache at %s", path)
    return path


def cache_dir() -> Optional[pathlib.Path]:
    """The enabled cache directory (None before enable_persistent_cache)."""
    return _CACHE["dir"]


def persistent_cache_stats(path=None) -> dict:
    """The number and total bytes of the kernel libraries (`*.so`) in the
    cache directory (`path`, else the enabled one)."""
    path = pathlib.Path(path).expanduser() if path is not None \
        else _CACHE["dir"]
    if path is None or not pathlib.Path(path).is_dir():
        return {"enabled": _CACHE["dir"] is not None, "dir": None,
                "entries": 0, "bytes": 0}
    libs = [f for f in pathlib.Path(path).glob("*.so") if f.is_file()]
    return {"enabled": _CACHE["dir"] is not None, "dir": str(path),
            "entries": len(libs),
            "bytes": int(sum(f.stat().st_size for f in libs))}


# ---------------------------------------------------------------------------
# Memoized entry points
# ---------------------------------------------------------------------------

class AotEntry:
    """One entry point, prepared for a (config, input shapes): its kernel
    library loaded (on the card) and its device tables built. Calling it
    calls the entry point on the same arguments, so the results are the
    plain call's, bit for bit."""

    def __init__(self, entry: str, key: tuple, fn, device):
        self.entry = entry
        self.key = key
        self.device = device
        self._fn = fn

    def __call__(self, *args, **kw):
        return self._fn(*args, **kw)

    def __repr__(self):
        return f"AotEntry({self.entry}, shapes={self.key[-1]})"


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [x for k in sorted(tree.__dataclass_fields__)
                for x in _leaves(getattr(tree, k))]
    return [tree]


def _shape_key(args) -> tuple:
    out = []
    for leaf in _leaves(args):
        if isinstance(leaf, torch.Tensor):
            out.append((tuple(leaf.shape), str(leaf.dtype)))
        elif isinstance(leaf, np.ndarray):
            out.append((leaf.shape, str(leaf.dtype)))
    return tuple(out)


def _param_key(kw: dict) -> tuple:
    """A hashable memo key for keyword arguments (devices, ints, floats,
    grids of values or placements, nested dicts)."""
    def leaf(v):
        if isinstance(v, dict):
            return tuple((k, leaf(v[k])) for k in sorted(v))
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        if isinstance(v, (list, tuple, np.ndarray)):
            return tuple(leaf(p) for p in v)
        return v.item() if isinstance(v, np.generic) else v
    return tuple((name, leaf(kw[name])) for name in sorted(kw))


def _entries() -> dict:
    """entry name -> (entry point, prepare(args, kw, device))."""
    from repro_torch.core import pareto
    from repro_torch.core import simulator as S
    from repro_torch.core.selection import selection_tables_torch

    def tables(sim, dev):
        selection_tables_torch(sim.cfg, dev)

    def prep_topology(args, kw, dev):
        S._prepare_topology_sweep(args[1], {k: v for k, v in kw.items()
                                            if k != "device"}, dev)

    def prep_search(args, kw, dev):
        grids = {k: kw[k] for k in pareto.CODESIGN_TOPOLOGY_FIELDS
                 if k in kw}
        cs, gs, rs = pareto._check_topology_grids(args[1], grids)
        pareto._prepare_codesign(args[1], cs, gs, rs, dev)

    return {
        "simulate": (S.simulate, lambda a, k, d: tables(a[1], d)),
        "sweep": (S.sweep, lambda a, k, d: tables(a[1], d)),
        "sweep_topology": (S.sweep_topology, prep_topology),
        "session_tick": (S.session_tick, lambda a, k, d: tables(a[3], d)),
        "search": (pareto.search_codesign, prep_search)}


def _device_of(args, kw) -> torch.device:
    if kw.get("device") is not None:
        return backend.resolve_device(kw["device"])
    for leaf in _leaves(args):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return backend.resolve_device(None)


def aot_compile(entry: str, *args, **kw) -> AotEntry:
    """Prepare one entry point for these exact (config, shapes)::

        exe = aot_compile("simulate", trace, sim, device="cpu")
        out = exe(trace, sim, device="cpu")     # == simulate(...), bitwise

    Entries: "simulate" (trace, sim), "sweep" (trace, sim, **fields),
    "sweep_topology" (trace, sim, **grids), "session_tick" (states, batch,
    tables, sim), "search" (trace, sim, **search_codesign kwargs). On the
    card the `epoch_step` library is built or loaded (from the shared
    cache when one is enabled) when the config runs it; the entry point's
    device tables are built. Memoized on (entry, config, keyword grids,
    input shapes): a second call with same-shaped inputs returns the same
    handle.
    """
    if entry not in AOT_ENTRY_POINTS:
        raise ValueError(f"unknown AOT entry point {entry!r} "
                         f"(choose from {AOT_ENTRY_POINTS})")
    fn, prepare = _entries()[entry]
    sim = args[3] if entry == "session_tick" else args[1]
    arrays = args[:3] if entry == "session_tick" else args[:1]
    key = (entry, sim, _param_key(kw), _shape_key(arrays))
    hit = _AOT.get(key)
    if hit is not None:
        return hit
    dev = _device_of(arrays, kw)
    t0 = time.perf_counter()
    from repro_torch.core.simulator import _kernel_runs
    if dev.type == "cuda" and _kernel_runs(sim):
        from repro_torch.kernels.epoch_step import ops
        ops.build()
    prepare(args, kw, dev)
    log.info("prepared %s in %.3fs", entry, time.perf_counter() - t0)
    exe = AotEntry(entry, key, fn, dev)
    _AOT[key] = exe
    return exe


def aot_cache_stats() -> dict:
    """Per-entry count of memoized entries."""
    out: Dict[str, int] = {}
    for key in _AOT:
        out[key[0]] = out.get(key[0], 0) + 1
    return {"entries": len(_AOT), "by_entry": out}


def clear_aot_cache() -> None:
    _AOT.clear()


# ---------------------------------------------------------------------------
# Warmup
# ---------------------------------------------------------------------------

def warmup(sim, *, trace: Optional[dict] = None, n_intervals: int = 16,
           entries: Tuple[str, ...] = ("simulate", "sweep_topology"),
           grids: Optional[dict] = None, seed: int = 0,
           device=None) -> dict:
    """Run entry points once, synchronizing: builds or loads the kernel
    libraries and fills this process's memoized tables. Pass the `trace`
    (and `grids` for "sweep_topology" / "sweep" / "search") the real
    workload will use. Returns {entry: seconds} (host clock, the first
    call included)."""
    from repro_torch import random as trandom
    from repro_torch.core import pareto
    from repro_torch.core import simulator as S
    from repro_torch.core import traffic

    dev = backend.resolve_device(device)
    if trace is None:
        trace = traffic.generate(traffic.UniformSpec(n_intervals=n_intervals),
                                 trandom.prng_key(seed, device=dev), sim.cfg,
                                 device=dev)
    walls = {}
    for entry in entries:
        t0 = time.perf_counter()
        if entry == "simulate":
            out = S.simulate(trace, sim, device=dev)
        elif entry == "sweep":
            out = S.sweep(trace, sim, device=dev,
                          **(grids or {"l_m": [0.01]}))
        elif entry == "sweep_topology":
            out = S.sweep_topology(
                trace, sim, device=dev,
                **(grids or {"n_chiplets": [sim.cfg.n_chiplets]}))
        elif entry == "session_tick":
            states = S.init_session_states(sim, 1, device=dev)
            ext = torch.as_tensor(trace["ext_load"], device=dev)[None]
            batch = {"ext_load": ext,
                     "mem_load": torch.as_tensor(trace["mem_load"],
                                                 device=dev)[None],
                     "int_load": torch.as_tensor(trace["int_load"],
                                                 device=dev)[None],
                     "ext_frac": torch.as_tensor(trace["ext_frac"],
                                                 device=dev).reshape(1),
                     "t_mask": torch.ones(ext.shape[:2], device=dev)}
            out = S.session_tick(states, batch,
                                 S.selection_tables_torch(sim.cfg, dev), sim)
        elif entry == "search":
            out = pareto.search_codesign(
                trace, sim, islands=2, generations=2, population=2,
                device=dev, **(grids or {"n_chiplets": [sim.cfg.n_chiplets]}))
        else:
            raise ValueError(f"unknown warmup entry {entry!r} "
                             f"(choose from {AOT_ENTRY_POINTS})")
        del out
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls[entry] = time.perf_counter() - t0
    log.info("warmup: %s", {k: f"{v:.3f}s" for k, v in walls.items()})
    return walls
