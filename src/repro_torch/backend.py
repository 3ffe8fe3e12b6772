"""Device policy, kernel builds and launch counters for the PyTorch port.

The counterpart of `repro.kernels.resolve_interpret` (the JAX package's
backend switch). Here the switch is the tensor's device: a wrapper given
CUDA tensors launches its hand-written Hopper kernel, a wrapper given CPU
tensors runs the kernel's plain PyTorch version. There is no silent CPU
fallback anywhere: entry points default to `cuda` and raise when no card is
present unless the caller asked for `device="cpu"`.

Importing this module turns TF32 off for float32 matrix products and cuDNN
convolutions, so every float32 product on the card runs in full float32, as
the reference's `preferred_element_type=jnp.float32` arithmetic does.

Kernels are CUDA C++ sources under `repro_torch/kernels/<name>/csrc/`, built
at first use by `nvcc` into `build/kernels/` at the repository root, or the
directory `REPRO_CACHE_DIR` names (keyed by
a hash of every file the source can include: its own `csrc/` directory and
each `-I` directory of its flags, such as the shared `kernels/hopper/`) and
loaded with `ctypes`.

Beside the launch counters, `span(name, layer)` times a host stage of the
program (always on, a microsecond or two each) and, while the torch
profiler runs, marks it as a `record_function` range on the profiler's
clock; `count_host_read` counts each device-to-host read.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Repository root: src/repro_torch/backend.py -> parents[2].
REPO_ROOT = Path(__file__).resolve().parents[2]
# The kernel-library cache: `build/kernels/` of the checkout, or the
# directory REPRO_CACHE_DIR names (a cache shared by the processes of a
# fleet; `runtime.cache.enable_persistent_cache` sets it in process).
ENV_CACHE_DIR = "REPRO_CACHE_DIR"
DEFAULT_BUILD_DIR = REPO_ROOT / "build" / "kernels"
BUILD_DIR = Path(os.environ[ENV_CACHE_DIR]).expanduser() \
    if os.environ.get(ENV_CACHE_DIR) else DEFAULT_BUILD_DIR

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# The same without --fmad=false, for kernels whose floats feed no discrete
# decision (flash_attention, ssd_scan): nvcc may contract a*b+c into FMAs.
NVCC_FLAGS_FMA = tuple(f for f in NVCC_FLAGS if f != "--fmad=false")
# Headers shared by the tensor-core kernels (wgmma, cp.async, TMA and
# mbarrier helpers): a kernel that includes them adds `-I` HOPPER_INCLUDE to
# its flags.
HOPPER_INCLUDE = Path(__file__).resolve().parent / "kernels" / "hopper"
SOURCE_SUFFIXES = (".cu", ".cuh", ".h", ".hpp")

# Per-kernel counters. A wrapper bumps `launches[name]` exactly where it
# launches its kernel, and `variants["name:variant"]` beside it when the op
# has more than one kernel (for example `flash_attention:wgmma`);
# `builds[name]` counts nvcc runs (a cached library loads without one);
# `loop_runs` counts runs of the plain interval loop; `spans[name]` holds
# each host span's layer, count and total and self seconds (`span`);
# `host_reads[name]` the count and bytes of device-to-host reads;
# `trace_checks` the value checks of trace arrays (`n`) and the checks sent
# to the host path (`fallbacks`: a value or a key, dtype or shape at fault).
COUNTERS: Dict[str, object] = {"launches": {}, "variants": {}, "builds": {},
                               "loop_runs": 0, "spans": {}, "host_reads": {},
                               "trace_checks": {"n": 0, "fallbacks": 0}}

_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_LOGS: Dict[str, str] = {}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `None` means the card.

    Raises RuntimeError when CUDA is requested (explicitly or by default)
    but absent — the port never quietly runs on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch version "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def count_launch(name: str, variant: Optional[str] = None) -> None:
    launches = COUNTERS["launches"]
    launches[name] = launches.get(name, 0) + 1
    if variant is not None:
        key = f"{name}:{variant}"
        variants = COUNTERS["variants"]
        variants[key] = variants.get(key, 0) + 1


def count_variant(name: str, variant: str) -> None:
    """Count a route that launches no kernel of the op, such as the plain
    backward of an op whose forward is a kernel (`name:variant` in
    `COUNTERS["variants"]`; `launches` is left alone)."""
    key = f"{name}:{variant}"
    variants = COUNTERS["variants"]
    variants[key] = variants.get(key, 0) + 1


def count_loop_run() -> None:
    COUNTERS["loop_runs"] += 1


def count_host_read(name: str, nbytes: int) -> None:
    """Count one device-to-host read of `nbytes` at site `name`; callers
    count only reads of tensors on the card."""
    reads = COUNTERS["host_reads"]
    rec = reads.get(name)
    if rec is None:
        rec = reads[name] = {"n": 0, "bytes": 0}
    rec["n"] += 1
    rec["bytes"] += int(nbytes)


def count_trace_check(fallback: bool = False) -> None:
    """Count one value check of trace arrays, or (`fallback`) one check
    sent to the host path."""
    COUNTERS["trace_checks"]["fallbacks" if fallback else "n"] += 1


# The layers a span's self time lands in (PERF.md's layers of the port).
LAYER_ENTRY = "entry points"
LAYER_TABLES = "models and tables"
LAYER_KERNELS = "kernels"
SPAN_LAYERS = (LAYER_ENTRY, LAYER_TABLES, LAYER_KERNELS)

_SPANS: Dict[str, "_Span"] = {}


class _OpenSpans(threading.local):
    """Each thread's open spans: [start ns, children's ns, profiler range]
    per span, innermost last."""

    def __init__(self):
        self.stack = []


_OPEN = _OpenSpans()


class _Span:
    """The context manager of one span name, shared by every use of the
    name (an open span's state lives on its thread's stack)."""
    __slots__ = ("name", "layer")

    def __init__(self, name: str, layer: str):
        self.name, self.layer = name, layer

    def __enter__(self):
        rng = None
        if _autograd_profiler._is_profiler_enabled:
            rng = _autograd_profiler.record_function(self.name)
            rng.__enter__()
        _OPEN.stack.append([time.perf_counter_ns(), 0, rng])
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        stack = _OPEN.stack
        t0, child, rng = stack.pop()
        dur = t1 - t0
        if stack:
            stack[-1][1] += dur
        spans = COUNTERS["spans"]
        rec = spans.get(self.name)
        if rec is None:
            rec = spans[self.name] = {"layer": self.layer, "n": 0,
                                      "total_s": 0.0, "self_s": 0.0}
        rec["n"] += 1
        rec["total_s"] += dur * 1e-9
        rec["self_s"] += (dur - child) * 1e-9
        if rng is not None:
            rng.__exit__(None, None, None)
        return False


def span(name: str, layer: str) -> _Span:
    """A context manager timing one host stage of the program: its
    duration adds to `COUNTERS["spans"][name]` (`n`, `total_s`, and
    `self_s`, the duration less that of the spans opened inside it), in
    `layer`, one of SPAN_LAYERS; the body raising closes it too. While the
    torch profiler runs, the stage is also a `record_function(name)` range,
    so the trace names the host time between the device's work by stage.
    Names carry no per-call id: a name's totals sum over calls."""
    sp = _SPANS.get(name)
    if sp is not None and sp.layer == layer:
        return sp
    if sp is not None or layer not in SPAN_LAYERS:
        raise ValueError(f"span {name!r} in layer {layer!r}: a name keeps "
                         f"one layer, one of {SPAN_LAYERS}")
    sp = _SPANS[name] = _Span(name, layer)
    return sp


# Work credited by the kernel ops, for an analysis that counts the program
# (`launch.op_analysis`): each sink is called as sink(name, bytes, flops)
# once per kernel call, on `meta` tensors (where the op computes nothing)
# and after each launch on the card. With no sink installed (the normal
# case) crediting costs one list test. `_KERNEL_DEPTH` > 0 while an op runs
# its kernel (or the kernel's stand-in on `meta`): the aten operations it
# issues there (output allocation, argument preparation) belong to the
# kernel, whose credited work stands for them.
_WORK_SINKS: List = []
_KERNEL_DEPTH = [0]


def record_work(name: str, nbytes: float, flops: float) -> None:
    """Credit one call of kernel `name` with its bytes and float ops to
    every installed sink."""
    for sink in _WORK_SINKS:
        sink(name, nbytes, flops)


@contextlib.contextmanager
def work_sink(sink):
    """Install `sink(name, bytes, flops)` for the duration of the block."""
    _WORK_SINKS.append(sink)
    try:
        yield sink
    finally:
        _WORK_SINKS.remove(sink)


@contextlib.contextmanager
def kernel_region():
    """Mark the block as the inside of one kernel call (see above)."""
    _KERNEL_DEPTH[0] += 1
    try:
        yield
    finally:
        _KERNEL_DEPTH[0] -= 1


def in_kernel_region() -> bool:
    return _KERNEL_DEPTH[0] > 0


def contiguous_aligned(x: torch.Tensor) -> torch.Tensor:
    """`x` contiguous with a 16-byte aligned start, as cp.async and TMA
    copies need: a view that starts mid-allocation is copied once."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def reset_counters() -> None:
    COUNTERS["launches"] = {}
    COUNTERS["variants"] = {}
    COUNTERS["builds"] = {}
    COUNTERS["loop_runs"] = 0
    COUNTERS["spans"] = {}
    COUNTERS["host_reads"] = {}
    COUNTERS["trace_checks"] = {"n": 0, "fallbacks": 0}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []) \
        + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _include_dirs(flags: Tuple[str, ...]) -> List[Path]:
    dirs = []
    for i, f in enumerate(flags):
        if f == "-I" and i + 1 < len(flags):
            dirs.append(Path(flags[i + 1]))
        elif f.startswith("-I") and len(f) > 2:
            dirs.append(Path(f[2:]))
    return dirs


def build_key(source: Path, flags: Tuple[str, ...]) -> str:
    """The build cache key of a kernel: a hash of the flags and of every
    source file the kernel can include, that is every `.cu`, `.cuh`, `.h`
    and `.hpp` under the source's own directory and under each `-I`
    directory of the flags (a header edited anywhere there rebuilds)."""
    h = hashlib.sha256("\0".join(flags).encode())
    for root in [Path(source).resolve().parent] + _include_dirs(flags):
        for f in sorted(p for p in root.rglob("*")
                        if p.is_file() and p.suffix in SOURCE_SUFFIXES):
            h.update(f"\0{f.relative_to(root)}\0".encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def nvcc_command(nvcc: str, source: Path, flags: Tuple[str, ...],
                 out: str) -> List[str]:
    """The nvcc command line: link flags (`-l...`, `-L...`) go after the
    source, where the linker looks for what it leaves undefined."""
    link = [f for f in flags if f.startswith(("-l", "-L"))]
    compile_flags = [f for f in flags if f not in link]
    return [nvcc, *compile_flags, "-o", out, str(source), *link]


def build_library(name: str, source: Path,
                  flags: Tuple[str, ...] = NVCC_FLAGS) -> ctypes.CDLL:
    """Build (once per `build_key`) and load a kernel's shared library.

    The library lands in `BUILD_DIR/<name>-<key>.so` with the nvcc
    `-Xptxas -v` report beside it (`build_log(name)` returns it). The write
    is atomic (temporary file + rename), so concurrent first uses from
    several processes sharing the directory at worst build twice, and a
    process that finds the library loads it without nvcc.
    """
    if name in _LIBS:
        return _LIBS[name]
    key = build_key(source, flags)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"{name}-{key}.so"
    log_path = BUILD_DIR / f"{name}-{key}.log"
    if not lib_path.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(nvcc_command(_nvcc(), source, flags, tmp),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {name}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        builds = COUNTERS["builds"]
        builds[name] = builds.get(name, 0) + 1
    _BUILD_LOGS[name] = log_path.read_text() if log_path.exists() else ""
    _LIBS[name] = ctypes.CDLL(str(lib_path))
    return _LIBS[name]


def build_log(name: str) -> Optional[str]:
    """The nvcc/ptxas report of a built library (None before its build)."""
    return _BUILD_LOGS.get(name)
