"""Trace checks: `validate_trace`, `pad_trace`, `stack_traces` and the
entry points refuse every malformed trace with the same exception type and
message whether the arrays are numpy arrays, CPU tensors or tensors on the
card, and name the first trace at fault of a batch. The values of one call
are checked once: `engine_stats()["trace_checks"]` counts the checks and
those sent to the host path, and on the card the check reads back once.
This file imports no JAX."""
import numpy as np
import pytest
import torch

from repro_torch import backend
from repro_torch.core import pareto
from repro_torch.core import simulator as tsim
from repro_torch.core import traffic
from repro_torch.core.traffic.transform import CHECK_READ

C, T = 4, 6
SIM = tsim.SimConfig().with_arch(tsim.Arch.RESIPI)
CFG16 = SIM.cfg.with_topology(n_chiplets=16)
KEYS = "('ext_load', 'mem_load', 'int_load', 'ext_frac')"
DEST = ("{who}['dest'] must be finite and non-negative (a row-stochastic "
        "destination distribution)")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `python -m pytest -m cuda "
                    "tests/test_torch_trace_checks.py` on a machine with a "
                    "card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_counters():
    backend.reset_counters()
    yield
    backend.reset_counters()


def _good(seed=0) -> dict:
    """A [T, C] trace with a destination matrix, as numpy arrays."""
    tr = traffic.generate(traffic.ParsecSpec("dedup", T), seed, dest=True,
                          device="cpu")
    return {k: (v if k == "app" else v.numpy()) for k, v in tr.items()}


def _set(tr, key, index, value, dtype=None):
    a = np.array(tr[key], dtype=dtype)
    a[index] = value
    return dict(tr, **{key: a})


def _drop(tr, key):
    return {k: v for k, v in tr.items() if k != key}


# (name, make the bad trace from a good one, exception, message with {who})
BAD = [
    ("nan", lambda tr: _set(tr, "ext_load", (2, 1), np.nan), ValueError,
     "{who}['ext_load'] contains NaN — injected loads must be finite"),
    ("negative", lambda tr: _set(tr, "mem_load", 3, -0.5), ValueError,
     "{who}['mem_load'] contains negative values (min -0.5) — loads are "
     "non-negative flit rates"),
    ("negative_ext_frac", lambda tr: dict(tr, ext_frac=np.float32(-0.25)),
     ValueError, "{who}['ext_frac'] contains negative values (min -0.25) — "
     "loads are non-negative flit rates"),
    ("negative_inf", lambda tr: _set(tr, "int_load", (0, 0), -np.inf),
     ValueError, "{who}['int_load'] contains negative values (min -inf) — "
     "loads are non-negative flit rates"),
    # float32 would round it to -0.0: the check reads the float64 itself.
    ("negative_below_float32",
     lambda tr: _set(tr, "ext_load", (1, 2), -1e-50, np.float64),
     ValueError, "{who}['ext_load'] contains negative values (min -1e-50) "
     "— loads are non-negative flit rates"),
    ("missing_key", lambda tr: _drop(tr, "int_load"), ValueError,
     "{who} is missing ['int_load']; a trace dict needs " + KEYS
     + " (generate one with repro_torch.core.traffic.generate)"),
    ("bool_dtype", lambda tr: dict(tr, int_load=tr["int_load"] > 0),
     ValueError, "{who}['int_load'] must be numeric, got dtype bool"),
    ("dest_inf", lambda tr: _set(tr, "dest", (1, 2), np.inf), ValueError,
     DEST),
    ("dest_negative_inf", lambda tr: _set(tr, "dest", (0, 3), -np.inf),
     ValueError, DEST),
    ("dest_negative", lambda tr: _set(tr, "dest", (2, 0), -0.125),
     ValueError, DEST),
    ("dest_nan", lambda tr: _set(tr, "dest", (3, 3), np.nan), ValueError,
     DEST),
    ("dest_shape", lambda tr: dict(tr, dest=np.ones((3, 3), np.float32)),
     ValueError, "{who}['dest'] must be a square [C, C] destination matrix "
     "(optionally with one leading batch axis) matching the trace's chiplet "
     "axis (C=4), got shape (3, 3)"),
    # Faults raise in the order of the host checks: the NaN of ext_load
    # before the dtype of int_load.
    ("nan_before_dtype",
     lambda tr: dict(_set(tr, "ext_load", (0, 0), np.nan),
                     int_load=tr["int_load"] > 0),
     ValueError,
     "{who}['ext_load'] contains NaN — injected loads must be finite"),
    ("not_a_dict", lambda tr: "ext_load", TypeError,
     "{who} must be a trace dict with keys " + KEYS + " (see "
     "repro_torch.core.traffic.generate), got str: 'ext_load'"),
]
IDS = [b[0] for b in BAD]


def _on(tr, where):
    """The trace's arrays as numpy ("numpy") or tensors on `where`."""
    if where == "numpy" or not isinstance(tr, dict):
        return tr
    return {k: (v if k == "app" else torch.as_tensor(np.asarray(v),
                                                     device=where))
            for k, v in tr.items()}


def _raises(fn, exc, message):
    with pytest.raises(exc) as got:
        fn()
    assert type(got.value) is exc
    assert str(got.value) == message


def _check_bad_case(case, where):
    _, make, exc, message = case
    bad = _on(make(_good()), where)
    good = [_on(_good(seed), where) for seed in (1, 2)]
    _raises(lambda: traffic.validate_trace(bad), exc,
            message.format(who="trace"))
    _raises(lambda: traffic.validate_trace(bad, who="w"), exc,
            message.format(who="w"))
    _raises(lambda: traffic.pad_trace(bad, T + 2), exc,
            message.format(who="trace"))
    for i, batch in ((0, [bad] + good), (1, [good[0], bad, good[1]]),
                     (2, good + [bad])):
        for pad in (False, True):
            _raises(lambda: tsim.stack_traces(batch, pad=pad), exc,
                    message.format(who=f"traces[{i}]"))
    assert backend.COUNTERS["trace_checks"]["fallbacks"] == 9


@pytest.mark.parametrize("where", ["numpy", "cpu"])
@pytest.mark.parametrize("case", BAD, ids=IDS)
def test_bad_traces_raise_the_same_message(case, where):
    _check_bad_case(case, where)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BAD, ids=IDS)
def test_bad_traces_raise_the_same_message_on_the_card(case, cuda_device):
    _check_bad_case(case, cuda_device)


def test_a_trace_fault_comes_before_the_batch_errors():
    nan = _set(_good(), "ext_load", (0, 0), np.nan)
    wide = traffic.generate(traffic.ParsecSpec("dedup", T), 3, CFG16,
                            device="cpu")
    long_mem = dict(_good(1), mem_load=np.ones(T + 1, np.float32))
    for other in (wide, long_mem):
        _raises(lambda: tsim.stack_traces([nan, other]), ValueError,
                "traces[0]['ext_load'] contains NaN — injected loads must "
                "be finite")


def test_what_the_host_checks_accept_passes():
    tr = _good()
    huge = dict(tr, dest=np.where(np.eye(C) > 0, 1e300,
                                  tr["dest"].astype(np.float64)))
    empty = dict(tr, **{k: np.zeros((0,) + np.shape(tr[k])[1:], np.float32)
                        for k in ("ext_load", "mem_load", "int_load")})
    for ok in (dict(tr, ext_load=np.where(tr["ext_load"] > 0, np.inf, 0.0)),
               dict(tr, mem_load=tr["mem_load"].astype(np.int64) + 1,
                    ext_frac=0.25),
               huge, empty):
        for where in ("numpy", "cpu"):
            assert traffic.validate_trace(_on(ok, where)) is not None
        with np.errstate(over="ignore"):   # the stack's float32 cast
            tsim.stack_traces([ok, ok])
    with np.errstate(over="ignore"):
        tsim.stack_traces([_on(huge, "cpu")] * 2)


SIM16 = tsim.SimConfig(cfg=CFG16).with_arch(tsim.Arch.RESIPI)
TOPO = dict(n_chiplets=[4, 16], gateways_per_chiplet=[4, 2])


def _traces16():
    return [traffic.generate(traffic.ParsecSpec(app, T), 3 + i, CFG16,
                             dest=True, device="cpu")
            for i, app in enumerate(("dedup", "canneal"))]


def _negative(tr):
    return dict(tr, mem_load=-tr["mem_load"] - 1.0)


# entry point -> (call it on two traces, corrupt the traces, who is named)
ENTRY_POINTS = {
    "simulate": (lambda trs: tsim.simulate(trs[0], SIM16, device="cpu"),
                 lambda trs: [_negative(trs[0])], "trace"),
    "sweep_batch": (lambda trs: tsim.sweep_batch(
        trs, SIM16, device="cpu", l_m=np.float32([0.01, 0.02])),
        lambda trs: [trs[0], _negative(trs[1])], "traces[1]"),
    "sweep_topology_batch": (lambda trs: tsim.sweep_topology_batch(
        trs, SIM, device="cpu", **TOPO),
        lambda trs: [trs[0], _negative(trs[1])], "traces[1]"),
    "sweep_topology_batch_stacked": (lambda st: tsim.sweep_topology_batch(
        st, SIM, device="cpu", **TOPO),
        lambda st: _negative(st), "trace"),
    "search_codesign": (lambda trs: pareto.search_codesign(
        trs, SIM, device="cpu", n_chiplets=[8, 16], mesh_radix=[4, 4],
        islands=2, generations=2, population=3, archive=8, seed=1),
        lambda trs: [trs[0], _negative(trs[1])], "traces[1]"),
}


def _inputs(entry):
    trs = _traces16()
    return tsim.stack_traces(trs, pad=True) \
        if entry.endswith("_stacked") else trs


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_one_check_a_call(entry):
    call, _, _ = ENTRY_POINTS[entry]
    inputs = _inputs(entry)
    backend.reset_counters()
    call(inputs)
    assert tsim.engine_stats()["trace_checks"] == {"n": 1, "fallbacks": 0}
    assert tsim.engine_stats()["host_reads"] == {}
    tsim.reset_engine_stats()
    assert tsim.engine_stats()["trace_checks"] == {"n": 0, "fallbacks": 0}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_a_bad_trace_falls_back_and_raises(entry):
    call, corrupt, who = ENTRY_POINTS[entry]
    bad = corrupt(_inputs(entry))
    backend.reset_counters()
    with pytest.raises(ValueError) as got:
        call(bad)
    assert str(got.value).startswith(
        f"{who}['mem_load'] contains negative values (min ")
    assert tsim.engine_stats()["trace_checks"] == {"n": 1, "fallbacks": 1}


@pytest.mark.cuda
def test_a_c256_topology_call_reads_back_once(cuda_device):
    traces = [traffic.generate(traffic.ParsecSpec(app, 100), 40 + i,
                               SIM.cfg.with_topology(n_chiplets=256),
                               dest=True, device=cuda_device)
              for i, app in enumerate(("blackscholes", "swaptions",
                                       "streamcluster", "facesim",
                                       "fluidanimate", "bodytrack",
                                       "canneal", "dedup"))]
    grid = dict(n_chiplets=[c for c in (16, 36, 64, 100, 144, 196, 256)
                            for _ in range(4)],
                gateways_per_chiplet=[1, 2, 3, 4] * 7)
    tsim.sweep_topology_batch(traces, SIM, device=cuda_device, **grid)
    backend.reset_counters()
    out = tsim.sweep_topology_batch(traces, SIM, device=cuda_device, **grid)
    assert out["summary"]["mean_latency"].shape == (8, 28)
    stats = tsim.engine_stats()
    assert stats["trace_checks"] == {"n": 1, "fallbacks": 0}
    assert stats["host_reads"][CHECK_READ]["n"] == 1
    assert sum(r["n"] for r in stats["host_reads"].values()) <= 2
