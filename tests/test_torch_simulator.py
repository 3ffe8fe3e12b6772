"""Simulator parity: the port's public entry points against the JAX
reference on the CPU.

`simulate`, `simulate_batch`, `sweep`, `sweep_batch` and
`simulate_all_archs` for all four architectures, with and without
destination matrices, with ragged batches that include an all-masked lane,
and with fault frames; the port's Figs. 10-12 on reference-made traces
against the reference's benchmark scripts. Traces are made by the reference
and carried across with `interop`; the reference runs its default scan body
(its `SimConfig.epoch_kernel=False`). Tolerance rtol = atol = 1e-6 with integer g and
boolean saturation exact; the figure numbers at 1e-5 relative.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import simulator as jsim
from repro.core import traffic as jtr
from repro_torch import interop
from repro_torch import figures
from repro_torch.core import simulator as tsim
from repro_torch.kernels.epoch_step import cases as ecases

ROOT = Path(__file__).resolve().parents[1]
ARCHS = [a.value for a in jsim.Arch]


def _np(tr):
    return {k: (v if k == "app" else np.asarray(v)) for k, v in tr.items()}


def _traces(lengths=(12, 12, 12), dest=False, seed=0):
    apps = ("blackscholes", "canneal", "facesim", "dedup")
    keys = jax.random.split(jax.random.PRNGKey(seed), len(lengths))
    return [_np(jtr.generate(jtr.ParsecSpec(apps[i % 4], t), k, dest=dest))
            for i, (t, k) in enumerate(zip(lengths, keys))]


def _port(tr):
    return interop.trace_from_numpy(tr, "cpu")


def _cfgs(arch):
    return (jsim.SimConfig().with_arch(jsim.Arch(arch)),
            tsim.SimConfig().with_arch(tsim.Arch(arch)))


def _match(got, want, path=""):
    got = interop.records_to_numpy(got)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        name = f"{path}{k}"
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def _match_out(got, want):
    assert set(got["records"]) == set(want["records"])
    _match(got["records"], want["records"], "records.")
    _match(got["summary"], want["summary"], "summary.")


@pytest.mark.parametrize("dest", [False, True], ids=["uniform", "dest"])
@pytest.mark.parametrize("arch", ARCHS)
def test_simulate(arch, dest):
    tr = _traces((16,), dest=dest, seed=1)[0]
    jc, tc = _cfgs(arch)
    _match_out(tsim.simulate(_port(tr), tc, device="cpu"),
               jsim.simulate(tr, jc))


@pytest.mark.parametrize("dest", [False, True], ids=["uniform", "dest"])
@pytest.mark.parametrize("arch", ARCHS)
def test_simulate_batch_ragged_with_all_masked_lane(arch, dest):
    trs = _traces((12, 16, 9), dest=dest, seed=2)
    # Lane 1 is all masked: a padded trace whose mask is zero throughout.
    trs[1] = dict(trs[1], t_mask=np.zeros(16, np.float32))
    jc, tc = _cfgs(arch)
    want = jsim.simulate_batch(trs, jc)
    got = tsim.simulate_batch([_port(t) for t in trs], tc, device="cpu")
    _match_out(got, want)
    assert float(got["summary"]["valid_intervals"][1]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_sweep(arch):
    tr = _traces((14,), dest=arch == "resipi", seed=3)[0]
    jc, tc = _cfgs(arch)
    grid = dict(l_m=np.float32([0.004, 0.01, 0.0152, 0.02, 0.03, 0.012]),
                max_gateways=np.int32([4, 3, 2, 4, 1, 4]),
                min_gateways=np.int32([1, 1, 2, 2, 1, 3]),
                wavelengths=np.int32([4, 2, 4, 8, 3, 4]),
                prowaves_rho_lo=np.float32([0.3, 0.2, 0.4, 0.1, 0.3, 0.5]))
    _match_out(tsim.sweep(_port(tr), tc, device="cpu", **grid),
               jsim.sweep(tr, jc, **grid))


def test_sweep_buffer_sat():
    """A swept buffer_sat is a traced divisor in the reference (a true
    division, where the port multiplies by the reciprocal): equal at 1e-6
    away from the saturation knee."""
    tr = _traces((12,), seed=4)[0]
    jc, tc = _cfgs("resipi")
    grid = dict(buffer_sat=np.float32([0.45, 0.55, 0.7, 0.9]))
    _match_out(tsim.sweep(_port(tr), tc, device="cpu", **grid),
               jsim.sweep(tr, jc, **grid))


@pytest.mark.parametrize("dest", [False, True], ids=["uniform", "dest"])
@pytest.mark.parametrize("arch", ["resipi", "prowaves"])
def test_sweep_batch_ragged(arch, dest):
    trs = _traces((10, 13, 8), dest=dest, seed=5)
    jc, tc = _cfgs(arch)
    gs = np.int32([1, 2, 3, 4])
    want = jsim.sweep_batch(trs, jc, max_gateways=gs, min_gateways=gs)
    got = tsim.sweep_batch([_port(t) for t in trs], tc, device="cpu",
                           max_gateways=gs, min_gateways=gs)
    _match_out(got, want)
    assert got["records"]["g"].shape == (3, 4, 13, 4)


def test_simulate_all_archs_and_stacked_input():
    tr = _traces((12,), seed=6)[0]
    want = jsim.simulate_all_archs(tr)
    got = tsim.simulate_all_archs(_port(tr), device="cpu")
    assert set(got) == set(want)
    for arch in want:
        _match(got[arch], want[arch], arch + ".")
    trs = _traces((9, 9), seed=7)
    jc, tc = _cfgs("resipi")
    _match_out(tsim.simulate_batch(tsim.stack_traces([_port(t) for t in trs]),
                                   tc, device="cpu"),
               jsim.simulate_batch(jsim.stack_traces(trs), jc))


def _fault_frames(t, seed):
    rng = np.random.RandomState(seed)
    ok = np.ones((t, 4, 4), np.float32)
    ok[3:9, 0, 0] = 0.0
    ok[rng.rand(t, 4, 4) < 0.05] = 0.0
    stuck = np.zeros((t, 4, 4), np.float32)
    stuck[2:10, 1, 3] = 1.0
    drift = np.clip(0.1 * np.arange(t) - 0.3, 0.0, 1.0).astype(np.float32)
    return {"gw_ok": ok, "stuck_on": stuck, "drift_db": drift}


@pytest.mark.parametrize("arch", ARCHS)
def test_fault_frames(arch):
    trs = [dict(t, **_fault_frames(12, i))
           for i, t in enumerate(_traces((12, 12), dest=True, seed=8))]
    jc, tc = _cfgs(arch)
    _match_out(tsim.simulate(_port(trs[0]), tc, device="cpu"),
               jsim.simulate(trs[0], jc))
    _match_out(tsim.simulate_batch([_port(t) for t in trs], tc,
                                   device="cpu"),
               jsim.simulate_batch(trs, jc))


@pytest.mark.parametrize("name", ecases.WIDE_NAMES)
def test_plain_path_past_128_chiplets_matches_the_reference(name):
    """The cases the card holds the "wide" epoch_step design to (144 and
    256 chiplets; clean, destination matrices, a fault frame with them,
    RESIPI_ALL), through `simulate` on the CPU: the plain version equals
    the reference's `simulate` at 1e-6, g and saturation exact."""
    from repro.core.constants import NETWORK as JNET

    case = ecases.wide_case(name, t=24)
    jcfg = jsim.SimConfig(cfg=JNET.with_topology(
        n_chiplets=case.sim.cfg.n_chiplets)).with_arch(
            jsim.Arch(case.sim.arch.value))
    got = tsim.simulate(_port(case.trace), case.sim, device="cpu")
    _match_out(got, jsim.simulate(case.trace, jcfg))


def test_kernel_gate_and_stats_on_cpu(monkeypatch):
    """The gate routes by architecture: RESIPI / RESIPI_ALL runs go through
    the kernel wrapper (its plain version on the CPU), PROWAVES / AWGR and
    a configuration without memory gateways through the plain loop. No
    kernel launches here."""
    from repro_torch.kernels.epoch_step import ops

    routed = []
    real = ops.epoch_run

    def spy(state, xs, sim, *a, **k):
        routed.append(sim.arch)
        return real(state, xs, sim, *a, **k)

    monkeypatch.setattr(ops, "epoch_run", spy)
    tr = _port(_traces((8,), seed=9)[0])
    tsim.reset_engine_stats()
    for arch in tsim.Arch:
        tsim.simulate(tr, tsim.SimConfig().with_arch(arch), device="cpu")
    no_mem = tsim.SimConfig(cfg=dataclasses.replace(tsim.SimConfig().cfg,
                                                    memory_gateways=0))
    tsim.simulate(tr, no_mem, device="cpu")
    assert routed == [tsim.Arch.RESIPI, tsim.Arch.RESIPI_ALL]
    stats = tsim.engine_stats()
    assert stats["loop_runs"] == len(tsim.Arch) + 1
    assert stats["epoch_step_launches"] == 0


def test_input_validation():
    tr = _port(_traces((6,), seed=10)[0])
    with pytest.raises(ValueError, match="non-sweepable"):
        tsim.sweep(tr, tsim.SimConfig(), device="cpu", mesh_x=[1, 2])
    with pytest.raises(ValueError, match="equal length"):
        tsim.sweep(tr, tsim.SimConfig(), device="cpu", l_m=[0.01, 0.02],
                   max_gateways=[4])
    with pytest.raises(ValueError, match="mixed lengths"):
        tsim.stack_traces([tr, _port(_traces((7,), seed=11)[0])])
    partial = dict(tr, gw_ok=np.ones((6, 4, 4), np.float32))
    with pytest.raises(ValueError, match="missing"):
        tsim.simulate(partial, tsim.SimConfig(), device="cpu")


def test_float64_inputs_are_cast_to_float32():
    """numpy float64 traces and grids run as float32, as in the reference
    (a float64 grid would shift controller decisions)."""
    tr = _traces((10,), seed=12)[0]
    tr64 = {k: (v.astype(np.float64) if isinstance(v, np.ndarray) else v)
            for k, v in tr.items()}
    got = tsim.sweep(tr64, tsim.SimConfig(), device="cpu",
                     l_m=np.linspace(0.004, 0.03, 5))
    want = jsim.sweep(tr, jsim.SimConfig(), l_m=np.linspace(0.004, 0.03, 5))
    _match_out(got, want)
    assert got["records"]["latency"].dtype == torch.float32


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    tr = _port(_traces((4,), seed=13)[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.simulate(tr, tsim.SimConfig())
    with pytest.raises(RuntimeError):
        interop.trace_from_numpy(_traces((4,), seed=13)[0])
    from repro_torch.core import traffic as ttr
    with pytest.raises(RuntimeError):
        ttr.generate("dedup", 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.destination_matrix_torch("dedup")
    from repro_torch.core import gateway_controller as tgc
    from repro_torch.core import selection as tsel
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsel.selection_tables_torch()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgc.ControllerState.init(4, tgc.ControllerConfig())


def test_fig10_matches_benchmark(monkeypatch):
    from benchmarks import fig10_lm_dse
    monkeypatch.setattr(fig10_lm_dse, "save_json", lambda *a, **k: None)
    want = fig10_lm_dse.run(n_intervals=16, seed=7)
    traces = jtr.all_app_traces(16, seed=7)
    got = figures.fig10_dse([_port(_np(traces[a])) for a in traces],
                            device="cpu")
    assert got["n_accepted"] == want["n_accepted"]
    np.testing.assert_allclose(got["l_m_selected"], want["l_m_selected"],
                               rtol=1e-5)
    for p, q in zip(got["points"], want["points"]):
        assert (p["app"], p["g"]) == (q["app"], q["g"])
        np.testing.assert_allclose([p["load"], p["latency"]],
                                   [q["load"], q["latency"]], rtol=1e-5)


def test_fig11_matches_benchmark(monkeypatch):
    from benchmarks import fig11_main
    monkeypatch.setattr(fig11_main, "save_json", lambda *a, **k: None)
    want = fig11_main.run(n_intervals=16, seed=1)
    traces = {app: _port(_np(jtr.generate_trace(app, 16,
                                                jax.random.PRNGKey(1))))
              for app in jtr.APP_NAMES}
    got = figures.fig11_main(traces, device="cpu")
    for k, v in want["summary"].items():
        if k != "paper_claims":
            np.testing.assert_allclose(got["summary"][k], v, rtol=1e-5,
                                       err_msg=k)
    for app in want["per_app"]:
        for arch in want["per_app"][app]:
            for k, v in want["per_app"][app][arch].items():
                np.testing.assert_allclose(got["per_app"][app][arch][k], v,
                                           rtol=1e-5, atol=1e-6)


def test_fig12_matches_benchmark(monkeypatch):
    from benchmarks import fig12_adaptivity
    monkeypatch.setattr(fig12_adaptivity, "save_json",
                        lambda *a, **k: None)
    per_app = 24
    want = fig12_adaptivity.run(per_app=per_app, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    tr = _np(jtr.concat_traces([jtr.generate_trace(a, per_app, k)
                                for a, k in zip(figures.FIG12_SEQUENCE,
                                                keys)]))
    got = figures.fig12_adaptivity(_port(tr), per_app=per_app, device="cpu")
    assert got["adaptation"] == want["adaptation"]
    assert got["max_gateways_used"] == want["max_gateways_used"]
    np.testing.assert_array_equal(got["gateways_resipi"],
                                  want["gateways_resipi"])
    for k in ("latency_resipi", "latency_prowaves", "power_resipi",
              "power_prowaves", "wavelengths_prowaves"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
                f"{f.relative_to(ROOT)} imports {mod}"


def test_port_imports_and_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.figures, repro_torch.interop\n"
        "import repro_torch.kernels.epoch_step.ops\n"
        "import repro_torch.core.distributed, repro_torch.launch.fleet\n"
        "import repro_torch.launch.mesh, repro_torch.sharding.rules\n"
        "import repro_torch.runtime.cache\n"
        "from repro_torch.core import reconfig_runtime\n"
        "from repro_torch.core import simulator as s, traffic as t\n"
        "from repro_torch.kernels.noc_step import ops as noc\n"
        "from repro_torch import random as r\n"
        "tr = t.generate('dedup', 0, device='cpu')\n"
        "out = s.simulate(tr, s.SimConfig(), device='cpu')\n"
        "assert out['records']['g'].shape == (64, 4)\n"
        "u = r.uniform(r.split(r.prng_key(5, device='cpu'), 2), (3, 4))\n"
        "assert u.shape == (2, 3, 4)\n"
        "m, drained = noc.simulate_residency(0.1, 2, 4, cycles=64, "
        "device='cpu')\n"
        "assert m.shape == (4, 4) and drained >= 0\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("dest", [False, True], ids=["uniform", "dest"])
@pytest.mark.parametrize("arch", ["resipi", "prowaves"])
def test_simulate_eager_matches_the_reference(arch, dest):
    tr = _traces((14,), dest=dest, seed=21)[0]
    jc, tc = _cfgs(arch)
    got = tsim.simulate_eager(_port(tr), tc, device="cpu")
    _match_out(got, jsim.simulate_eager(tr, jc))
    # The same run as `simulate`, its tables rebuilt.
    same = tsim.simulate(_port(tr), tc, device="cpu")
    for part in ("records", "summary"):
        for k, v in same[part].items():
            assert torch.equal(got[part][k], v), k


def test_clear_engine_caches_drops_every_device_table():
    from repro_torch.core import pareto as tpar
    from repro_torch.core import selection as tsel
    from repro_torch.core import topology as ttopo
    from repro_torch.core.traffic import dest as tdest

    tr = _port(_traces((6,), dest=True, seed=22)[0])
    sim = tsim.SimConfig()
    tsim.simulate(tr, sim, device="cpu")
    tsim.sweep_topology(tr, sim, n_chiplets=[2, 4], device="cpu")
    tsim.search_placement(tr, sim, generations=1, population=2,
                          device="cpu")
    tsim.search_codesign(tr, sim, n_chiplets=[2, 4], islands=1,
                         generations=1, population=2, device="cpu")
    tdest.destination_matrix_torch("dedup", device="cpu")
    caches = (tsel._selection_tables_torch_cached,
              tsel._padded_tables_torch_cached,
              tsel._build_selection_tables_padded_cached,
              ttopo._lut_tensors, tpar._codesign_topology,
              tdest._destination_matrix_torch, tdest._destination_matrix)
    assert all(c.cache_info().currsize > 0 for c in caches)
    builds = tsim.engine_stats()["selection_table_builds"]
    tsim.clear_engine_caches()
    assert [c.cache_info().currsize for c in caches] == [0] * len(caches)
    # The design-time tables stay memoized, as in the reference.
    assert tsim.engine_stats()["selection_table_builds"] == builds
    jsim.clear_engine_caches()
    out = tsim.simulate(tr, sim, device="cpu")
    assert out["summary"]["mean_latency"].shape == ()
