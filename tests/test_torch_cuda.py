"""Card-only tests: the hand-written `epoch_step`, `noc_step`,
`flash_attention` and `ssd_scan` CUDA kernels against their plain PyTorch
versions on the same CUDA inputs.

Marked `cuda`; each test asks the `cuda_device` fixture for the card and
skips without one. Run them on a machine with a card and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The cases are those of `chip_smoke.py` phase 2 at a smaller size (the
`noc_step` ones come from the same builder, `kernels/noc_step/cases.py`). For
`epoch_step`, each case through both designs ("split", which the wrapper
picks, and "warp"): clean, destination matrices, a ragged `t_mask` batch
with an all-masked lane, fault frames, and a sweep over the five kernel
knobs, plus 1 and 12 chiplets, each also through the "wide" design; the
cases past 128 chiplets (`kernels/epoch_step/cases.py`: 144 and 256,
clean, destination matrices, a fault frame, RESIPI_ALL) through "wide",
which `simulate` picks there; records and final state agree at
rtol = atol = 1e-6 (the reference's bound for this kernel), integer g and
boolean saturation exactly. For `noc_step` (T <= 1024), each case through
the "node" kernel and the "warp" kernel, which must agree bit for bit:
Fig. 13's two topologies, a padded topology with garbage in its dead
lanes, a lane dying mid-run, an all-ones `valid_mask_t`, a ragged
`t_mask`, `hex_config(2)` and a batch of mixed-T runs at rtol 1e-5, atol
1e-3 of the plain version (the in-edge sums run in another order than the
plain version's products); dead lanes exactly 0, a batch bitwise its
single runs, and the wrappers' refusals; the 12 x 12 and 16 x 16 meshes
(148 and 260 nodes) through the node kernel alone. Streaming on the card:
a chunked session equals a one-shot `simulate` and a `session_tick` lane a
standalone session, bit for bit, and `sweep_faults` the plain version. For `flash_attention` and
`ssd_scan`: the shared cases of `kernels/flash_attention/cases.py` and
`kernels/ssd_scan/cases.py` (chip_smoke.py's phase 2) at the reference's
bounds (flash 2e-5 in float32, 3e-2 in bfloat16; SSD float32 outputs 1e-4,
2e-4 at chunk 128), each launch counted once under the kernel variant that
`ops.variant` picks (the tensor-core kernel for the bf16 cases it takes,
among them a causal S of 2049, 10 heads a group and a chunk of 64; the
SIMT kernel for the rest); the SIMT kernel forced on the tensor-core
kernel's inputs; the wrappers' refusals, and the two smoke models served on
the card against the same models on the CPU. Padded calls (one topology per
lane, `kernels/epoch_step/cases.py`: 9, 16 and 144 chiplets, clean,
destination matrices and a ragged t_mask) through every design that takes
topology rows against the padded plain loop; an unpadded launch bit for bit
the same launch through topology rows holding its constants; and
`sweep_topology` on the card against the CPU and against `simulate`. The
device placement search (one chain, blocked routers, islands with
destination matrices, 32 chiplets) on the card against the same search on
the CPU, its generation loop under `set_sync_debug_mode("error")`; the
Pareto co-design on both engines (the reference test's `CODESIGN_KW` and a
grid whose mesh radix changes, with a destination matrix) against the
same searches on the CPU, every launch against the padded plain loop.
Serving on the card: a `session_tick` leaves the carry it was given
unchanged, a `SessionServer` fed traces made on the card launches once per
dispatch and every served session replays exactly, and the two serving
walkthroughs take the CPU's heal decisions. Fleet and caching on the card:
`sweep_workload`, `shard_sweep`, `search_placement_islands` and
`search_codesign` over emulated devices of the card (`["cuda:0"] * n`)
bitwise the one-device calls, `laned_all_reduce` over a 1-rank NCCL group,
and a memoized entry point the plain call. Training on the card: the flash
and SSD ops under autograd (one kernel launch forward, the plain VJP
backward, gradients at the plain autograd's) and a smoke model's
gradients in float32 compute against the CPU's, with the kernels launched
twice a layer (forward and rematerialization). This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import simulator as tsim
from repro_torch.core import traffic
from repro_torch.kernels.epoch_step import cases as ecases
from repro_torch.kernels.epoch_step import ops
from repro_torch.kernels.epoch_step.ref import epoch_run_reference
from repro_torch.kernels.noc_step import cases as noc_cases
from repro_torch.kernels.noc_step import ops as nops
from repro_torch.kernels.noc_step.ref import reference_noc_run
from repro_torch.kernels.flash_attention import cases as flash_cases
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import cases as ssd_cases
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import reference_intra_chunk

pytestmark = pytest.mark.cuda

T = 48
ARCHS = [tsim.Arch.RESIPI, tsim.Arch.RESIPI_ALL]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run `python -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on a machine with a card")
    return torch.device("cuda")


def _compare(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        a, b = got[k], want[k]
        assert a.shape == b.shape, k
        if b.dtype in (torch.bool, torch.int32, torch.int64):
            assert a.dtype == b.dtype, k
            assert torch.equal(a, b), k
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=k)


def _state(s) -> dict:
    return {"g": s.ctl.g, "packets_seen": s.ctl.packets_seen,
            "epoch": s.ctl.epoch, "wavelengths": s.wavelengths,
            "prev_active": s.prev_active}


def _traces(case: str, dev) -> list:
    apps = traffic.APP_NAMES[:4]
    dest = case in ("dest", "faults", "sweep")
    lengths = (T, 31, 17, T) if case == "ragged" else (T,) * 4
    out = []
    for i, (app, t) in enumerate(zip(apps, lengths)):
        out.append(traffic.generate(traffic.ParsecSpec(app, t), 40 + i,
                                    dest=dest, device=dev))
    if case == "ragged":
        out[3] = dict(out[3], t_mask=torch.zeros(T, device=dev))
    if case == "faults":
        rng = np.random.RandomState(5)
        for i, tr in enumerate(out):
            ok = np.ones((T, 4, 4), np.float32)
            ok[8:20, 1, 0] = 0.0
            ok[rng.rand(T, 4, 4) < 0.03] = 0.0
            stuck = np.zeros((T, 4, 4), np.float32)
            stuck[4:30, 2, 3] = 1.0
            drift = np.clip(0.05 * np.arange(T) - 0.5, 0.0,
                            1.0).astype(np.float32)
            out[i] = dict(tr, gw_ok=torch.as_tensor(ok, device=dev),
                          stuck_on=torch.as_tensor(stuck, device=dev),
                          drift_db=torch.as_tensor(drift, device=dev))
    return out


def _run_variant(kernel, state0, xs, sim, tables, kw):
    """`ops.epoch_run` where the wrapper picks `kernel` itself, the raw
    launch of `kernel` reassembled otherwise; one launch counted either
    way."""
    from repro_torch import backend

    backend.reset_counters()
    if kernel == ops.variant(xs[0].shape[2], kw["faulted"],
                             kw["dest"] is not None, state0.ctl.g.shape[0]):
        out = ops.epoch_run(state0, xs, sim, tables, **kw)
    else:
        out = ops._reassemble(state0, ops.launch(state0.ctl.g, xs, sim,
                                                 tables, kernel=kernel, **kw),
                              xs, sim, kw["faulted"])
    torch.cuda.synchronize()
    assert backend.COUNTERS["launches"] == {"epoch_step": 1}
    assert backend.COUNTERS["variants"] == {f"epoch_step:{kernel}": 1}
    return out


@pytest.mark.parametrize("kernel", ["split", "warp", "wide"])
@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.value)
@pytest.mark.parametrize("case", ["clean", "dest", "ragged", "faults",
                                  "sweep"])
def test_kernel_matches_plain(case, arch, kernel, cuda_device):
    sim = tsim.SimConfig().with_arch(arch)
    grid = {}
    if case == "sweep":
        rng = np.random.RandomState(9)
        grid = {"l_m": rng.uniform(0.004, 0.032, 16).astype(np.float32),
                "max_gateways": rng.randint(2, 5, 16).astype(np.int32),
                "min_gateways": rng.randint(1, 3, 16).astype(np.int32),
                "buffer_sat": rng.uniform(0.45, 0.95, 16).astype(np.float32),
                "wavelengths": rng.randint(2, 9, 16).astype(np.int32)}
    traces = _traces(case, cuda_device)
    state0, xs, tables, kw = tsim.epoch_inputs(traces, sim,
                                               device=cuda_device, **grid)
    assert ops.variant(xs[0].shape[2], kw["faulted"],
                       kw["dest"] is not None,
                       state0.ctl.g.shape[0]) == "split"
    got_state, got = _run_variant(kernel, state0, xs, sim, tables, kw)
    want_state, want = epoch_run_reference(state0, xs, sim, tables, **kw)
    _compare(got, want)
    _compare(_state(got_state), _state(want_state))
    if case == "ragged":
        for k, v in _state(state0).items():
            assert torch.equal(_state(got_state)[k][3], v[3]), k


@pytest.mark.parametrize("arch", list(tsim.Arch), ids=lambda a: a.value)
def test_entry_points_on_the_card_match_the_cpu(arch, cuda_device):
    """simulate / sweep_batch on the card (kernel for RESIPI/RESIPI_ALL,
    plain loop for PROWAVES/AWGR) equal the CPU run of the same traces."""
    sim = tsim.SimConfig().with_arch(arch)
    traces = _traces("dest", cuda_device)
    cpu = [{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in tr.items()} for tr in traces]
    tsim.reset_engine_stats()
    got = tsim.simulate(traces[0], sim)
    want = tsim.simulate(cpu[0], sim, device="cpu")
    stats = tsim.engine_stats()
    kernel = arch in tsim.KERNEL_ARCHS
    assert stats["epoch_step_launches"] == int(kernel)
    assert stats["loop_runs"] == (1 if kernel else 2)
    for part in ("records", "summary"):
        _compare({k: v.cpu() for k, v in got[part].items()}, want[part])
    gs = np.int32([1, 2, 3, 4])
    got = tsim.sweep_batch(traces, sim, max_gateways=gs, min_gateways=gs)
    want = tsim.sweep_batch(cpu, sim, device="cpu", max_gateways=gs,
                            min_gateways=gs)
    for part in ("records", "summary"):
        _compare({k: v.cpu() for k, v in got[part].items()}, want[part])


@pytest.mark.parametrize("kernel", ["split", "warp", "wide"])
@pytest.mark.parametrize("chiplets", [1, 12])
def test_kernel_matches_plain_at_other_widths(chiplets, kernel,
                                              cuda_device):
    """One chiplet and twelve (the split's 16-chiplet instantiation), with
    destination matrices and fault frames, RESIPI."""
    from repro_torch.core.constants import NETWORK

    cfg = NETWORK.with_topology(n_chiplets=chiplets)
    sim = tsim.SimConfig(cfg=cfg)
    rng = np.random.RandomState(chiplets)
    traces = []
    for i, app in enumerate(traffic.APP_NAMES[:3]):
        tr = traffic.generate(traffic.ParsecSpec(app, T), 60 + i, cfg,
                              dest=True, device=cuda_device)
        g = cfg.max_gateways_per_chiplet
        traces.append(dict(tr, **{k: torch.as_tensor(v, device=cuda_device)
                                  for k, v in (
            ("gw_ok", (rng.rand(T, chiplets, g) > 0.1).astype(np.float32)),
            ("stuck_on", (rng.rand(T, chiplets, g) > 0.95)
             .astype(np.float32)),
            ("drift_db", np.clip(0.05 * np.arange(T) - 0.5, 0.0, 1.0)
             .astype(np.float32)))}))
    state0, xs, tables, kw = tsim.epoch_inputs(traces, sim,
                                               device=cuda_device)
    got_state, got = _run_variant(kernel, state0, xs, sim, tables, kw)
    want_state, want = epoch_run_reference(state0, xs, sim, tables, **kw)
    _compare(got, want)
    _compare(_state(got_state), _state(want_state))


def test_wrapper_rejects_what_the_kernel_does_not_run(cuda_device):
    sim = tsim.SimConfig().with_arch(tsim.Arch.PROWAVES)
    state0, xs, tables, kw = tsim.epoch_inputs(_traces("clean",
                                                       cuda_device)[:1],
                                               sim, device=cuda_device)
    with pytest.raises(ValueError, match="RESIPI"):
        ops.epoch_run(state0, xs, sim, tables, **kw)
    sim = tsim.SimConfig()
    state0, xs, tables, kw = tsim.epoch_inputs(_traces("clean",
                                                       cuda_device)[:1],
                                               sim, device=cuda_device)
    with pytest.raises(ValueError, match="does not take"):
        ops.launch(state0.ctl.g, xs, sim, tables, kernel="lane", **kw)
    # Past the cap (1024 chiplets) the wrapper raises, naming it.
    c = ops.MAX_CHIPLETS + 1
    wide = tsim.SimConfig(cfg=tsim.NETWORK.with_topology(n_chiplets=c))
    z = torch.zeros((1, 4, c), device=cuda_device)
    o = torch.ones((1, 4), device=cuda_device)
    with pytest.raises(ValueError, match=str(ops.MAX_CHIPLETS)):
        ops.launch(torch.ones((1, c), device=cuda_device), (z, o, z, o, o),
                   wide, tables)


PADDED_DESIGNS = [(name, design) for name in ecases.PADDED_NAMES
                  for design in ("split", "wide")
                  if design == "wide" or int(name[3:].split("-")[0])
                  <= ops.SPLIT_MAX_CHIPLETS]


def _padded_inputs(name, arch, dev):
    case = ecases.padded_case(name, T, arch)
    traces = [interop.trace_from_numpy(t, dev) for t in case.traces]
    return tsim.topology_inputs(traces, case.sim, device=dev, **case.grid)


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.value)
@pytest.mark.parametrize("name,design", PADDED_DESIGNS)
def test_padded_kernel_matches_the_padded_plain_loop(name, design, arch,
                                                     cuda_device):
    """One topology per lane (9, 16 and 144 chiplets; clean, destination
    matrices, ragged t_mask with an all-masked trace): every design that
    takes topology rows equals the padded plain loop, integer g and the
    final state exactly, padded chiplet columns exactly 0."""
    from repro_torch import backend

    sim_p, state0, xs, kw, _ = _padded_inputs(name, arch, cuda_device)
    backend.reset_counters()
    got_state, got = ops._reassemble(
        state0, ops.launch(state0.ctl.g, xs, sim_p, None, kernel=design,
                           **kw), xs, sim_p, False, kw["topo"])
    torch.cuda.synchronize()
    assert backend.COUNTERS["variants"] == {f"epoch_step:{design}+topo": 1}
    want_state, want = epoch_run_reference(state0, xs, sim_p, None, **kw)
    _compare(got, want)
    _compare(_state(got_state), _state(want_state))
    mask = kw["topo"]["chip_mask"][:, None, :] == 0
    for k in ("g", "gw_load", "wavelengths"):
        assert torch.all(got[k].masked_select(mask) == 0), k


def test_padded_calls_never_run_warp(cuda_device):
    """17-128 chiplets: `variant` sends padded calls to "wide", and the
    warp kernel refuses topology rows."""
    assert ops.variant(64, False, False, 32768, padded=True) == "wide"
    assert ops.variant(64, False, False, 32768) == "warp"
    sim_p, state0, xs, kw, _ = _padded_inputs("pad9-clean", ARCHS[0],
                                              cuda_device)
    with pytest.raises(ValueError, match="warp kernel takes no topology"):
        ops.launch(state0.ctl.g, xs, sim_p, None, kernel="warp", **kw)


@pytest.mark.parametrize("design", ["split", "wide"])
def test_padded_matrices_read_their_pair_trace(design, cuda_device):
    """The destination matrices in reverse order (matrix p no longer that
    of trace p): each design reads each matrix's trace from `pair_trace`
    and still equals the padded plain loop; `dest_index` without
    `pair_trace` raises."""
    sim_p, state0, xs, kw, _ = _padded_inputs("pad16-dest", ARCHS[0],
                                              cuda_device)
    p = int(kw["dest"].shape[0])
    rev = torch.arange(p - 1, -1, -1, device=cuda_device)
    perm = dict(kw, dest=kw["dest"][rev], pair_trace=kw["pair_trace"][rev],
                dest_index=(p - 1) - kw["dest_index"])
    assert not torch.equal(perm["pair_trace"],
                           torch.sort(perm["pair_trace"]).values)
    got_state, got = ops._reassemble(
        state0, ops.launch(state0.ctl.g, xs, sim_p, None, kernel=design,
                           **perm), xs, sim_p, False, kw["topo"])
    want_state, want = epoch_run_reference(state0, xs, sim_p, None, **kw)
    _compare(got, want)
    _compare(_state(got_state), _state(want_state))
    with pytest.raises(ValueError, match="go together"):
        ops.launch(state0.ctl.g, xs, sim_p, None, kernel=design,
                   **dict(kw, pair_trace=None))


@pytest.mark.parametrize("design", ["split", "wide"])
@pytest.mark.parametrize("dest", [False, True], ids=["uniform", "dest"])
def test_unpadded_launch_equals_its_topology_rows_bitwise(dest, design,
                                                          cuda_device):
    """An unpadded launch (null topology pointers: the launch constants)
    gives bit for bit what the same launch gives through topology rows
    that hold those constants."""
    from repro_torch.core import topology
    from repro_torch.core.noc import uniform_mesh_mean_hops
    from repro_torch.core.photonics import controller_mw

    sim = tsim.SimConfig()
    cfg = sim.cfg
    state0, xs, tables, kw = tsim.epoch_inputs(
        _traces("dest" if dest else "clean", cuda_device), sim,
        device=cuda_device)
    b = int(state0.ctl.g.shape[0])
    assert float(controller_mw(torch.tensor([cfg.n_chiplets]))) \
        == float(np.float32(controller_mw(cfg.n_chiplets)))
    f32 = dict(dtype=torch.float32, device=cuda_device)
    rows = {"n_chiplets": torch.full((b,), cfg.n_chiplets, dtype=torch.int32,
                                     device=cuda_device),
            "src_hops": tables["src_hops"].expand(b, -1),
            "gw_loss_db": tables["gw_loss_db"].expand(b, -1),
            "mesh_hops": torch.full(
                (b,), float(np.float32(uniform_mesh_mean_hops(cfg))), **f32),
            "mesh_x": torch.full((b,), topology.feed_width(cfg), **f32)}
    plain = ops.launch(state0.ctl.g, xs, sim, tables, kernel=design, **kw)
    padded = ops.launch(state0.ctl.g, xs, sim, tables, kernel=design,
                        topo=rows, **kw)
    torch.cuda.synchronize()
    for k in ("scal", "g_eff", "gw_load", "g_final"):
        assert torch.equal(plain[k], padded[k]), k


@pytest.mark.parametrize("arch", list(tsim.Arch), ids=lambda a: a.value)
def test_sweep_topology_on_the_card(arch, cuda_device):
    """The entry points on the card: a point padded to its own size equals
    an unpadded `simulate` of that topology, and the grid equals the CPU
    run; one epoch_step launch per call for RESIPI / RESIPI_ALL."""
    case = ecases.padded_case("pad16-dest", T, tsim.Arch(arch))
    tr = interop.trace_from_numpy(case.traces[0], cuda_device)
    cpu = interop.trace_from_numpy(case.traces[0], "cpu")
    tsim.reset_engine_stats()
    got = tsim.sweep_topology(tr, case.sim, **case.grid)
    assert tsim.engine_stats()["epoch_step_launches"] \
        == int(arch in tsim.KERNEL_ARCHS)
    want = tsim.sweep_topology(cpu, case.sim, device="cpu", **case.grid)
    for part in ("records", "summary"):
        _compare({k: v.cpu() for k, v in got[part].items()}, want[part])
    own = tsim.sweep_topology(tr, case.sim, n_chiplets=[16])
    single = tsim.simulate(tr, tsim.topology_point_config(case.sim,
                                                          n_chiplets=16))
    for part in ("records", "summary"):
        _compare({k: v[0] for k, v in own[part].items()}, single[part])


SEARCH_CARD_CASES = {
    # (chiplets, destination matrix, islands, search keywords)
    "single": (4, False, None, dict(generations=4, population=6, seed=1)),
    "blocked": (4, False, None, dict(
        generations=3, population=5, seed=2,
        init=((1, 1), (2, 2), (1, 2), (2, 1)),
        blocked_positions=[(1, 0), (3, 1)])),
    "islands": (4, True, 3, dict(generations=4, population=6, seed=3,
                                 l_m=[0.008, 0.012, 0.02])),
    "wide": (32, True, 2, dict(generations=3, population=4, seed=0)),
}


@pytest.mark.parametrize("case", list(SEARCH_CARD_CASES))
def test_device_search_on_the_card_matches_the_cpu(case, cuda_device,
                                                   monkeypatch):
    """The device placement search on the card: the same placements and
    accepted flags as on the CPU, scores at 1e-6; one epoch_step launch
    per generation, islands included, and one `search_dispatches`; the
    generation loop raises nothing under set_sync_debug_mode("error")."""
    from repro_torch import backend
    from repro_torch.core import search as tsearch
    from repro_torch.core.constants import NETWORK

    c, dest, islands, kw = SEARCH_CARD_CASES[case]
    cfg = NETWORK.with_topology(n_chiplets=c)
    sim = tsim.SimConfig(cfg=cfg)
    trace = traffic.generate(traffic.ParsecSpec("dedup", 16), 7, cfg,
                             dest=dest, device=cuda_device)
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v
           for k, v in trace.items()}
    real_core = tsearch._search_core

    def checked_core(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_core(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def run(tr, device):
        if islands is None:
            return tsim.search_placement(tr, sim, device=device, **kw)
        return tsim.search_placement_islands(tr, sim, islands=islands,
                                             device=device, **kw)

    monkeypatch.setattr(tsearch, "_search_core", checked_core)
    tsim.reset_engine_stats()
    got = run(trace, cuda_device)
    assert backend.COUNTERS["launches"] == {"epoch_step": kw["generations"]}
    assert set(backend.COUNTERS["variants"]) == {
        "epoch_step:" + ("split" if c <= ops.SPLIT_MAX_CHIPLETS
                         else "wide") + "+topo"}
    assert tsim.engine_stats()["search_dispatches"] == 1
    want = run(cpu, "cpu")
    keys = ["best_placement", "default_placement"] + (
        ["incumbent_placement"] if islands is None
        else ["island_best_placements", "island_incumbents", "best_island"])
    for key in keys:
        assert got[key] == want[key], key
    for key in ("best_score", "default_score") + (
            () if islands is None
            else ("island_best_scores", "island_default_scores")):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                   err_msg=key)
    if islands is None:
        assert [h["accepted"] for h in got["history"]] \
            == [h["accepted"] for h in want["history"]]
    else:
        np.testing.assert_array_equal(got["history"]["accepted"],
                                      want["history"]["accepted"])


CODESIGN_CARD_CASES = {
    # (apps, intervals, destination matrices, search keywords)
    "codesign_kw": (("dedup", "streamcluster"), 6, False, dict(
        n_chiplets=[8, 16], mesh_radix=[4, 4], islands=2, generations=3,
        population=3, archive=16, knob_grids={"l_m": [0.01, 0.02]},
        seed=1)),
    "radix": (("canneal",), 8, True, dict(
        n_chiplets=[4, 8, 16], mesh_radix=[3, 4, 5], islands=3,
        generations=4, population=4, archive=4, migrate_every=1, seed=0)),
}


@pytest.mark.parametrize("engine", ["device", "host"])
@pytest.mark.parametrize("case", list(CODESIGN_CARD_CASES))
def test_codesign_on_the_card_matches_the_cpu(case, engine, cuda_device,
                                              monkeypatch):
    """Pareto co-design on the card: every launch equals the padded plain
    loop on its inputs, the device engine makes one launch per generation
    (every point's chains at once) and one `search_dispatches`, its
    generation loop raising nothing under set_sync_debug_mode("error"),
    and the front (placements, points, islands, knobs), the archive-size
    history and the island incumbents equal the CPU's, objectives and
    scores at 1e-6."""
    from repro_torch import backend
    from repro_torch.core import pareto as tpar
    from repro_torch.core.constants import NETWORK
    from repro_torch.kernels.epoch_step.ref import epoch_run_reference

    apps, t_len, dest, kw = CODESIGN_CARD_CASES[case]
    cfg = NETWORK.with_topology(n_chiplets=max(kw["n_chiplets"]))
    sim = tsim.SimConfig()
    traces = [traffic.generate(traffic.ParsecSpec(a, t_len), i, cfg,
                               dest=dest, device=cuda_device)
              for i, a in enumerate(apps)]
    cpu = [{k: v.cpu() if isinstance(v, torch.Tensor) else v
            for k, v in tr.items()} for tr in traces]
    real_core, real_run = tpar._codesign_core, ops.epoch_run
    calls = []

    def checked_core(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_core(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def recorded_run(state, xs, csim, tables, **k):
        out = real_run(state, xs, csim, tables, **k)
        calls.append((state, xs, csim, tables, k, out))
        return out

    monkeypatch.setattr(tpar, "_codesign_core", checked_core)
    monkeypatch.setattr(ops, "epoch_run", recorded_run)
    tsim.reset_engine_stats()
    got = tsim.search_codesign(traces, sim, engine=engine,
                               device=cuda_device, **kw)
    monkeypatch.setattr(ops, "epoch_run", real_run)
    n_pts, gens = len(kw["n_chiplets"]), kw["generations"]
    assert backend.COUNTERS["launches"] == {
        "epoch_step": gens if engine == "device" else n_pts * gens}
    assert tsim.engine_stats()["search_dispatches"] == int(
        engine == "device")
    if engine == "device":
        _, xs = calls[0][:2]
        lanes = n_pts * kw["islands"] * kw["population"] * len(apps)
        assert backend.COUNTERS["variants"] == {
            "epoch_step:" + ops.variant(xs[0].shape[-1], False, dest, lanes,
                                        padded=True) + "+topo": gens}
    for state0, xs, csim, tables, k, (st, recs) in calls:
        want_st, want_recs = epoch_run_reference(state0, xs, csim, tables,
                                                 **k)
        _compare(recs, want_recs)
        _compare(_state(st), _state(want_st))
    want = tsim.search_codesign(cpu, sim, engine=engine, device="cpu", **kw)
    assert len(got["front"]) == len(want["front"]) > 0
    for g, w in zip(got["front"], want["front"]):
        for key in ("placement", "topology", "knobs", "island"):
            assert g[key] == w[key], key
        np.testing.assert_allclose(list(g["objectives"].values()),
                                   list(w["objectives"].values()),
                                   rtol=1e-6)
    np.testing.assert_array_equal(got["history"]["archive_size"],
                                  want["history"]["archive_size"])
    assert got["island_incumbents"] == want["island_incumbents"]
    np.testing.assert_allclose(got["island_scores"], want["island_scores"],
                               rtol=1e-6)


@pytest.mark.parametrize("name", ecases.WIDE_NAMES)
def test_wide_design_past_128_chiplets(name, cuda_device):
    """144 and 256 chiplets: `simulate` runs the "wide" design (one
    launch), and the kernel equals the plain version on the same inputs at
    1e-6 with g, saturation and state exact."""
    from repro_torch import backend, interop

    case = ecases.wide_case(name, t=T)
    trace = interop.trace_from_numpy(case.trace, cuda_device)
    backend.reset_counters()
    out = tsim.simulate(trace, case.sim)
    torch.cuda.synchronize()
    assert backend.COUNTERS["variants"] == {"epoch_step:wide": 1}
    state0, xs, tables, kw = tsim.epoch_inputs(trace, case.sim,
                                               device=cuda_device)
    got_state, got = _run_variant("wide", state0, xs, case.sim, tables, kw)
    want_state, want = epoch_run_reference(state0, xs, case.sim, tables,
                                           **kw)
    _compare(got, want)
    _compare(_state(got_state), _state(want_state))
    for k, v in want.items():
        assert torch.equal(out["records"][k][None], got[k]), k


# ---------------------------------------------------------------------------
# noc_step: the flit-level kernel against its plain version
# ---------------------------------------------------------------------------

NOC_T = 1024
NOC_NAMES = [n for n in noc_cases.NAMES if n != "batch-mixed-T"]


def _noc_case(name: str, dev, t: int = NOC_T):
    """One of the shared kernel-against-plain cases (also chip_smoke.py's),
    at T = `t`."""
    return noc_cases.kernel_cases(dev, t, names=[name])[0]


@pytest.mark.parametrize("case", NOC_NAMES)
def test_noc_kernel_matches_plain(case, cuda_device):
    from repro_torch import backend

    c = _noc_case(case, cuda_device)
    backend.reset_counters()
    got = nops.noc_run(*c.args, **c.kwargs)
    torch.cuda.synchronize()
    assert backend.COUNTERS["launches"] == {"noc_step": 1}
    assert backend.COUNTERS["variants"] == {"noc_step:node": 1}
    want = reference_noc_run(*c.args, **c.kwargs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)
    noc_cases.check_case(c, got, nops.noc_run)
    _assert_warp_bitwise(c, got)


def _assert_warp_bitwise(c, got):
    """The warp kernel on the case's inputs gives the node kernel's result
    bit for bit."""
    batched = c.args[0].dim() == 3
    warp = nops.run_prepared(nops.prepare(
        c.args[0] if batched else c.args[0][None], *c.args[1:], **c.kwargs),
        kernel="warp")
    for a, b in zip(got, warp):
        assert torch.equal(a if batched else a[None], b)


def test_noc_kernel_batch_is_bitwise_the_single_runs(cuda_device):
    """Runs of mixed T padded with t_mask, mixed topologies padded with
    dead lanes: one launch matches the plain version and equals the runs
    one by one, bitwise."""
    c = _noc_case("batch-mixed-T", cuda_device)
    got = nops.noc_run(*c.args, **c.kwargs)
    for a, b in zip(got, reference_noc_run(*c.args, **c.kwargs)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)
    noc_cases.check_case(c, got, nops.noc_run)
    _assert_warp_bitwise(c, got)


def test_noc_wrapper_rejects_what_the_kernel_does_not_run(cuda_device):
    arr, nm, drain, buf = _noc_case("fig13-resipi", cuda_device, 64).args
    half = nm * 0.5
    with pytest.raises(ValueError, match="one-hot"):
        nops.noc_run(arr, half, drain, buf)
    two = nm.clone()
    two[0, :2] = 1.0
    with pytest.raises(ValueError, match="one-hot"):
        nops.noc_run(arr, two, drain, buf)
    r = nops.MAX_NODES + 1
    z = torch.zeros(r, device=cuda_device)
    with pytest.raises(ValueError, match=f"up to {nops.MAX_NODES}"):
        nops.noc_run(torch.zeros((8, r), device=cuda_device),
                     torch.zeros((r, r), device=cuda_device), z, z)
    with pytest.raises(ValueError, match="cpu"):
        nops.noc_run(arr, nm.cpu(), drain, buf)
    with pytest.raises(ValueError, match="kernel"):
        nops.run_prepared(nops.prepare(arr[None], nm, drain, buf),
                          kernel="lane")
    wide = _noc_case("mesh-12x12", cuda_device, 64)
    with pytest.raises(ValueError, match="warp kernel supports up to 128"):
        nops.run_prepared(nops.prepare(wide.args[0][None], *wide.args[1:],
                                       **wide.kwargs), kernel="warp")


@pytest.mark.parametrize("case", noc_cases.WIDE_NAMES)
def test_noc_node_kernel_past_128_nodes(case, cuda_device):
    """A 12 x 12 and a 16 x 16 mesh with four gateway sinks (148 and 260
    nodes): one node-kernel launch, equal to the plain version at rtol
    1e-5 / atol 1e-3."""
    from repro_torch import backend

    c = _noc_case(case, cuda_device)
    backend.reset_counters()
    got = nops.noc_run(*c.args, **c.kwargs)
    torch.cuda.synchronize()
    assert backend.COUNTERS["variants"] == {"noc_step:node": 1}
    for a, b in zip(got, reference_noc_run(*c.args, **c.kwargs)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)
    noc_cases.check_case(c, got, nops.noc_run)


# ---------------------------------------------------------------------------
# Streaming and fault sweeps on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(tsim.Arch), ids=lambda a: a.value)
def test_chunked_session_equals_one_shot_on_the_card(arch, cuda_device):
    sim = tsim.SimConfig().with_arch(arch)
    tr = traffic.generate(traffic.ParsecSpec("canneal", 70), 5, dest=True,
                          device=cuda_device)
    one = tsim.simulate(tr, sim)
    sess = tsim.SimSession.init(sim)
    recs = [sess.step_chunk(c)["records"]
            for c in traffic.chunk_trace(tr, 16, pad=True)]
    for k, v in one["records"].items():
        assert torch.equal(torch.cat([r[k] for r in recs])[:70], v), k


def test_tick_lane_equals_standalone_session_on_the_card(cuda_device):
    """Eight lanes with per-lane destination matrices and one shared fault
    frame, a parked lane: each lane's records and sums are a standalone
    session's bit for bit (one kernel launch a tick)."""
    from repro_torch import backend
    from repro_torch.core import faults

    sim, t, lanes = tsim.SimConfig(), 16, 8
    streams = [list(traffic.chunk_trace(traffic.generate(
        traffic.ParsecSpec(traffic.APP_NAMES[i], 3 * t), 20 + i, dest=True,
        device=cuda_device), t)) for i in range(lanes)]
    frame = faults.compile_faults(
        [faults.GatewayFault(chiplet=1, slot=0, start=2, end=9),
         faults.LinkFlap(chiplet=2, p_down=0.3)], sim.cfg, t, seed=1)
    states = tsim.init_session_states(sim, lanes)
    tables = tsim.selection_tables_torch(sim.cfg, cuda_device)
    solo = [tsim.SimSession.init(sim) for _ in range(lanes)]
    for tick in range(3):
        chunks = [s[tick] for s in streams]
        batch = {k: torch.stack([torch.as_tensor(c[k]) for c in chunks])
                 for k in ("ext_load", "mem_load", "int_load", "ext_frac",
                           "dest")}
        batch["t_mask"] = torch.ones((lanes, t), device=cuda_device)
        if tick == 1:
            batch["t_mask"][3] = 0.0
            chunks[3] = dict(chunks[3], t_mask=batch["t_mask"][3])
        backend.reset_counters()
        states, recs, sums = tsim.session_tick(states, batch, tables, sim,
                                               frame=frame)
        assert backend.COUNTERS["launches"] == {"epoch_step": 1}
        for k in range(lanes):
            out = solo[k].step_chunk(faults.attach_faults(chunks[k], frame))
            for n, v in out["records"].items():
                assert torch.equal(recs[n][k], v), (tick, k, n)
            mine = tsim.summary_from_sums({n: v[k] for n, v in sums.items()},
                                          sim.cfg.n_chiplets)
            for n, v in out["summary"].items():
                assert torch.equal(mine[n], v), (tick, k, n)


def test_session_tick_leaves_its_input_states_unchanged_on_the_card(
        cuda_device):
    """A tick from a carry that a server built (a fresh lane set into
    it), with destination matrices, a shared fault frame and a masked
    lane: the carry it was given is unchanged, the masked lane's new carry
    is its old one, and a lane-wise rollback picks each side's rows."""
    from repro_torch.core import faults
    from repro_torch.serve import engine

    sim, t, lanes = tsim.SimConfig(), 8, 4
    trs = [traffic.generate(traffic.ParsecSpec(traffic.APP_NAMES[i], t),
                            50 + i, dest=True, device=cuda_device)
           for i in range(lanes)]
    batch = {k: torch.stack([torch.as_tensor(tr[k]) for tr in trs])
             for k in ("ext_load", "mem_load", "int_load", "ext_frac",
                       "dest")}
    batch["t_mask"] = torch.ones((lanes, t), device=cuda_device)
    batch["t_mask"][2] = 0.0
    frame = faults.compile_faults(
        [faults.GatewayFault(chiplet=0, slot=1, start=1, end=5)], sim.cfg,
        t, seed=2)
    states = tsim.init_session_states(sim, lanes)
    states, _, _ = tsim.session_tick(states, batch, tsim.selection_tables_torch(
        sim.cfg, cuda_device), sim, frame=frame)
    states = engine.set_lanes(states, torch.tensor([1], device=cuda_device),
                              tsim.init_session_states(sim, 1))
    before = {k: v.clone() for k, v in _state(states).items()}
    new, _, sums = tsim.session_tick(states, batch, tsim.selection_tables_torch(
        sim.cfg, cuda_device), sim, frame=frame)
    torch.cuda.synchronize()
    for k, v in _state(states).items():
        assert torch.equal(v, before[k]), k
        assert torch.equal(_state(new)[k][2], before[k][2]), k
    assert all(float(v[2]) == 0.0 for v in sums.values())
    keep = torch.tensor([True, False, True, False], device=cuda_device)
    rolled = engine.where_lanes(keep, new, states)
    for k, v in _state(rolled).items():
        assert torch.equal(v[0], _state(new)[k][0]), k
        assert torch.equal(v[1], before[k][1]), k


def test_served_lanes_replay_exactly_on_the_card(cuda_device):
    """A 4-lane server on the card fed traces made on the card (plain and
    with destination matrices, ragged lengths): one epoch_step launch per
    dispatch, every completed session's replay on the card equal to its
    summary bit for bit, and the same counters and summaries (1e-6) as
    the same server on the CPU."""
    from repro_torch import backend
    from repro_torch.serve import engine, policies, scheduler

    sim = tsim.SimConfig()
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        server = engine.SessionServer(
            sim, policies.ServerPolicy(lanes=4, chunk_intervals=8,
                                       queue_capacity=8), device=dev)
        for i in range(7):
            tr = traffic.generate(traffic.ParsecSpec(
                traffic.APP_NAMES[i], 9 + 5 * i), 60 + i, dest=i % 3 == 2,
                device=dev)
            server.submit(scheduler.SessionRequest(trace=tr))
        backend.reset_counters()
        server.drain()
        m = server.metrics()
        if dev.type == "cuda":
            assert backend.COUNTERS["launches"] == {
                "epoch_step": m["dispatches"]}
        assert m["completed"] == 7
        for sess in server.completed:
            ref = engine.replay_standalone(sim, sess, device=dev)
            mine = sess.summary()
            for k in ("mean_latency", "mean_power_mw", "mean_energy",
                      "mean_gateways", "valid_intervals"):
                assert float(ref[k]) == mine[k], (str(dev), sess.id, k)
        runs[dev.type] = (m, [s.summary() for s in server.sessions.values()])
    (gm, gs), (cm, cs) = runs["cuda"], runs["cpu"]
    skip = ("p50_chunk_s", "p99_chunk_s")
    assert {k: v for k, v in gm.items() if k not in skip} \
        == {k: v for k, v in cm.items() if k not in skip}
    for a, b in zip(gs, cs):
        for k in ("mean_latency", "mean_power_mw", "mean_energy",
                  "mean_gateways"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6)
        assert a["valid_intervals"] == b["valid_intervals"]


def test_serving_walkthroughs_on_the_card_match_the_cpu(cuda_device):
    """The reference's two serving walkthroughs (`serve.cases`) on the
    card against the CPU: every heal decision (chunk or tick, placements,
    moved gateways, PCM nJ), the submits and the counters exactly, the
    latencies at 1e-6."""
    from repro_torch.serve import cases

    storm = {d: cases.fault_storm_recovery(d) for d in ("cuda", "cpu")}
    for a, b in zip(storm["cuda"]["events"], storm["cpu"]["events"]):
        assert a["breach"] == b["breach"]
        assert (a["healed"] is None) == (b["healed"] is None)
        if b["healed"] is not None:
            assert a["healed"]["new_placement"] \
                == b["healed"]["new_placement"]
        np.testing.assert_allclose(a["latency"], b["latency"], rtol=1e-6)
    assert storm["cuda"]["placement"] == storm["cpu"]["placement"] \
        == ((2, 0), (1, 3), (3, 2), (0, 2))
    walk = {d: cases.session_server(d) for d in ("cuda", "cpu")}
    assert walk["cuda"]["submits"] == walk["cpu"]["submits"]
    g, c = walk["cuda"]["server"], walk["cpu"]["server"]
    skip = ("p50_chunk_s", "p99_chunk_s", "baseline_latency")
    assert {k: v for k, v in g.metrics().items() if k not in skip} \
        == {k: v for k, v in c.metrics().items() if k not in skip}
    assert [(e["tick"], e["healed"]["new_placement"]) for e in g.events
            if e["healed"]] == [(e["tick"], e["healed"]["new_placement"])
                                for e in c.events if e["healed"]]


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.value)
def test_sweep_faults_on_the_card_matches_the_cpu(arch, cuda_device):
    from repro_torch.core import faults

    sim = tsim.SimConfig().with_arch(arch)
    tr = traffic.generate(traffic.ParsecSpec("dedup", 40), 3, dest=True,
                          device="cpu")
    frames = [faults.compile_faults(
        [faults.LinkFlap(chiplet=k % 4, p_down=0.2),
         faults.GatewayFault(chiplet=(k + 1) % 4, slot=k % 4, start=k)],
        sim.cfg, 40, seed=k) for k in range(16)]
    l_m = np.linspace(0.004, 0.03, 16).astype(np.float32)
    got = tsim.sweep_faults({k: (v.to(cuda_device)
                                 if isinstance(v, torch.Tensor) else v)
                             for k, v in tr.items()}, sim, frames, l_m=l_m)
    want = tsim.sweep_faults(tr, sim, frames, device="cpu", l_m=l_m)
    for part in ("records", "summary"):
        _compare({k: v.cpu() for k, v in got[part].items()}, want[part])


# ---------------------------------------------------------------------------
# flash_attention and ssd_scan: the LLM serving kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", flash_cases.NAMES)
def test_flash_kernel_matches_plain(case, cuda_device):
    from repro_torch import backend

    c = flash_cases.kernel_cases(cuda_device, names=[case])[0]
    backend.reset_counters()
    got = flash_ops.flash_attention(*c.args, causal=c.causal)
    torch.cuda.synchronize()
    assert backend.COUNTERS["launches"] == {"flash_attention": 1}
    kernel = flash_ops.variant(c.args[0].dtype, c.args[0].shape[3])
    assert backend.COUNTERS["variants"] == {f"flash_attention:{kernel}": 1}
    want = flash_cases.plain(c)
    assert got.dtype == want.dtype == c.args[0].dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=c.tol,
                               atol=c.tol)


@pytest.mark.parametrize("case", ssd_cases.NAMES)
def test_ssd_kernel_matches_plain(case, cuda_device):
    from repro_torch import backend

    c = ssd_cases.kernel_cases(cuda_device, names=[case])[0]
    backend.reset_counters()
    y, state = ssd_cases.run_chunked(c)
    torch.cuda.synchronize()
    assert backend.COUNTERS["launches"] == {"ssd_scan": 1}
    x, _, _, bb, _ = c.args
    kernel = ssd_ops.variant(x.dtype, c.chunk, x.shape[3], bb.shape[3])
    assert backend.COUNTERS["variants"] == {f"ssd_scan:{kernel}": 1}
    want_y, want_state = ssd_cases.run_chunked(c, plain=True)
    assert y.dtype == c.args[0].dtype and y.shape == c.args[0].shape
    torch.testing.assert_close(y.float(), want_y.float(), rtol=c.y_tol,
                               atol=c.y_tol)
    torch.testing.assert_close(state, want_state, rtol=c.tol, atol=c.tol)
    inputs = ssd_cases.chunked_inputs(c)
    for a, b in zip(ssd_ops.ssd_intra_chunk(*inputs),
                    reference_intra_chunk(*inputs)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=c.tol, atol=c.tol)


@pytest.mark.parametrize("op", ["flash", "ssd"])
def test_simt_kernel_runs_the_tensor_core_kernels_inputs(op, cuda_device):
    """`launch(kernel="simt")` (what chip_smoke.py times beside the
    tensor-core kernel) matches the plain version on a bf16 case the
    wrapper sends to the tensor cores; an unknown kernel name raises."""
    from repro_torch import backend

    backend.reset_counters()
    if op == "flash":
        c = flash_cases.kernel_cases(
            cuda_device, names=["bf16-causal-d112-S2049-BH2"])[0]
        got = flash_ops.launch(*c.args, causal=c.causal, kernel="simt")
        torch.testing.assert_close(got.float(), flash_cases.plain(c).float(),
                                   rtol=c.tol, atol=c.tol)
        with pytest.raises(ValueError, match="does not take"):
            flash_ops.launch(*c.args, kernel="mma")
        assert backend.COUNTERS["variants"] == {"flash_attention:simt": 1}
        return
    c = ssd_cases.kernel_cases(cuda_device,
                               names=["H20-G2-N32-bf16-ragged-init"])[0]
    inputs = ssd_cases.chunked_inputs(c)
    for a, b in zip(ssd_ops.launch(*inputs, kernel="simt"),
                    reference_intra_chunk(*inputs)):
        torch.testing.assert_close(a, b, rtol=c.tol, atol=c.tol)
    with pytest.raises(ValueError, match="does not take"):
        ssd_ops.launch(*inputs, kernel="mma")
    assert backend.COUNTERS["variants"] == {"ssd_scan:simt": 1}


def test_ssd_tensor_core_kernel_reads_projection_slices(cuda_device):
    """x, B and C cut from one projection row, as the model's Mamba2 block
    cuts them (tokens a projection row apart): the tensor-core kernel reads
    them in place and matches the plain version."""
    from repro_torch import backend

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    bsz, nc, q, h, p, g, n = 2, 3, 128, 10, 64, 1, 64
    proj = (torch.randn((bsz, nc * q, h * p + 2 * g * n + 24),
                        generator=gen, device=cuda_device) * 0.5
            ).to(torch.bfloat16)
    xs, bs, cs, _ = torch.split(proj, [h * p, g * n, g * n, 24], dim=-1)
    x = xs.reshape(bsz, nc, q, h, p)
    bb, cc = (t.reshape(bsz, nc, q, g, n) for t in (bs, cs))
    dt = torch.nn.functional.softplus(
        torch.randn((bsz, nc, q, h), generator=gen, device=cuda_device))
    a = -torch.exp(torch.randn((h,), generator=gen, device=cuda_device) * .3)
    assert not x.is_contiguous() and ssd_ops._token_strided(x) is x
    backend.reset_counters()
    got = ssd_ops.ssd_intra_chunk(x, dt, a, bb, cc)
    assert backend.COUNTERS["variants"] == {"ssd_scan:wgmma": 1}
    for u, w in zip(got, reference_intra_chunk(x, dt, a, bb, cc)):
        torch.testing.assert_close(u, w, rtol=2e-4, atol=2e-4)


def test_llm_wrappers_reject_what_the_kernels_do_not_run(cuda_device):
    q, k, v = flash_cases.kernel_cases(
        cuda_device, names=["f32-causal-d112-S127-BH6"])[0].args
    wide = torch.zeros((1, 4, 1, 272), device=cuda_device)
    with pytest.raises(ValueError, match="up to 256"):
        flash_ops.flash_attention(wide, wide, wide)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one device"):
        flash_ops.flash_attention(q, k.cpu(), v)
    c = ssd_cases.kernel_cases(cuda_device, names=["N16-G1-f32"])[0]
    x, dt, a, bb, cc = ssd_cases.chunked_inputs(c)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_ops.ssd_intra_chunk(x.half(), dt, a, bb.half(), cc.half())
    with pytest.raises(ValueError, match="one device"):
        ssd_ops.ssd_intra_chunk(x, dt.cpu(), a, bb, cc)
    with pytest.raises(ValueError, match="multiples of 32"):
        ssd_ops.ssd_intra_chunk(x[:, :, :16], dt[:, :, :16], a,
                                bb[:, :, :16], cc[:, :, :16])
    # Q = 256, P = N = 128: x, B, C and the weight scratch need 428 KB.
    big = torch.zeros((1, 1, 256, 1, 128), device=cuda_device)
    dt1 = torch.zeros((1, 1, 256, 1), device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_ops.ssd_intra_chunk(big, dt1, a[:1], big, big)


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m",
                                  "phi4-mini-3.8b", "starcoder2-7b",
                                  "grok-1-314b", "kimi-k2-1t-a32b",
                                  "pixtral-12b", "seamless-m4t-large-v2"])
def test_smoke_models_on_the_card_match_the_cpu(arch, cuda_device,
                                                monkeypatch):
    """prefill + 3 decode steps of a smoke model, bf16, with the same
    weights on the card (kernels) and on the CPU (plain versions): logits
    and caches within 5e-2 in relative RMS (the bf16 bound of
    tests/test_torch_models.py), launches counted (the VLM with image
    embeddings, the encoder-decoder with speech frames).

    The MoE archs run in float32 compute, held at 1e-4: in bf16 the card's
    and the CPU's router logits round apart, a token's top-k flips and its
    expert output with it (grok-smoke: 0.41 relative RMS on one leaf)."""
    from repro_torch import backend, interop
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.models import layers as TL
    from repro_torch.models.params import init_params

    cfg = get_smoke_config(arch)
    bound = 5e-2
    if cfg.moe is not None:
        monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
        bound = 1e-4
    model = get_model(cfg)
    cpu_params = init_params(model.spec(), torch.Generator().manual_seed(0),
                             "cpu")
    rng = np.random.RandomState(1)
    toks_np = rng.randint(0, cfg.real_vocab, (2, 43))
    extra_np = {}
    if cfg.family == "vlm":
        extra_np["image_embeds"] = rng.randn(2, cfg.frontend_embeds,
                                             cfg.d_model)
    if cfg.family == "encdec":
        extra_np["frames"] = rng.randn(2, 24, cfg.d_model)
    runs = {}
    for dev in ("cpu", cuda_device):
        params = _to(cpu_params, dev)
        toks = torch.tensor(toks_np, device=dev)
        batch = {"tokens": toks[:, :40], **{
            k: torch.tensor(v, dtype=torch.float32, device=dev)
            for k, v in extra_np.items()}}
        backend.reset_counters()
        caches, logits = model.prefill(params, batch,
                                       48 + cfg.frontend_embeds)
        launches = dict(backend.COUNTERS["launches"])
        out = [(logits, interop.caches_to_numpy(caches))]
        for i in range(3):
            logits, caches = model.decode_step(params,
                                               toks[:, 40 + i:41 + i],
                                               caches)
            out.append((logits, interop.caches_to_numpy(caches)))
        runs[str(dev)] = (out, launches)
    if cfg.family in ("ssm", "hybrid"):
        n_ssd = cfg.n_layers
        n_flash = cfg.n_layers // cfg.attn_every \
            if cfg.family == "hybrid" else 0
    else:                        # one prefill launch a decoder layer
        n_ssd, n_flash = 0, cfg.decoder_layers
    want_launches = {}
    if n_ssd:
        want_launches["ssd_scan"] = n_ssd
    if n_flash:
        want_launches["flash_attention"] = n_flash
    assert runs["cpu"][1] == {}
    assert runs["cuda"][1] == want_launches

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [] if tree is None else [tree]

    for (gl, gc), (cl, cc) in zip(runs["cuda"][0], runs["cpu"][0]):
        pairs = [(gl.float().cpu().numpy(), cl.float().numpy())] \
            + list(zip(leaves(gc), leaves(cc)))
        for u, v in pairs:
            assert u.shape == v.shape
            rel = np.linalg.norm(u - v) / max(np.linalg.norm(v), 1e-30)
            assert rel <= bound, rel


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# Fleet and caching on the card
# ---------------------------------------------------------------------------

def _bitwise(got, want, path=""):
    if isinstance(want, dict):
        for k in want:
            _bitwise(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _bitwise(g, w, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


def test_sharded_sweeps_on_the_card_are_the_one_device_calls(cuda_device):
    """Four emulated devices of the card: every block launches the whole
    grid's design, and the gathered records are the one-device call's bit
    for bit (3 points, one padded lane)."""
    from repro_torch import backend

    sim = tsim.SimConfig()
    specs = [traffic.UniformSpec(n_intervals=12),
             traffic.BurstySpec(n_intervals=10),
             traffic.ParsecSpec("dedup", 12)]
    grid = dict(n_chiplets=[4, 9, 16])
    one = tsim.sweep_workload(specs, sim, dest=True, device=cuda_device,
                              **grid)
    backend.reset_counters()
    got = tsim.sweep_workload(specs, sim, dest=True,
                              devices=["cuda:0"] * 4, **grid)
    design = ops.variant(16, False, True, 3, padded=True)
    assert backend.COUNTERS["variants"] == {
        f"epoch_step:{design}+topo": 4}
    assert got["sharding"] == {"grid_points": 3, "pad_lanes": 1,
                               "devices": 4, "processes": 1}
    _bitwise(got["records"], one["records"])
    tr = traffic.generate(traffic.ParsecSpec("canneal", 12), 3,
                          sim.cfg.with_topology(n_chiplets=16), dest=True,
                          device=cuda_device)
    one = tsim.sweep_topology_batch([tr, tr], sim, device=cuda_device,
                                    **grid)
    got = tsim.shard_sweep([tr, tr], sim, devices=["cuda:0"] * 2, **grid)
    _bitwise(got["records"], one["records"])


def test_sharded_searches_on_the_card_are_the_one_device_searches(
        cuda_device):
    sim = tsim.SimConfig()
    tr = traffic.generate(traffic.ParsecSpec("dedup", 12), 2, sim.cfg,
                          device=cuda_device)
    kw = dict(islands=4, generations=3, population=4, seed=1,
              l_m=[0.008, 0.012, 0.02, 0.03])
    one = tsim.search_placement_islands(tr, sim, device=cuda_device, **kw)
    got = tsim.search_placement_islands(tr, sim, devices=["cuda:0"] * 2,
                                        **kw)
    assert got.pop("sharding")["devices"] == 2
    _bitwise(got, one)
    cfg = sim.cfg.with_topology(n_chiplets=16)
    traces = [traffic.generate(traffic.ParsecSpec(a, 8), i, cfg, dest=True,
                               device=cuda_device)
              for i, a in enumerate(("canneal", "facesim"))]
    kw = dict(n_chiplets=[8, 16], islands=4, generations=3, population=3,
              migrate_every=1, archive=16, seed=4)
    one = tsim.search_codesign(traces, sim, device=cuda_device, **kw)
    got = tsim.search_codesign(traces, sim, devices=["cuda:0"] * 2, **kw)
    assert got.pop("sharding")["devices"] == 2
    _bitwise(got, one)


def test_laned_all_reduce_over_a_one_rank_nccl_group(cuda_device):
    import socket

    import torch.distributed as dist
    from repro_torch.core import reconfig_runtime as rr

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        gen = torch.Generator().manual_seed(3)
        tree = {"a": torch.randn(300, generator=gen).to(cuda_device),
                "b": [torch.randn(7, 9, generator=gen).to(cuda_device),
                      torch.randn(2, generator=gen).double()
                      .to(cuda_device)]}
        for lanes in (1, 2, 4):
            out = rr.laned_all_reduce(tree, dist.group.WORLD, lanes)
            _bitwise(out, tree)            # one rank: the sum is itself
    finally:
        dist.destroy_process_group()


def test_memoized_entry_on_the_card_is_the_plain_call(cuda_device):
    from repro_torch.runtime import cache as rcache

    sim = tsim.SimConfig()
    tr = traffic.generate(traffic.UniformSpec(n_intervals=16), 0, sim.cfg,
                          device=cuda_device)
    exe = rcache.aot_compile("simulate", tr, sim, device=cuda_device)
    _bitwise(exe(tr, sim, device=cuda_device),
             tsim.simulate(tr, sim, device=cuda_device))


# ---------------------------------------------------------------------------
# Training: the kernel ops under autograd, a train step on the card
# ---------------------------------------------------------------------------

def _autograd(fn, inputs, cotangents):
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, cotangents)
    return outs, [x.grad for x in leaves]


@pytest.mark.parametrize("case", ["bf16-causal-d80-S1024-BH16",
                                  "f32-causal-d112-S127-BH6",
                                  "bf16-full-d64-S127-BH64"])
def test_flash_op_under_autograd_on_the_card(case, cuda_device):
    """Forward: one kernel launch (the variant `ops.variant` picks), held
    to the plain version at the case's bound; backward: the plain VJP
    (`flash_attention:backward_plain`), q, k, v gradients equal to plain
    autograd on the card at the same bound."""
    from repro_torch import backend

    c = flash_cases.kernel_cases(cuda_device, names=[case])[0]
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    cot = torch.randn(c.args[0].shape, generator=gen,
                      device=cuda_device).to(c.args[0].dtype)
    backend.reset_counters()
    got, got_g = _autograd(lambda q, k, v: flash_ops.flash_attention(
        q, k, v, causal=c.causal), c.args, [cot])
    torch.cuda.synchronize()
    kernel = flash_ops.variant(c.args[0].dtype, c.args[0].shape[3])
    assert backend.COUNTERS["launches"] == {"flash_attention": 1}
    assert backend.COUNTERS["variants"] == {
        f"flash_attention:{kernel}": 1, "flash_attention:backward_plain": 1}
    want, want_g = _autograd(lambda q, k, v: flash_ops._plain(q, k, v,
                                                              c.causal),
                             c.args, [cot])
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=c.tol,
                               atol=c.tol)
    for a, b in zip(got_g, want_g):
        assert a.dtype == c.args[0].dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=c.tol,
                                   atol=c.tol)


@pytest.mark.parametrize("case", ["mamba2-N128-bf16", "N16-G1-f32"])
def test_ssd_op_under_autograd_on_the_card(case, cuda_device):
    """The intra-chunk op: one kernel launch forward, the plain VJP
    backward (`ssd_scan:backward_plain`); outputs at the case's bound of
    the plain version, the five inputs' gradients at 1e-4 relative RMS of
    plain autograd on the card."""
    from repro_torch import backend

    c = ssd_cases.kernel_cases(cuda_device, names=[case])[0]
    inputs = ssd_cases.chunked_inputs(c)
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    cots = [torch.randn(o.shape, generator=gen, device=cuda_device)
            for o in reference_intra_chunk(*inputs)]
    backend.reset_counters()
    got, got_g = _autograd(ssd_ops.ssd_intra_chunk, inputs, cots)
    torch.cuda.synchronize()
    x, _, _, bb, _ = inputs
    kernel = ssd_ops.variant(x.dtype, c.chunk, x.shape[4], bb.shape[4])
    assert backend.COUNTERS["launches"] == {"ssd_scan": 1}
    assert backend.COUNTERS["variants"] == {
        f"ssd_scan:{kernel}": 1, "ssd_scan:backward_plain": 1}
    want, want_g = _autograd(reference_intra_chunk, inputs, cots)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=c.tol, atol=c.tol)
    for t, a, b in zip(inputs, got_g, want_g):
        assert a.dtype == t.dtype
        rel = float((a.double() - b.double()).norm() / b.double().norm())
        assert rel <= 1e-4, rel


@pytest.mark.parametrize("arch", ["stablelm-3b", "mamba2-130m"])
def test_train_gradients_on_the_card_match_the_cpu(arch, cuda_device,
                                                   monkeypatch):
    """`train_step.value_and_grad` of a smoke model (flash_block 16, so
    stablelm-smoke takes the flash kernel) in float32 compute on the card
    against the CPU, the same weights: loss at 1e-5 relative, every
    gradient leaf present and at 1e-4 relative RMS; the kernels launch
    twice a layer (forward and rematerialization), the backward is the
    plain VJP once a layer."""
    import dataclasses

    from repro_torch import backend
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.models import layers as TL
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.train.train_step import value_and_grad

    monkeypatch.setattr(TL, "COMPUTE_DTYPE", torch.float32)
    cfg = dataclasses.replace(get_smoke_config(arch), flash_block_q=16,
                              flash_block_kv=16)
    model = get_model(cfg)
    cpu_params = init_params(model.spec(), torch.Generator().manual_seed(0),
                             "cpu")
    rng = np.random.RandomState(2)
    batch_np = {k: rng.randint(0, cfg.real_vocab, (2, 64))
                for k in ("tokens", "labels")}
    runs = {}
    for dev in ("cpu", cuda_device):
        batch = {k: torch.tensor(v, device=dev) for k, v in batch_np.items()}
        backend.reset_counters()
        loss, _, grads = value_and_grad(model, _to(cpu_params, dev), batch)
        runs[str(dev)] = (float(loss), tree_leaves(grads),
                          dict(backend.COUNTERS["launches"]),
                          dict(backend.COUNTERS["variants"]))
    (cl, cg, _, _), (gl, gg, launches, variants) = runs["cpu"], \
        runs[str(cuda_device)]
    assert abs(gl - cl) <= 1e-5 * abs(cl)
    for a, b in zip(gg, cg):
        assert a is not None
        rel = float((a.cpu().double() - b.double()).norm()
                    / b.double().norm().clamp(min=1e-30))
        assert rel <= 1e-4, rel
    name = "flash_attention" if arch == "stablelm-3b" else "ssd_scan"
    assert launches == {name: 2 * cfg.n_layers}
    assert variants[f"{name}:backward_plain"] == cfg.n_layers


def test_kernel_ops_credit_their_work_after_each_launch(cuda_device):
    """On the card each kernel op launches once and credits `ops.work` for
    it once, as it credits the same call on `meta` tensors (what the op
    analysis of `launch/op_analysis.py` counts)."""
    from repro_torch import backend

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 160, 4, 64, generator=gen, device=cuda_device,
                           dtype=torch.bfloat16) for _ in range(3))
    x = torch.randn(2, 2, 64, 4, 64, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    dt = torch.rand(2, 2, 64, 4, generator=gen, device=cuda_device) * 0.1
    a = -torch.rand(4, generator=gen, device=cuda_device)
    bc = torch.randn(2, 2, 64, 1, 32, generator=gen, device=cuda_device,
                     dtype=torch.bfloat16)
    for op, args, want in (
            (flash_ops.flash_attention, (q, k, v),
             flash_ops.work(2, 160, 4, 64, 2, True, 160)),
            (ssd_ops.ssd_intra_chunk, (x, dt, a, bc, bc),
             ssd_ops.work(2, 2, 64, 4, 64, 1, 32, 2))):
        got = []
        backend.reset_counters()
        with backend.work_sink(lambda *c: got.append(c)):
            op(*args)
            meta = op(*(t.to("meta") for t in args))
        torch.cuda.synchronize()
        name = op.__module__.split(".")[-2]
        assert backend.COUNTERS["launches"] == {name: 1}
        assert got == [(name, *want)] * 2
        assert all(t.device.type == "meta"
                   for t in (meta if isinstance(meta, tuple) else (meta,)))
