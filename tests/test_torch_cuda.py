"""Card-only tests: the hand-written `epoch_step` and `noc_step` CUDA
kernels against their plain PyTorch versions on the same CUDA inputs.

Marked `cuda`; each test asks the `cuda_device` fixture for the card and
skips without one. Run them on a machine with a card and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The cases are those of `chip_smoke.py` phase 2 at a smaller size (the
`noc_step` ones come from the same builder, `kernels/noc_step/cases.py`). For
`epoch_step`: clean, destination matrices, a ragged `t_mask` batch with an
all-masked lane, fault frames, and a sweep over the five kernel knobs;
records and final state agree at rtol = atol = 1e-6 (the reference's bound
for this kernel), integer g and boolean saturation exactly. For
`noc_step` (T <= 1024): Fig. 13's two topologies, a padded topology with
garbage in its dead lanes, a lane dying mid-run, an all-ones
`valid_mask_t`, a ragged `t_mask`, `hex_config(2)` and a batch of mixed-T
runs at rtol 1e-5, atol 1e-3 (the in-edge sums run in another order than
the plain version's products); dead lanes exactly 0, a batch bitwise its
single runs, and the wrapper's refusals. This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import simulator as tsim
from repro_torch.core import traffic
from repro_torch.kernels.epoch_step import ops
from repro_torch.kernels.epoch_step.ref import epoch_run_reference
from repro_torch.kernels.noc_step import cases as noc_cases
from repro_torch.kernels.noc_step import ops as nops
from repro_torch.kernels.noc_step.ref import reference_noc_run

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


@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.value)
@pytest.mark.parametrize("case", ["clean", "dest", "ragged", "faults",
                                  "sweep"])
def test_kernel_matches_plain(case, arch, cuda_device):
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
    tsim.reset_engine_stats()
    got_state, got = ops.epoch_run(state0, xs, sim, tables, **kw)
    torch.cuda.synchronize()
    assert tsim.engine_stats()["epoch_step_launches"] == 1
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


def test_wrapper_rejects_what_the_kernel_does_not_run(cuda_device):
    sim = tsim.SimConfig().with_arch(tsim.Arch.PROWAVES)
    state0, xs, tables, kw = tsim.epoch_inputs(_traces("clean",
                                                       cuda_device)[:1],
                                               sim, device=cuda_device)
    with pytest.raises(ValueError, match="RESIPI"):
        ops.epoch_run(state0, xs, sim, tables, **kw)


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
    want = reference_noc_run(*c.args, **c.kwargs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)
    noc_cases.check_case(c, got, nops.noc_run)


def test_noc_kernel_batch_is_bitwise_the_single_runs(cuda_device):
    """Runs of mixed T padded with t_mask, mixed topologies padded with
    dead lanes: one launch matches the plain version and equals the runs
    one by one, bitwise."""
    c = _noc_case("batch-mixed-T", cuda_device)
    got = nops.noc_run(*c.args, **c.kwargs)
    for a, b in zip(got, reference_noc_run(*c.args, **c.kwargs)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)
    noc_cases.check_case(c, got, nops.noc_run)


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
    with pytest.raises(ValueError, match="up to 128"):
        nops.noc_run(torch.zeros((8, r), device=cuda_device),
                     torch.zeros((r, r), device=cuda_device), z, z)
    with pytest.raises(ValueError, match="cpu"):
        nops.noc_run(arr, nm.cpu(), drain, buf)
