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
knobs, plus 1 and 12 chiplets; records and final state agree at
rtol = atol = 1e-6 (the reference's bound for this kernel), integer g and
boolean saturation exactly. For `noc_step` (T <= 1024), each case through
the "node" kernel and the "warp" kernel, which must agree bit for bit:
Fig. 13's two topologies, a padded topology with garbage in its dead
lanes, a lane dying mid-run, an all-ones `valid_mask_t`, a ragged
`t_mask`, `hex_config(2)` and a batch of mixed-T runs at rtol 1e-5, atol
1e-3 of the plain version (the in-edge sums run in another order than the
plain version's products); dead lanes exactly 0, a batch bitwise its
single runs, and the wrappers' refusals. For `flash_attention` and
`ssd_scan`: the shared cases of `kernels/flash_attention/cases.py` and
`kernels/ssd_scan/cases.py` (chip_smoke.py's phase 2) at the reference's
bounds (flash 2e-5 in float32, 3e-2 in bfloat16; SSD float32 outputs 1e-4,
2e-4 at chunk 128), each launch counted once under the kernel variant that
`ops.variant` picks (the tensor-core kernel for the bf16 cases it takes,
among them a causal S of 2049, 10 heads a group and a chunk of 64; the
SIMT kernel for the rest); the SIMT kernel forced on the tensor-core
kernel's inputs; the wrappers' refusals, and the two smoke models served on
the card against the same models on the CPU. This file imports no JAX.
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
    """`ops.epoch_run` for the variant the wrapper picks ("split"), the
    raw launch reassembled for the other; one launch counted either way."""
    from repro_torch import backend

    backend.reset_counters()
    if kernel == "split":
        out = ops.epoch_run(state0, xs, sim, tables, **kw)
    else:
        out = ops._reassemble(state0, ops.launch(state0.ctl.g, xs, sim,
                                                 tables, kernel=kernel, **kw),
                              xs, sim, kw["faulted"])
    torch.cuda.synchronize()
    assert backend.COUNTERS["launches"] == {"epoch_step": 1}
    assert backend.COUNTERS["variants"] == {f"epoch_step:{kernel}": 1}
    return out


@pytest.mark.parametrize("kernel", ["split", "warp"])
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
                       kw["dest"] is not None) == "split"
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


@pytest.mark.parametrize("kernel", ["split", "warp"])
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
    with pytest.raises(ValueError, match="up to 128"):
        nops.noc_run(torch.zeros((8, r), device=cuda_device),
                     torch.zeros((r, r), device=cuda_device), z, z)
    with pytest.raises(ValueError, match="cpu"):
        nops.noc_run(arr, nm.cpu(), drain, buf)
    with pytest.raises(ValueError, match="kernel"):
        nops.run_prepared(nops.prepare(arr[None], nm, drain, buf),
                          kernel="lane")


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
    wide = torch.zeros((1, 4, 1, 136), device=cuda_device)
    with pytest.raises(ValueError, match="up to 128"):
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


@pytest.mark.parametrize("arch", ["zamba2-7b", "mamba2-130m"])
def test_smoke_models_on_the_card_match_the_cpu(arch, cuda_device):
    """prefill + 3 decode steps of a smoke model, bf16, with the same
    weights on the card (kernels) and on the CPU (plain versions): logits
    and caches within 5e-2 in relative RMS (the bf16 bound of
    tests/test_torch_models.py), launches counted."""
    from repro_torch import backend, interop
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.models.params import init_params

    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    cpu_params = init_params(model.spec(), torch.Generator().manual_seed(0),
                             "cpu")
    runs = {}
    for dev in ("cpu", cuda_device):
        params = _to(cpu_params, dev)
        toks = torch.tensor(np.random.RandomState(1).randint(
            0, cfg.real_vocab, (2, 43)), device=dev)
        backend.reset_counters()
        caches, logits = model.prefill(params, {"tokens": toks[:, :40]}, 48)
        launches = dict(backend.COUNTERS["launches"])
        out = [(logits, interop.caches_to_numpy(caches))]
        for i in range(3):
            logits, caches = model.decode_step(params,
                                               toks[:, 40 + i:41 + i],
                                               caches)
            out.append((logits, interop.caches_to_numpy(caches)))
        runs[str(dev)] = (out, launches)
    n_ssd = cfg.n_layers
    n_flash = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    want_launches = {"ssd_scan": n_ssd}
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
            assert rel <= 5e-2, rel


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
