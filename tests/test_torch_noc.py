"""The port's Fig. 13 flit-level path against the JAX reference, on the CPU.

Topologies must equal the reference's exactly; the plain `noc_run`
must match the jitted `reference_noc_run` and the interpret-mode Pallas
kernel at rtol 1e-5 / atol 1e-3. That tolerance: a plain torch loop and the
jitted reference differ by ulp noise from the order of the inflow sums,
which accumulates over thousands of cycles into up to ~1.3e-6 relative on
residencies of order 1e3-1e4 (drained stays equal). Interpret-mode Pallas
runs stay at T <= 512, as the reference's own tests keep them. Fig. 13 at
seed 5 must reproduce the reference's arrivals bitwise (threefry twin) and
its maps and drained totals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constants as jconst
from repro.core import topology as jtopo
from repro.kernels.noc_step import ops as jops
from repro.kernels.noc_step.kernel import noc_run_pallas
from repro.kernels.noc_step.ref import reference_noc_run as jref
from repro_torch import figures
from repro_torch import random as trandom
from repro_torch.core import constants as tconst
from repro_torch.core import topology as ttopo
from repro_torch.interop import noc_inputs_from_numpy
from repro_torch.kernels.noc_step import cases as tcases
from repro_torch.kernels.noc_step import ops as tops

RTOL, ATOL = 1e-5, 1e-3


def _both_or_raise(jfn, tfn):
    """Both functions' outputs, or the exception type both raised."""
    try:
        want = jfn()
    except Exception as e:      # noqa: BLE001 - the port must raise alike
        with pytest.raises(type(e)):
            tfn()
        return None, None
    return want, tfn()


def _assert_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("w", [1, 2, 4, 16])
@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("radix", [2, 4, 6, 8, 12, 16])
def test_build_topology_exact(radix, g, w):
    jcfg = jconst.NETWORK.with_topology(mesh_radix=radix)
    tcfg = tconst.NETWORK.with_topology(mesh_radix=radix)
    want, got = _both_or_raise(lambda: jops.build_topology(g, w, jcfg),
                               lambda: tops.build_topology(g, w, tcfg))
    if want is None:
        return
    _assert_equal(got, want)
    pad_to = want[0].shape[0] + 3
    _assert_equal(tops.build_topology_padded(g, w, tcfg, pad_to=pad_to),
                  jops.build_topology_padded(g, w, jcfg, pad_to=pad_to))
    with pytest.raises(ValueError, match="pad_to"):
        tops.build_topology_padded(g, w, tcfg, pad_to=pad_to - 4)


@pytest.mark.parametrize("g", [1, 2, 3, 4])
@pytest.mark.parametrize("layout", ["placement", "hex"])
def test_build_topology_explicit_layouts_exact(layout, g):
    if layout == "hex":
        jcfg, tcfg = jtopo.hex_config(2), ttopo.hex_config(2)
    else:
        pos = ((0, 1), (3, 2), (1, 3), (2, 0))
        jcfg = jconst.NETWORK.with_placement(pos)
        tcfg = tconst.NETWORK.with_placement(pos)
    _assert_equal(tops.build_topology(g, 4, tcfg),
                  jops.build_topology(g, 4, jcfg))
    _assert_equal(tops.build_topology_padded(g, 4, tcfg, pad_to=40),
                  jops.build_topology_padded(g, 4, jcfg, pad_to=40))


def _problem(case: str, t: int):
    """numpy inputs of one noc run: (arrivals, next_mat, drain, buf, kw)."""
    rng = np.random.RandomState(11)
    if case == "padded":
        nm, drain, buf, mask = jops.build_topology_padded(2, 4, pad_to=32)
        n_real = int(mask.sum())
        buf = buf.copy()
        buf[n_real:] = 64.0                       # dead lanes offer space
        arr = ((rng.rand(t, 32) < 0.05) * 8).astype(np.float32)
        return arr, nm, drain, buf, {"valid_mask": mask}
    nm, drain, buf, _ = jops.build_topology(2, 4)
    n = nm.shape[0]
    arr = ((rng.rand(t, n) < 0.04) * 8).astype(np.float32)
    arr[:, 16:] = 0.0                             # nothing enters at sinks
    kw = {}
    if case == "lane-dies":
        tv = np.ones((t, n), np.float32)
        tv[t // 3:, 5] = 0.0
        kw = {"valid_mask_t": tv}
    elif case == "all-ones":
        kw = {"valid_mask_t": np.ones((t, n), np.float32)}
    elif case == "ragged":
        tm = np.ones(t, np.float32)
        tm[t // 4: t // 2] = 0.0
        tm[-9:] = 0.0
        kw = {"t_mask": tm}
    return arr, nm, drain, buf, kw


def _port_run(arr, nm, drain, buf, kw):
    return tops.noc_run(**noc_inputs_from_numpy(arr, nm, drain, buf,
                                                device="cpu", **kw))


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("case", ["static", "padded", "lane-dies",
                                  "all-ones", "ragged"])
def test_plain_noc_run_matches_reference_and_pallas(case):
    arr, nm, drain, buf, kw = _problem(case, 512)
    got = _port_run(arr, nm, drain, buf, kw)
    jargs = [jnp.asarray(a) for a in (arr, nm, drain, buf)]
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    _close(got, jax.jit(jref)(*jargs, **jkw))
    _close(got, noc_run_pallas(*jargs, **jkw, t_chunk=128, interpret=True))
    if case == "padded":
        n_real = int(kw["valid_mask"].sum())
        for a in got:
            assert torch.all(a[n_real:] == 0)
    if case == "lane-dies":
        assert float(got[1][5]) == 0.0
    if case == "all-ones":
        static = _port_run(arr, nm, drain, buf, {})
        for a, b in zip(got, static):
            assert torch.equal(a, b)


def test_plain_noc_run_takes_any_t():
    """T = 1000 (not a multiple of the reference's t_chunk of 256) against
    the jitted reference; T = 500 against the Pallas kernel, which pads its
    tail with frozen cycles."""
    arr, nm, drain, buf, _ = _problem("static", 1000)
    jargs = [jnp.asarray(a) for a in (arr, nm, drain, buf)]
    _close(_port_run(arr, nm, drain, buf, {}), jax.jit(jref)(*jargs))
    jargs[0] = jargs[0][:500]
    _close(_port_run(arr[:500], nm, drain, buf, {}),
           noc_run_pallas(*jargs, interpret=True))


def test_batch_equals_single_runs():
    """A leading batch axis (mixed topologies padded with dead lanes,
    mixed T padded with t_mask) equals the runs one by one."""
    runs = [_problem("static", 300), _problem("padded", 300),
            _problem("ragged", 200)]
    p, t = 32, 300
    cols = {k: [] for k in ("arrivals", "next_mat", "drain_rate", "buf_cap",
                            "valid_mask", "t_mask")}
    singles = []
    for arr, nm, drain, buf, kw in runs:
        tc, n = arr.shape
        mask = kw.get("valid_mask", np.ones(n, np.float32))
        tm = kw.get("t_mask", np.ones(tc, np.float32))
        singles.append(_port_run(arr, nm, drain, buf,
                                 {"valid_mask": mask, "t_mask": tm}))
        cols["arrivals"].append(np.pad(arr, ((0, t - tc), (0, p - n))))
        cols["next_mat"].append(np.pad(nm, ((0, p - n), (0, p - n))))
        cols["drain_rate"].append(np.pad(drain, (0, p - n)))
        cols["buf_cap"].append(np.pad(buf, (0, p - n)))
        cols["valid_mask"].append(np.pad(mask, (0, p - n)))
        cols["t_mask"].append(np.pad(tm, (0, t - tc)))
    stacked = noc_inputs_from_numpy(
        **{k: np.stack(v) for k, v in cols.items()}, device="cpu")
    got = tops.noc_run(**stacked)
    assert all(tuple(a.shape) == (3, p) for a in got)
    for i, single in enumerate(singles):
        n = single[0].shape[0]
        for a, b in zip(got, single):
            torch.testing.assert_close(a[i, :n], b, rtol=1e-6, atol=0)
            assert torch.all(a[i, n:] == 0)


@pytest.mark.parametrize("name", tcases.NAMES + tcases.WIDE_NAMES)
def test_shared_kernel_cases_on_the_plain_version(name):
    """The cases that hold the kernel against the plain version on the card
    (chip_smoke.py, tests/test_torch_cuda.py), at T = 256 on the CPU (the
    12 x 12 and 16 x 16 meshes past 128 nodes at T = 64): the plain
    version matches the jitted reference on each and keeps each case's
    promise (dead lanes 0, the dying lane empty, all-ones valid_mask_t
    bitwise static, a batch run equal to its run alone)."""
    t = 64 if name in tcases.WIDE_NAMES else 256
    case, = tcases.kernel_cases("cpu", t, names=[name])
    got = tops.noc_run(*case.args, **case.kwargs)
    jargs = [jnp.asarray(a.numpy()) for a in case.args]
    jkw = {k: jnp.asarray(v.numpy()) for k, v in case.kwargs.items()}
    want = jax.jit(jax.vmap(jref) if case.parts else jref)(*jargs, **jkw)
    _close(got, want)
    tcases.check_case(case, got, tops.noc_run, exact=name != "batch-mixed-T")


def test_flit_conservation():
    """Injected = drained + still queued."""
    arr, nm, drain, buf, _ = _problem("static", 1024)
    resid, occ, drained = _port_run(arr, nm, drain, buf, {})
    assert float(drained.sum() + occ.sum()) == pytest.approx(
        float(arr.sum()), rel=1e-5)


def test_plain_version_takes_any_routing_matrix():
    """Only the kernel needs a one-hot matrix; the plain version runs the
    products as the reference does."""
    arr, nm, drain, buf, _ = _problem("static", 64)
    half = nm * 0.5
    got = _port_run(arr, half, drain, buf, {})
    _close(got, jax.jit(jref)(*[jnp.asarray(a)
                                for a in (arr, half, drain, buf)]))


def test_residency_arrivals_equal_the_reference_draw(monkeypatch):
    """Fig. 13's arrivals at seed 5, and a batch of runs drawn from split
    keys, bitwise: each run equals the reference's draw with its key."""
    r, n, cycles, load = 16, 18, 8192, 0.10
    got = tops.residency_arrivals(trandom.prng_key(5, device="cpu")[None],
                                  [load], [r], cycles, n)[0]
    want = (jax.random.uniform(jax.random.PRNGKey(5), (cycles, r))
            < load / r).astype(jnp.float32) * 8
    np.testing.assert_array_equal(got[:, :r].numpy(), np.asarray(want))
    assert torch.all(got[:, r:] == 0)
    keys = trandom.split(trandom.prng_key(13, device="cpu"), 5)
    jkeys = jax.random.split(jax.random.PRNGKey(13), 5)
    loads, routers = [0.02, 0.3, 0.64, 0.1, 0.5], [16, 64, 16, 64, 16]
    monkeypatch.setattr(tops, "ARRIVAL_GROUP", 2)
    got = tops.residency_arrivals(keys, loads, routers, 64, 68)
    for b in range(5):
        want = (jax.random.uniform(jkeys[b], (64, routers[b]))
                < loads[b] / routers[b]).astype(jnp.float32) * 8
        np.testing.assert_array_equal(got[b, :, :routers[b]].numpy(),
                                      np.asarray(want))
        assert torch.all(got[b, :, routers[b]:] == 0)


def test_fig13_matches_the_reference():
    want = {}
    for name, g, w in (("prowaves", 1, 16), ("resipi", 2, 4)):
        want[name] = jops.simulate_residency(0.10, g, w, cycles=8192,
                                             seed=5, interpret=True)
    got = figures.fig13_residency(device="cpu")
    for name in ("prowaves", "resipi"):
        m, drained = want[name]
        np.testing.assert_allclose(got[f"{name}_residency"], m, rtol=RTOL)
        assert got["drained"][name] == drained
    assert got["prowaves_max"] == pytest.approx(1.936, abs=5e-4)
    assert got["resipi_max"] == pytest.approx(0.908, abs=5e-4)
    assert got["max_ratio_pro_over_resipi"] == pytest.approx(2.133,
                                                             abs=5e-4)
    assert got["drained"] == {"prowaves": 6056.0, "resipi": 6058.0}


@pytest.mark.parametrize("layout", ["mesh", "hex"])
def test_simulate_residency_active_cycles_and_layouts(layout):
    jcfg, tcfg = (jconst.NETWORK, tconst.NETWORK) if layout == "mesh" \
        else (jtopo.hex_config(2), ttopo.hex_config(2))
    want = jops.simulate_residency(0.3, 2, 4, cycles=512, seed=3, cfg=jcfg,
                                   active_cycles=300, interpret=True)
    got = tops.simulate_residency(0.3, 2, 4, cycles=512, seed=3, cfg=tcfg,
                                  active_cycles=300, device="cpu")
    assert got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert got[1] == pytest.approx(want[1], rel=RTOL)
    with pytest.raises(ValueError, match="active_cycles"):
        tops.simulate_residency(0.3, 2, 4, cycles=64, active_cycles=65,
                                device="cpu")


def test_kernel_routing_view_of_the_one_hot_matrix():
    """The kernel wrapper's next-hop gather and in-edge lists (built on any
    device) describe the same routing as the matrix; non-one-hot matrices
    and in-degrees above the kernel's bound raise."""
    nm, _, _, mask = jops.build_topology_padded(3, 4, pad_to=24)
    next_hop, in_src = tops.routing(torch.as_tensor(nm)[None])
    assert next_hop.dtype == in_src.dtype == torch.int32
    assert in_src.shape == (1, 24, tops.MAX_IN_DEGREE)
    for i in range(24):
        row = np.flatnonzero(nm[i])
        assert int(next_hop[0, i]) == (int(row[0]) if row.size else -1)
        srcs = [int(s) for s in in_src[0, i] if s >= 0]
        assert srcs == list(np.flatnonzero(nm[:, i]))       # ascending
    with pytest.raises(ValueError, match="one-hot"):
        tops.routing(torch.as_tensor(nm * 0.5))
    star = np.zeros((9, 9), np.float32)
    star[1:, 0] = 1.0                                     # in-degree 8
    with pytest.raises(ValueError, match="in-degree"):
        tops.routing(torch.as_tensor(star))


def _prefix(nm, mask):
    next_hop, in_src = tops.routing(torch.as_tensor(nm))
    return tops.active_prefix(torch.as_tensor(mask), next_hop, in_src)


@pytest.mark.parametrize("radix", [4, 8])
def test_active_prefix_of_the_dse_topologies(radix):
    """The residency DSE's padded topologies: radix 4 runs keep 16 routers
    plus g sinks (one warp of the "node" kernel), radix 8 runs 64 plus g
    (three warps), whatever the 68-node pad."""
    cfg = tconst.NETWORK.with_topology(mesh_radix=radix)
    for g in (1, 2, 3, 4):
        for w in (2, 16):
            nm, _, _, mask = tops.build_topology_padded(g, w, cfg,
                                                        pad_to=68)
            r_act = _prefix(nm[None], mask[None])
            assert r_act.dtype == torch.int32
            assert r_act.tolist() == [radix * radix + g]
            assert (int(r_act) + 31) // 32 == (1 if radix == 4 else 3)


def test_active_prefix_follows_routing_past_the_live_mask():
    """hex_config(2) unpadded and padded; a router routed into a dead lane
    past the live nodes stretches the prefix to that lane; a run with no
    live or routed node has an empty prefix."""
    hexc = ttopo.hex_config(2)
    nm, _, _, _ = tops.build_topology(2, 4, hexc)
    n = nm.shape[0]
    assert _prefix(nm[None], np.ones((1, n), np.float32)).tolist() == [n]
    nm, _, _, mask = tops.build_topology_padded(2, 4, hexc, pad_to=40)
    assert _prefix(nm[None], mask[None]).tolist() == [n]
    nm, _, _, mask = tops.build_topology_padded(2, 4, pad_to=40)
    live = int(mask.sum())
    nm = nm.copy()
    nm[3] = 0.0
    nm[3, 37] = 1.0                       # into a dead lane
    assert _prefix(nm[None], mask[None]).tolist() == [38]
    assert live < 38 and mask[37] == 0
    batch = np.stack([nm, np.zeros_like(nm)])
    masks = np.stack([mask, np.zeros_like(mask)])
    assert _prefix(batch, masks).tolist() == [38, 0]


def _exchange_emulation(case, exchanges: int):
    """One cycle loop of the kernels in torch, over every node of every run
    at once: the "warp" kernel's three exchanges (send, scale, moved; the
    inflow sums moved over the in-edges) or the "node" kernel's two (the
    inflow sums each in-edge sender's send, read while forming want, times
    the destination's own scale). In-edges in ascending source order."""
    arr, nm, drain, buf = case.args
    batched = arr.dim() == 3
    lift = (lambda x: x) if batched else (lambda x: x[None])
    arr, nm = lift(arr), lift(nm)
    b, t, r = arr.shape

    def per_run(x, shape):
        return torch.ones(shape) if x is None else x.expand(shape).float()

    mask = per_run(case.kwargs.get("valid_mask"), (b, r))
    mask_t = case.kwargs.get("valid_mask_t")
    mask_t = None if mask_t is None \
        else per_run(lift(mask_t), (b, t, r)) * mask[:, None]
    t_mask = per_run(case.kwargs.get("t_mask"), (b, t))
    drain, buf = per_run(drain, (b, r)), per_run(buf, (b, r))
    next_hop, in_src = tops.routing(nm.expand(b, r, r))
    nh, src = next_hop.long(), in_src.long()
    has = src >= 0
    is_router = (nh >= 0).float()

    def gather_in(v):                      # [B, R] -> [B, R, K] by in-edge
        return torch.where(has, v.gather(1, src.clamp(min=0).flatten(1))
                           .view(src.shape), 0.0)

    occ = resid = drained = torch.zeros(b, r)
    for i in range(t):
        m = mask if mask_t is None else mask_t[:, i]
        tm = t_mask[:, i, None]
        occ1 = (occ + arr[:, i]) * m
        send = torch.clamp(occ1, max=1.0) * is_router
        sv = gather_in(send)
        want = torch.zeros(b, r)
        for k in range(src.shape[-1]):
            want = want + sv[..., k]
        space = torch.clamp(buf - occ1, min=0.0)
        scale = torch.where(want > 0.0, torch.clamp(
            space / torch.clamp(want, min=1e-9), max=1.0), 0.0)
        moved = send * torch.where(nh >= 0, scale.gather(1, nh.clamp(min=0)),
                                   0.0)
        terms = gather_in(moved) if exchanges == 3 \
            else torch.where(has, sv * scale[..., None], 0.0)
        inflow = torch.zeros(b, r)
        for k in range(src.shape[-1]):
            inflow = inflow + terms[..., k]
        o = occ1 - moved + inflow * m
        sunk = torch.minimum(o, drain)
        o = o - sunk
        occ, resid, drained = (tm * o + (1.0 - tm) * occ, resid + tm * o,
                               drained + tm * sunk)
    out = (resid, occ, drained)
    return out if batched else tuple(x[0] for x in out)


@pytest.mark.parametrize("name", tcases.NAMES)
def test_two_exchanges_a_cycle_are_bitwise_three(name):
    """The "node" kernel's cycle (inflow from the senders' send values and
    the destination's scale) is bitwise the "warp" kernel's (inflow from a
    third exchange of moved), and both hold the plain version at rtol 1e-5
    / atol 1e-3 on the shared kernel cases, at T = 128."""
    case, = tcases.kernel_cases("cpu", 128, names=[name])
    two = _exchange_emulation(case, 2)
    three = _exchange_emulation(case, 3)
    for a, b in zip(two, three):
        assert torch.equal(a, b)
    want = tops.noc_run(*case.args, **case.kwargs)
    for a, w in zip(two, want):
        torch.testing.assert_close(a, w, rtol=RTOL, atol=ATOL)
