"""Physics parity: the port's photonics, NoC queueing and gateway-controller
functions against the JAX reference on randomized inputs at 1e-6.

Inputs are drawn with numpy from fixed seeds and handed to both packages.
The reference side runs under `jax.jit` with its model objects closed over,
as the simulator runs it, so constant divisors fold exactly as they do
there. Integer and boolean outputs (gateway counts, activity, saturation)
must match exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gateway_controller as jgc
from repro.core import noc as jnoc
from repro.core import photonics as jph
from repro_torch.core import gateway_controller as tgc
from repro_torch.core import noc as tnoc
from repro_torch.core import photonics as tph

RTOL = ATOL = 1e-6


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", range(2))
def test_kappa_schedule_and_reconfig_energy(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(2, 24))
    prev = rng.rand(6, n) < rng.rand()
    new = rng.rand(6, n) < rng.rand()
    kappa = jax.jit(jph.kappa_schedule)
    energy = jax.jit(jph.reconfig_energy_nj)
    for i in range(6):
        _close(tph.kappa_schedule(torch.as_tensor(prev[i])), kappa(prev[i]))
        _close(tph.reconfig_energy_nj(torch.as_tensor(prev[i]),
                                      torch.as_tensor(new[i])),
               energy(prev[i], new[i]))
    # Batched lanes equal the per-row reference.
    _close(tph.reconfig_energy_nj(torch.as_tensor(prev),
                                  torch.as_tensor(new)),
           np.stack([np.asarray(jph.reconfig_energy_nj(p, q))
                     for p, q in zip(prev, new)]))


@pytest.mark.parametrize("mode", ["pcm", "wdm", "static"])
@pytest.mark.parametrize("seed", range(3))
def test_interposer_power_all_modes(mode, seed):
    rng = np.random.RandomState(10 + seed)
    n = 18
    active = rng.rand(n) < 0.6
    lam = rng.randint(1, 17, size=n).astype(np.float32) \
        if mode == "wdm" else np.float32(rng.randint(1, 9))
    loss = np.float32(rng.rand() * 3.0)
    ref = jax.jit(lambda a, w, l: jph.interposer_power_mw(
        a, w, n_gateways=n, mode=mode, loss_db=l))(active, lam, loss)
    got = tph.interposer_power_mw(torch.as_tensor(active),
                                  torch.as_tensor(lam), n_gateways=n,
                                  mode=mode, loss_db=torch.as_tensor(loss))
    for k in ref:
        _close(got[k], ref[k])


def _noc_pair(bsat, burst):
    return (jnoc.NocModel(buffer_sat=bsat, burstiness=burst),
            tnoc.NocModel(buffer_sat=bsat, burstiness=burst))


@pytest.mark.parametrize("seed", range(4))
def test_noc_latencies(seed):
    rng = np.random.RandomState(20 + seed)
    bsat = float(rng.choice([0.55, 0.65, 0.5 + 0.4 * rng.rand()]))
    jm, tm = _noc_pair(bsat, float(1.0 + 3.0 * rng.rand()))
    load = (rng.rand(64) * 0.15).astype(np.float32)
    hops = (rng.rand(64) * 4.0).astype(np.float32)
    lam = rng.randint(1, 17, size=64).astype(np.float32)
    bs = rng.rand(64).astype(np.float32)
    link = (rng.rand(64) * 1.2).astype(np.float32)
    t = torch.as_tensor
    checks = [
        (lambda: tm.serialization_cycles(t(lam)),
         jax.jit(jm.serialization_cycles)(lam)),
        (lambda: tm.gateway_latency(t(load), t(lam)),
         jax.jit(jm.gateway_latency)(load, lam)),
        (lambda: tm.access_latency(t(hops), t(load)),
         jax.jit(jm.access_latency)(hops, load)),
        (lambda: tm.access_latency(t(hops), t(load), t(bs)),
         jax.jit(jm.access_latency)(hops, load, bs)),
        (lambda: tm.mesh_latency(t(np.float32(2.5)), t(link)),
         jax.jit(jm.mesh_latency)(np.float32(2.5), link)),
        (lambda: tm.inter_chiplet_latency(t(load), t(lam), t(hops), t(hops)),
         jax.jit(jm.inter_chiplet_latency)(load, lam, hops, hops)),
        (lambda: tm.saturated(t(load), t(lam)),
         jax.jit(jm.saturated)(load, lam)),
    ]
    for port_fn, want in checks:
        _close(port_fn(), want)
    assert tnoc.uniform_mesh_mean_hops() == jnoc.uniform_mesh_mean_hops()


@pytest.mark.parametrize("seed", range(4))
def test_controller_functions(seed):
    rng = np.random.RandomState(30 + seed)
    l_m = float(0.004 + 0.03 * rng.rand())
    max_g = int(rng.randint(2, 6))
    jc = jgc.ControllerConfig(l_m=l_m, max_gateways=max_g, min_gateways=1)
    tc = tgc.ControllerConfig(l_m=l_m, max_gateways=max_g, min_gateways=1)
    g = rng.randint(0, max_g + 1, size=16).astype(np.int32)
    load = (rng.rand(16) * 2.5 * l_m).astype(np.float32)
    packets = (rng.rand(16) * 4.0e4).astype(np.float32)
    t = torch.as_tensor
    _close(tgc.t_p(tc), jgc.t_p(jc))
    _close(tgc.t_n(t(g), tc), jax.jit(lambda x: jgc.t_n(x, jc))(g))
    _close(tgc.average_gateway_load(t(packets), 1e6, t(g)),
           jax.jit(jgc.average_gateway_load)(packets, jnp.float32(1e6), g))
    _close(tgc.update_gateways(t(g), t(load), tc),
           jax.jit(lambda a, b: jgc.update_gateways(a, b, jc))(g, load))

    state_j = jgc.ControllerState(g=jnp.asarray(g), packets_seen=jnp.zeros(
        16, jnp.float32), epoch=jnp.int32(3))
    state_t = tgc.ControllerState(g=t(g), packets_seen=torch.zeros(16),
                                  epoch=torch.tensor(3, dtype=torch.int32))
    new_j, rec_j = jax.jit(lambda s, p: jgc.epoch_step(s, p, 1e6, jc))(
        state_j, packets)
    new_t, rec_t = tgc.epoch_step(state_t, t(packets), 1e6, tc)
    for k in rec_j:
        _close(rec_t[k], rec_j[k])
    _close(new_t.g, new_j.g)
    _close(new_t.epoch, new_j.epoch)
    _close(new_t.packets_seen, new_j.packets_seen)

    init_t = tgc.ControllerState.init(5, tc, device="cpu")
    init_j = jgc.ControllerState.init(5, jc)
    _close(init_t.g, init_j.g)
    assert init_t.g.dtype == torch.int32


def test_controller_knobs_broadcast_per_lane():
    """Per-lane knob tensors give each lane its own scalar config's
    decision (the port's replacement for vmapped overrides)."""
    rng = np.random.RandomState(7)
    l_m = np.float32([0.008, 0.015, 0.03])
    g = rng.randint(1, 5, size=(3, 4)).astype(np.int32)
    load = (rng.rand(3, 4) * 0.04).astype(np.float32)
    lanes = tgc.ControllerConfig(l_m=torch.as_tensor(l_m)[:, None],
                                 max_gateways=torch.tensor([[4], [3], [2]]),
                                 min_gateways=1)
    got = tgc.update_gateways(torch.as_tensor(g), torch.as_tensor(load),
                              lanes)
    for i, (lm, mx) in enumerate(zip(l_m, (4, 3, 2))):
        want = jgc.update_gateways(g[i], load[i], dataclasses.replace(
            jgc.ControllerConfig(), l_m=float(lm), max_gateways=mx))
        _close(got[i], want)


@pytest.mark.parametrize("seed", range(2))
def test_pcmc_coupler_eqs_1_to_3(seed):
    rng = np.random.RandomState(60 + seed)
    am = (rng.rand(32) * 3.0).astype(np.float32)
    cr = (rng.rand(32) * 3.0).astype(np.float32)
    cr[:2] = 0.0                                  # floored at 1e-12
    t = torch.as_tensor
    _close(tph.pcmc_coupling_ratio(t(am), t(cr)),
           jax.jit(jph.pcmc_coupling_ratio)(am, cr))
    p_in = (rng.rand(32) * 20.0).astype(np.float32)
    kappa = rng.rand(32).astype(np.float32)
    kappa[:3] = (0.0, 1.0, 0.5)                   # Fig. 5's three states
    for loss in (0.0, 0.7):
        got = tph.pcmc_split(t(p_in), t(kappa), loss)
        want = jax.jit(lambda p, k: jph.pcmc_split(p, k, loss))(p_in, kappa)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("n", [2, 5, 18])
def test_power_division_eq4_chain(n):
    rng = np.random.RandomState(70 + n)
    active = rng.rand(6, n) < rng.rand()
    active[0] = False
    active[1] = True
    laser = np.float32(10.0 + 200.0 * rng.rand())
    div = jax.jit(jph.power_division)
    got = tph.power_division(torch.as_tensor(active), laser)
    for i in range(6):
        _close(got[i], div(active[i], laser))
        _close(tph.power_division(torch.as_tensor(active[i]), laser),
               div(active[i], laser))
    # Every active gateway receives laser / GT (Eq. 4), idle ones nothing.
    gt = active.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(
        got.numpy(), np.where(active, laser / np.maximum(gt, 1), 0.0),
        rtol=1e-4, atol=1e-4)


def test_interposer_geometry_counts():
    for n, w in ((6, 4), (18, 64), (1, 1), (260, 16)):
        got = tph.InterposerGeometry(n_gateways=n, wavelengths=w)
        want = jph.InterposerGeometry(n_gateways=n, wavelengths=w)
        for k in ("mrgs", "pcmcs", "modulators_per_mrg", "filters_per_mrg",
                  "total_mrs"):
            assert getattr(got, k) == getattr(want, k), k
    assert tph.InterposerGeometry(6, 4).total_mrs == 6 * 24


@pytest.mark.parametrize("seed", range(2))
def test_scan_controller_replays_the_reference(seed):
    rng = np.random.RandomState(80 + seed)
    cfg_kw = dict(l_m=float(0.004 + 0.03 * rng.rand()),
                  max_gateways=int(rng.randint(2, 6)), min_gateways=1)
    loads = (rng.rand(24, 16) * 3.0 * cfg_kw["l_m"]).astype(np.float32)
    want = jgc.scan_controller(loads, jgc.ControllerConfig(**cfg_kw), 1e6)
    tc = tgc.ControllerConfig(**cfg_kw)
    got = tgc.scan_controller(torch.as_tensor(loads), tc, 1e6)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    # Arrays go to the device asked for; the card is the default.
    again = tgc.scan_controller(loads, tc, 1e6, device="cpu")
    for k in got:
        assert torch.equal(again[k], got[k]), k
