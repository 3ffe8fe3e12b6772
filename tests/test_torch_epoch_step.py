"""Parity of the port's plain `epoch_step` version with the JAX reference.

`repro_torch.kernels.epoch_step.ref.epoch_run_reference` (a Python loop
over the port's batched `make_step`) against the reference's
`repro.kernels.epoch_step.ref.epoch_run_reference` (`lax.scan` over its
`make_step`, the oracle the TPU kernel was held to) in five cases: clean,
destination matrices, a ragged `t_mask` with an all-masked lane, fault
frames, and faults + destinations + `t_mask` together. Both start from the
same non-initial carry; records and final state must agree at
rtol = atol = 1e-6 (the reference's own bound for this kernel), with
integer g and boolean saturation exact. The CPU path of the kernel wrapper
(`ops.epoch_run`) must be the plain version itself.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulator as jsim
from repro.core import selection as jsel
from repro.core.gateway_controller import ControllerState as JCtl
from repro.kernels.epoch_step.ref import epoch_run_reference as jax_ref
from repro_torch import interop
from repro_torch.core import simulator as tsim
from repro_torch.kernels.epoch_step import ops
from repro_torch.kernels.epoch_step.ref import epoch_run_reference

N, T, C, G = 3, 24, 4, 4
CASES = ("clean", "dest", "ragged", "faults", "faults_dest_tmask")


def _inputs(case: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    ext = (rng.rand(N, T, C) * 0.06).astype(np.float32)
    intra = (rng.rand(N, T, C) * 0.08).astype(np.float32)
    mem = (rng.rand(N, T) * 0.05).astype(np.float32)
    frac = np.full((N, T), 0.4, np.float32)
    tm = np.ones((N, T), np.float32)
    if case in ("ragged", "faults_dest_tmask"):
        tm[0, 17:] = 0.0          # ragged tail
        tm[1, :] = 0.0            # the all-masked lane
        tm[2, 5:9] = 0.0          # a mask-interior gap
    dest = None
    if case in ("dest", "faults_dest_tmask"):
        d = rng.rand(N, C, C).astype(np.float32)
        for n in range(N):
            np.fill_diagonal(d[n], 0.0)
        dest = (d / d.sum(-1, keepdims=True)).astype(np.float32)
    flt = None
    if case.startswith("faults"):
        ok = np.ones((N, T, C, G), np.float32)
        ok[:, 4:12, 1, 0] = 0.0                    # a dead slot window
        ok[:, 10:14, 3, :] = 0.0                   # a whole chiplet down
        stuck = np.zeros((N, T, C, G), np.float32)
        stuck[:, 3:20, 2, 3] = 1.0                 # one stuck-on cell
        drift = np.clip(0.08 * np.arange(T, dtype=np.float32) - 0.4,
                        0.0, 1.0)[None].repeat(N, 0).astype(np.float32)
        flt = (ok, stuck, drift)
    # A non-initial carry: the all-masked lane must return it untouched.
    g = rng.randint(1, G + 1, size=(N, C)).astype(np.int32)
    ps = rng.rand(N, C).astype(np.float32)
    epoch = np.full((N,), 5, np.int32)
    lam = np.full((N, C), 4, np.int32)
    prev = rng.rand(N, C * G + 2) < 0.5
    return dict(ext=ext * tm[..., None], intra=intra * tm[..., None],
                mem=mem * tm, frac=frac, tm=tm, dest=dest, flt=flt,
                state=(g, ps, epoch, lam, prev))


@functools.lru_cache(maxsize=None)
def _jax_runner(sim, faulted, with_dest):
    tables = jsel.selection_tables_jax(sim.cfg)

    @jax.jit
    def run(state, xs, dest):
        return jax_ref(state, xs, sim, tables,
                       dest=dest if with_dest else None, faulted=faulted)
    return run


def _run_jax(inp, sim):
    g, ps, epoch, lam, prev = inp["state"]
    faulted = inp["flt"] is not None
    run = _jax_runner(sim, faulted, inp["dest"] is not None)
    recs, states = [], []
    for n in range(N):
        state = jsim.SimState(
            ctl=JCtl(g=jnp.asarray(g[n]), packets_seen=jnp.asarray(ps[n]),
                     epoch=jnp.int32(epoch[n])),
            wavelengths=jnp.asarray(lam[n]),
            prev_active=jnp.asarray(prev[n]))
        xs = (inp["ext"][n], inp["mem"][n], inp["intra"][n], inp["frac"][n],
              inp["tm"][n])
        if faulted:
            xs = xs + tuple(f[n] for f in inp["flt"])
        dest = None if inp["dest"] is None else inp["dest"][n]
        st, rec = run(state, xs, dest)
        recs.append({k: np.asarray(v) for k, v in rec.items()})
        states.append({"g": st.ctl.g, "packets_seen": st.ctl.packets_seen,
                       "epoch": st.ctl.epoch, "wavelengths": st.wavelengths,
                       "prev_active": st.prev_active})
    stack = lambda ds: {k: np.stack([np.asarray(d[k]) for d in ds])  # noqa
                        for k in ds[0]}
    return stack(states), stack(recs)


def _port_args(inp, sim):
    state = interop.state_from_numpy(*inp["state"], device="cpu")
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    xs = (t(inp["ext"]), t(inp["mem"]), t(inp["intra"]), t(inp["frac"]),
          t(inp["tm"]))
    faulted = inp["flt"] is not None
    if faulted:
        xs = xs + tuple(t(f) for f in inp["flt"])
    dest = None if inp["dest"] is None else t(inp["dest"])
    tables = interop.tables_from_numpy(
        tsim.build_selection_tables(sim.cfg), "cpu")
    return state, xs, tables, dest, faulted


def _assert_match(got_state, got_recs, want_state, want_recs):
    got_state = interop.records_to_numpy(got_state)
    got_recs = interop.records_to_numpy(got_recs)
    assert set(got_recs) == set(want_recs)
    for name, got, want in ([("state." + k, got_state[k], want_state[k])
                             for k in want_state]
                            + [(k, got_recs[k], want_recs[k])
                               for k in want_recs]):
        assert got.shape == want.shape, name
        if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("arch", [tsim.Arch.RESIPI, tsim.Arch.RESIPI_ALL],
                         ids=lambda a: a.value)
@pytest.mark.parametrize("case", CASES)
def test_plain_epoch_run_matches_reference(case, arch):
    inp = _inputs(case, seed=CASES.index(case))
    jsim_cfg = jsim.SimConfig().with_arch(jsim.Arch(arch.value))
    tsim_cfg = tsim.SimConfig().with_arch(arch)
    want_state, want_recs = _run_jax(inp, jsim_cfg)
    state, xs, tables, dest, faulted = _port_args(inp, tsim_cfg)
    got_state, got_recs = epoch_run_reference(state, xs, tsim_cfg, tables,
                                              dest=dest, faulted=faulted)
    _assert_match(got_state, got_recs, want_state, want_recs)
    if case in ("ragged", "faults_dest_tmask"):
        # The all-masked lane keeps its input carry bit for bit.
        s = interop.records_to_numpy(got_state)
        g, ps, epoch, lam, prev = inp["state"]
        np.testing.assert_array_equal(s["g"][1], g[1])
        np.testing.assert_array_equal(s["packets_seen"][1], ps[1])
        assert s["epoch"][1] == epoch[1]
        np.testing.assert_array_equal(s["prev_active"][1], prev[1])


@pytest.mark.parametrize("case", ["clean", "faults_dest_tmask"])
def test_wrapper_takes_the_plain_version_on_cpu(case):
    """`ops.epoch_run` on CPU tensors is the plain loop: same results, a
    loop run counted, no kernel launch."""
    inp = _inputs(case, seed=7)
    sim = tsim.SimConfig()
    state, xs, tables, dest, faulted = _port_args(inp, sim)
    tsim.reset_engine_stats()
    got = ops.epoch_run(state, xs, sim, tables, dest=dest, faulted=faulted)
    stats = tsim.engine_stats()
    assert stats["epoch_step_launches"] == 0 and stats["loop_runs"] == 1
    want = epoch_run_reference(state, xs, sim, tables, dest=dest,
                               faulted=faulted)
    _assert_match(got[0], got[1], interop.records_to_numpy(want[0]),
                  interop.records_to_numpy(want[1]))


def test_lane_trace_and_knobs_select_trace_and_config():
    """Lanes that share a trace but carry their own knobs equal separate
    runs of a config holding those values."""
    inp = _inputs("dest", seed=3)
    sim = tsim.SimConfig()
    state, xs, tables, dest, _ = _port_args(inp, sim)
    lane_trace = torch.tensor([2, 0, 2])
    knobs = tsim.default_knobs(sim, 3, "cpu", {
        "l_m": torch.tensor([0.006, 0.02, 0.03]),
        "max_gateways": torch.tensor([4, 3, 2], dtype=torch.int32)})
    lane_state = tsim._initial_state(sim, knobs)
    got_state, got = epoch_run_reference(lane_state, xs, sim, tables,
                                         dest=dest, lane_trace=lane_trace,
                                         knobs=knobs)
    import dataclasses
    for b, (n, lm, mg) in enumerate(((2, 0.006, 4), (0, 0.02, 3),
                                     (2, 0.03, 2))):
        one = dataclasses.replace(sim, ctl=dataclasses.replace(
            sim.ctl, l_m=lm, max_gateways=mg))
        one_knobs = tsim.default_knobs(one, 1, "cpu")
        st, rec = epoch_run_reference(
            tsim._initial_state(one, one_knobs),
            tuple(a[n:n + 1] for a in xs), one, tables,
            dest=dest[n:n + 1], knobs=one_knobs)
        for k in rec:
            assert torch.equal(got[k][b], rec[k][0]), k
        assert torch.equal(got_state.ctl.g[b], st.ctl.g[0])


def _split_emulation(state, xs, sim, tables, dest, faulted):
    """The "split" kernel's structure in torch, lane n on trace n with the
    config's knobs: the controller recurrence alone over T (it reads the
    trace's ext row, recv = ext @ dest summed in source order, g, the
    effective g under faults and the lane's knobs, and nothing the metrics
    compute), then every metric of every (lane, interval) at once from the
    g sequence it wrote. Returns (final g, records [B, T, ...])."""
    from repro_torch.core import photonics
    from repro_torch.core.gateway_controller import (ControllerState,
                                                     epoch_step)

    ext, mem, intra, _frac, tmask = xs[:5]
    gw_ok, stuck, drift = xs[5:8] if faulted else (None,) * 3
    b, t, c = ext.shape
    cfg = sim.cfg
    knobs = tsim.default_knobs(sim, b, "cpu")
    slots = torch.arange(cfg.max_gateways_per_chiplet)

    def usable_and_lit(g, ok, st):
        usable = (slots < g[..., None]).to(torch.float32) * ok
        lit = torch.maximum(usable, st * ok).flatten(-2)
        mem_on = torch.ones(g.shape[:-1] + (cfg.memory_gateways,))
        return usable, torch.cat([lit, mem_on], dim=-1) > 0.5

    # 1. The recurrence: g after each interval (the carry, frozen when
    # masked).
    g = state.ctl.g
    after = []
    interval = float(cfg.reconfig_interval_cycles)
    ctl_cfg = tsim._lane_sim(sim, knobs).ctl
    for i in range(t):
        if sim.arch == tsim.Arch.RESIPI:
            e = ext[:, i]
            pressure = e
            if dest is not None:
                w = e[:, :, None] * dest
                recv = w[:, 0]
                for j in range(1, c):
                    recv = recv + w[:, j]
                pressure = torch.maximum(e, recv)
            packets = pressure * interval
            if faulted:
                usable, _ = usable_and_lit(g, gw_ok[:, i], stuck[:, i])
                g_eff = torch.sum(usable, dim=-1).to(torch.int32)
                packets = packets * (g.to(torch.float32) / torch.clamp_min(
                    g_eff.to(torch.float32), 1.0))
            ctl = ControllerState(g=g, packets_seen=torch.zeros_like(e),
                                  epoch=torch.zeros(b, dtype=torch.int32))
            g_new = epoch_step(ctl, packets, interval, ctl_cfg)[0].g
            g = torch.where(tmask[:, i, None] > 0, g_new, g)
        after.append(g)
    g_after = torch.stack(after, dim=1)
    g_before = torch.cat([state.ctl.g[:, None], g_after[:, :-1]], dim=1)

    # 2. The metrics of all B x T (lane, interval) items as one batch.
    def rows(x):
        return x.reshape((b * t,) + tuple(x.shape[2:]))

    row_knobs = {k: v.repeat_interleave(t) for k, v in knobs.items()}
    lane = tsim._lane_sim(sim, row_knobs)
    gb, ga, tv = rows(g_before), rows(g_after), rows(tmask)
    if faulted:
        usable, active = usable_and_lit(gb, rows(gw_ok), rows(stuck))
        g_eff = torch.sum(usable, dim=-1).to(torch.int32)
    else:
        g_eff, active = gb, tsim._activity_mask(gb, sim)
    lam = lane.wavelengths[:, None]
    m = tsim._interval_metrics(
        g_eff, lam, rows(ext), rows(mem), rows(intra), lane, tables, tv,
        extra_db=rows(drift) if faulted else None,
        dest=None if dest is None else dest.repeat_interleave(t, dim=0))
    pw = photonics.interposer_power_mw(
        active, lane.wavelengths, n_gateways=cfg.total_gateways, mode="pcm",
        loss_db=m["access_db"], n_chiplets=c)
    reconf = torch.zeros(b * t)
    if sim.arch == tsim.Arch.RESIPI:
        new_active = usable_and_lit(ga, rows(gw_ok), rows(stuck))[1] \
            if faulted else tsim._activity_mask(ga, sim)
        reconf = photonics.reconfig_energy_nj(active, new_active)
    tv_i = tv.to(torch.int32)[:, None]
    rec = {"latency": m["latency"], "power_mw": pw["total_mw"] * tv,
           "laser_mw": pw["laser_mw"] * tv,
           "energy": pw["total_mw"] * m["latency"],
           "reconfig_nj": reconf * tv, "g": g_eff * tv_i,
           "wavelengths": lam * torch.ones((b * t, c)) * tv[:, None],
           "gw_load": m["gw_load"],
           "mean_inter_latency": m["mean_inter_latency"],
           "saturated": m["saturated"]}
    if faulted:
        rec["g_desired"] = gb * tv_i
        dead = (slots < gb[..., None]) & (rows(gw_ok) < 0.5)
        rec["failed_slots"] = torch.sum(dead, dim=(-2, -1)).to(
            torch.float32) * tv
    return g, {k: v.reshape((b, t) + tuple(v.shape[1:]))
               for k, v in rec.items()}


@pytest.mark.parametrize("arch", [tsim.Arch.RESIPI, tsim.Arch.RESIPI_ALL],
                         ids=lambda a: a.value)
@pytest.mark.parametrize("case", CASES)
def test_split_recurrence_then_metrics_is_the_loop(case, arch):
    """The "split" kernel's two passes, emulated in torch, equal the plain
    interval loop at rtol = atol = 1e-6 with g and saturation exact: the
    controller recurrence needs nothing the metrics compute. The ragged
    cases hold an all-masked lane and valid intervals right before masked
    ones, whose switch counts need the controller's output although the
    carry freezes over the masked interval after them."""
    inp = _inputs(case, seed=CASES.index(case))
    sim = tsim.SimConfig().with_arch(arch)
    state, xs, tables, dest, faulted = _port_args(inp, sim)
    if case in ("ragged", "faults_dest_tmask"):
        tm = xs[4]
        assert bool(((tm[:, :-1] > 0) & (tm[:, 1:] == 0)).any())
        assert bool((tm.sum(dim=1) == 0).any())
    g_final, got = _split_emulation(state, xs, sim, tables, dest, faulted)
    want_state, want = epoch_run_reference(state, xs, sim, tables,
                                           dest=dest, faulted=faulted)
    assert set(got) == set(want)
    assert torch.equal(g_final, want_state.ctl.g)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if want[k].dtype in (torch.bool, torch.int32):
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
        else:
            torch.testing.assert_close(got[k], want[k], rtol=1e-6,
                                       atol=1e-6, msg=k)


# The fewest lanes at which "split" (C <= 16) or "warp" (17-128) runs
# instead of "wide", by the most chiplets each entry covers, as measured on
# the card; past the last entry "wide" runs whatever the lanes.
WANT_MIN_LANES = {False: ((8, 1), (12, 16), (16, 32), (64, 512),
                          (128, 1024)),
                  True: ((4, 1), (8, 32), (16, 64), (32, 512), (48, 1024))}


@pytest.mark.parametrize("faulted", [False, True])
@pytest.mark.parametrize("c", [1, 4, 5, 8, 9, 12, 13, 16, 17, 32, 33, 48,
                               49, 64, 65, 128, 129, 256, 1024])
def test_variant_by_chiplet_count(c, faulted):
    """"split" up to 16 chiplets and "warp" at 17-128 once there are the
    lanes at which they measured faster than "wide" on the card, "wide"
    below and past 128 chiplets up to 1024; fault frames change nothing;
    nothing beyond 1024."""
    assert ops.MAX_CHIPLETS >= 1024
    assert ops.MIN_LANES == WANT_MIN_LANES
    for dest in (False, True):
        least = next((n for top, n in WANT_MIN_LANES[dest] if c <= top),
                     None)
        for lanes in (1, 8, 15, 16, 31, 32, 63, 64, 511, 512, 1023, 1024,
                      32768):
            if least is None or lanes < least:
                want = "wide"
            else:
                want = "split" if c <= 16 else "warp"
            assert ops.variant(c, faulted, dest, lanes) == want, (dest,
                                                                  lanes)
    for bad in (0, ops.MAX_CHIPLETS + 1):
        with pytest.raises(ValueError, match="chiplets"):
            ops.variant(bad, faulted, False, 1)
