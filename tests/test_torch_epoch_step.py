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
