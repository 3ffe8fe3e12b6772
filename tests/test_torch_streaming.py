"""Streaming parity: `SimSession`, `simulate_stream` and the session-tick
packing surface (`init_session_states`, `session_tick`,
`session_sums_zero`, `summary_from_sums`) of the port against itself and
against the JAX reference on the CPU.

Within the port, bit for bit: a chunked run gives the records of a one-shot
`simulate` of the concatenated trace (per arch, with a ragged last chunk
padded under `t_mask`); lane k of `session_tick` gives the records and
sums of a standalone `SimSession` stepping the same chunks (per-lane
destination matrices, one shared fault frame, a parked all-masked lane),
and the old carry is left untouched. Against the reference (its default
scan body; its Pallas kernel does not trace on the installed jax): records
and summaries at rtol = atol = 1e-6, integer g and boolean saturation
exact. Inputs are reference-made traces carried across with `interop`.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import simulator as jsim
from repro.core import traffic as jtr
from repro.core.selection import selection_tables_jax
from repro_torch import interop
from repro_torch.core import faults as tfaults
from repro_torch.core import simulator as tsim

ARCHS = [a.value for a in jsim.Arch]
APPS = ("blackscholes", "canneal", "facesim", "dedup")


def _np(tr):
    return {k: (v if k == "app" else np.asarray(v)) for k, v in tr.items()}


def _trace(app="dedup", t=30, seed=0, dest=False):
    return _np(jtr.generate(jtr.ParsecSpec(app, t), jax.random.PRNGKey(seed),
                            dest=dest))


def _port(tr):
    return interop.trace_from_numpy(tr, "cpu")


def _cfgs(arch):
    return (jsim.SimConfig().with_arch(jsim.Arch(arch)),
            tsim.SimConfig().with_arch(tsim.Arch(arch)))


def _match(got, want, what=""):
    got = interop.records_to_numpy(got)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{what} {k}")


def _equal(got: dict, want: dict, what=""):
    assert set(got) == set(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what} {k}"


@pytest.mark.parametrize("dest", [False, True], ids=["clean", "dest"])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_equals_one_shot_and_the_reference(arch, dest):
    """30 intervals in chunks of 8 (the last one padded to 8 under t_mask):
    the concatenated records are the one-shot run's bit for bit, and the
    reference's streamed records and running summary at 1e-6."""
    jcfg, tcfg = _cfgs(arch)
    ref = _trace(t=30, seed=3, dest=dest)
    one = tsim.simulate(_port(ref), tcfg, device="cpu")
    sess = tsim.SimSession.init(tcfg, device="cpu")
    jsess = jsim.SimSession.init(jcfg)
    recs = []
    for chunk in jtr.chunk_trace(ref, 8, pad=True):
        chunk = _np(chunk)
        out = sess.step_chunk(_port(chunk))
        want = jsess.step_chunk(chunk)
        _match(out["records"], want["records"], "chunk records")
        _match(out["summary"], want["summary"], "chunk summary")
        recs.append(out["records"])
    for k, v in one["records"].items():
        assert torch.equal(torch.cat([r[k] for r in recs])[:30], v), k
    assert sess.intervals_seen == jsess.intervals_seen == 30
    _match(sess.summary(), jsess.summary(), "running summary")
    np.testing.assert_allclose(
        interop.records_to_numpy(sess.summary())["mean_latency"],
        interop.records_to_numpy(one["summary"])["mean_latency"], rtol=1e-6)


def test_faulted_chunks_and_interior_mask_freeze_the_carry():
    """A fault frame riding the chunks (sliced with them) and a mask-
    interior gap: chunked == one-shot bitwise, == the reference at 1e-6;
    an all-masked chunk leaves the carry exactly as it was."""
    jcfg, tcfg = _cfgs("resipi")
    ref = _trace(t=24, seed=5, dest=True)
    frame = jfaults.compile_faults(
        [jfaults.GatewayFault(chiplet=1, slot=0, start=3, end=15),
         jfaults.LinkFlap(chiplet=2, p_down=0.3, p_up=0.4),
         jfaults.PcmStuckCell(chiplet=3, slot=3, mode="on", start=5),
         jfaults.LossDrift(db_per_interval=0.05, start=4)],
        jcfg.cfg, 24, seed=2)
    ref = _np(jfaults.attach_faults(ref, frame))
    ref["t_mask"] = np.ones(24, np.float32)
    ref["t_mask"][9:13] = 0.0
    one = tsim.simulate(_port(ref), tcfg, device="cpu")
    want_one = jsim.simulate(ref, jcfg)
    _match(one["records"], want_one["records"], "one-shot")
    sess = tsim.SimSession.init(tcfg, device="cpu")
    recs = []
    for chunk in jtr.chunk_trace(ref, 6):
        recs.append(sess.step_chunk(_port(_np(chunk)))["records"])
    for k, v in one["records"].items():
        assert torch.equal(torch.cat([r[k] for r in recs]), v), k
    before = sess._state
    parked = dict(_port(_np(next(iter(jtr.chunk_trace(ref, 6))))),
                  t_mask=torch.zeros(6))
    sess.step_chunk(parked)
    after = sess._state
    for a, b in ((before.ctl.g, after.ctl.g),
                 (before.ctl.epoch, after.ctl.epoch),
                 (before.prev_active, after.prev_active)):
        assert torch.equal(a, b)


def _tick_inputs(t=8, lanes=3, ticks=3, seed=0):
    """Per-lane chunk streams (lane 2 parks on tick 1) and their
    destination matrices."""
    streams = [list(jtr.chunk_trace(
        _trace(APPS[i % 4], t * ticks, seed + i, dest=True), t))
        for i in range(lanes)]
    streams = [[_np(c) for c in s] for s in streams]
    for c in streams[2 % lanes][1:2]:
        c["t_mask"] = np.zeros(t, np.float32)
    return streams


def _batch(streams, tick):
    keys = ("ext_load", "mem_load", "int_load", "ext_frac", "dest")
    out = {k: np.stack([s[tick][k] for s in streams]) for k in keys}
    out["t_mask"] = np.stack([s[tick].get("t_mask", np.ones(
        s[tick]["mem_load"].shape, np.float32)) for s in streams])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tick_lane_equals_standalone_session_and_the_reference(arch):
    """Three lanes over three ticks with per-lane destination matrices, a
    shared fault frame (a gateway fault and a link flap) and a parked lane:
    lane k's records and sums are a standalone session's bit for bit; the
    reference's `session_tick` at 1e-6; the carry passed in is unchanged."""
    jcfg, tcfg = _cfgs(arch)
    t, lanes = 8, 3
    streams = _tick_inputs(t, lanes)
    frame = jfaults.compile_faults(
        [jfaults.GatewayFault(chiplet=0, slot=1, start=1, end=6),
         jfaults.LinkFlap(chiplet=3, p_down=0.4)], jcfg.cfg, t, seed=7)
    jstates = jsim.init_session_states(jcfg, lanes)
    states = tsim.init_session_states(tcfg, lanes, device="cpu")
    _match(interop.records_to_numpy(states), {
        "g": jstates.ctl.g, "packets_seen": jstates.ctl.packets_seen,
        "epoch": jstates.ctl.epoch, "wavelengths": jstates.wavelengths,
        "prev_active": jstates.prev_active}, "init")
    jtables = selection_tables_jax(jcfg.cfg)
    tables = tsim.selection_tables_torch(tcfg.cfg, "cpu")
    solo = [tsim.SimSession.init(tcfg, device="cpu") for _ in range(lanes)]
    tframe = interop.fault_frame_from_numpy(frame, "cpu")
    for tick in range(len(streams[0])):
        batch = _batch(streams, tick)
        kept = interop.records_to_numpy(states)
        new, recs, sums = tsim.session_tick(
            states, interop.trace_from_numpy(batch, "cpu"), tables, tcfg,
            frame=tframe)
        _match(interop.records_to_numpy(states), kept, "old carry")
        jstates, jrecs, jsums = jsim.session_tick(jstates, batch, jtables,
                                                  jcfg, frame=frame)
        _match(recs, jrecs, f"tick {tick} records")
        _match(sums, jsums, f"tick {tick} sums")
        _match(interop.records_to_numpy(new), {
            "g": jstates.ctl.g, "packets_seen": jstates.ctl.packets_seen,
            "epoch": jstates.ctl.epoch, "wavelengths": jstates.wavelengths,
            "prev_active": jstates.prev_active}, f"tick {tick} carry")
        states = new
        for k in range(lanes):
            chunk = tfaults.attach_faults(_port(streams[k][tick]), frame)
            out = solo[k].step_chunk(chunk)
            _equal({n: v[k] for n, v in recs.items()}, out["records"],
                   f"lane {k} tick {tick}")
            _equal(tsim.summary_from_sums({n: v[k] for n, v in sums.items()},
                                          tcfg.cfg.n_chiplets),
                   out["summary"], f"lane {k} tick {tick} sums")


def test_tick_from_reference_states():
    """A carry the reference built mid-stream crosses over with
    `interop.session_states_from_numpy` and steps like the reference's."""
    jcfg, tcfg = _cfgs("resipi")
    streams = _tick_inputs(8, 2)
    jstates = jsim.init_session_states(jcfg, 2)
    jtables = selection_tables_jax(jcfg.cfg)
    jstates, _, _ = jsim.session_tick(jstates, _batch(streams, 0), jtables,
                                      jcfg)
    states = interop.session_states_from_numpy(
        jax.tree.map(np.asarray, jstates), "cpu")
    _, recs, sums = tsim.session_tick(
        states, interop.trace_from_numpy(_batch(streams, 1), "cpu"),
        tsim.selection_tables_torch(tcfg.cfg, "cpu"), tcfg)
    _, jrecs, jsums = jsim.session_tick(jstates, _batch(streams, 1), jtables,
                                        jcfg)
    _match(recs, jrecs, "records")
    _match(sums, jsums, "sums")


def test_swap_placement_matches_the_reference():
    """A live re-placement between chunks: the next chunk runs on the new
    placement's tables, with the carry streaming on, as the reference's."""
    jcfg, tcfg = _cfgs("resipi")
    ref = _trace(t=16, seed=9)
    chunks = [_np(c) for c in jtr.chunk_trace(ref, 8)]
    sess = tsim.SimSession.init(tcfg, device="cpu")
    jsess = jsim.SimSession.init(jcfg)
    assert sess.placement == jsess.placement
    sess.step_chunk(_port(chunks[0]))
    jsess.step_chunk(chunks[0])
    moved = [(0, 1), (3, 2), (1, 3), (2, 0)]
    sess.swap_placement(moved)
    jsess.swap_placement(moved)
    assert sess.placement == jsess.placement == tuple(moved)
    _match(sess.step_chunk(_port(chunks[1]))["records"],
           jsess.step_chunk(chunks[1])["records"], "after swap")
    _match(sess.summary(), jsess.summary(), "summary")


def test_normalize_placement_both_orders():
    from repro.core import selection as jsel
    from repro_torch.core import selection as tsel
    for pos in ([(1, 0), (2, 3), (0, 2), (3, 1)],
                [(0, 0), (3, 3), (0, 3), (3, 0)], None):
        for order in ("given", "spread"):
            assert tsel.normalize_placement(pos, order=order) == \
                jsel.normalize_placement(pos, order=order)
    with pytest.raises(ValueError, match="order"):
        tsel.normalize_placement([(0, 0)], order="nope")


def test_stream_errors_and_sums_surface():
    tcfg = tsim.SimConfig()
    with pytest.raises(ValueError, match="empty"):
        tsim.simulate_stream([], tcfg, device="cpu")
    sess = tsim.SimSession.init(tcfg, device="cpu")
    with pytest.raises(ValueError, match="summary"):
        sess.summary()
    assert sess.intervals_seen == 0
    two = tsim.stack_traces([_port(_trace(t=4)), _port(_trace(t=4))])
    with pytest.raises(ValueError, match="unbatched"):
        sess.step_chunk(two)
    with pytest.raises(ValueError, match="lanes"):
        tsim.init_session_states(tcfg, 0, device="cpu")
    states = tsim.init_session_states(tcfg, 2, device="cpu")
    tables = tsim.selection_tables_torch(tcfg.cfg, "cpu")
    flat = {"ext_load": torch.zeros(4, 4), "mem_load": torch.zeros(4),
            "int_load": torch.zeros(4, 4), "ext_frac": torch.ones(2),
            "t_mask": torch.ones(4)}
    with pytest.raises(ValueError, match="lane-stacked"):
        tsim.session_tick(states, flat, tables, tcfg)
    good = {k: torch.stack([v, v]) for k, v in flat.items()
            if k != "ext_frac"}
    good["ext_frac"] = torch.ones(2)
    with pytest.raises(ValueError, match="intervals"):
        tsim.session_tick(states, good, tables, tcfg, frame={
            k: torch.as_tensor(v) for k, v in
            tfaults.no_faults(tcfg.cfg, 5).items()})
    with pytest.raises(ValueError, match="missing"):
        tsim.session_tick(states, good, tables, tcfg,
                          frame={"gw_ok": torch.ones(4, 4, 4)})
    out = tsim.simulate_stream(
        [_port(_np(c)) for c in jtr.chunk_trace(_trace(t=12), 4)], tcfg,
        device="cpu")
    assert out["chunks"] == 3 and out["session"].intervals_seen == 12
    zero = tsim.session_sums_zero(device="cpu")
    jzero = jsim.session_sums_zero()
    assert set(zero) == set(jzero)
    _match(tsim.summary_from_sums(zero, 4),
           jsim.summary_from_sums(jzero, 4), "zero summary")
    _match(tsim.summary_from_sums(out["session"]._sums, 4),
           out["summary"], "summary_from_sums")
