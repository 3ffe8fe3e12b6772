"""Fault parity: `repro_torch.core.faults` and `simulator.sweep_faults`
against the JAX reference on the CPU.

Every spec family compiles to the reference's frame exactly at the same
seed (the frames are numpy; stochastic specs draw from numpy's
`RandomState` as the reference does), for slot- and position-targeted
specs and mixed lists. `sweep_faults` runs K frames over one trace as K
lanes: lane k equals the port's own `simulate` of the trace with frame k
attached, bit for bit, and the reference's `sweep_faults` at
rtol = atol = 1e-6 (integer g and boolean saturation exact) per arch, with
and without zipped runtime grids. The injector's LRU frame cache, its
status register and `placement_reconfig_cost` match the reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import faults as jf
from repro.core import simulator as jsim
from repro.core import traffic as jtr
from repro.core.constants import NETWORK as JNET
from repro_torch import interop
from repro_torch.core import faults as tf
from repro_torch.core import simulator as tsim
from repro_torch.core.constants import NETWORK as TNET

ARCHS = [a.value for a in jsim.Arch]


def _pair(spec):
    """The same spec in both packages."""
    return spec, getattr(tf, type(spec).__name__)(**dataclasses.asdict(spec))


SPEC_CASES = {
    "gateway-slot": [jf.GatewayFault(chiplet=1, slot=2, start=3, end=9)],
    "gateway-position": [jf.GatewayFault(chiplet=0, position=(1, 0),
                                         start=2)],
    "gateway-unplaced-position": [jf.GatewayFault(chiplet=0,
                                                  position=(2, 2))],
    "link-flap": [jf.LinkFlap(chiplet=2, p_down=0.3, p_up=0.4, start=1,
                              end=40)],
    "pcm-off": [jf.PcmStuckCell(chiplet=3, slot=1, mode="off", start=5)],
    "pcm-on": [jf.PcmStuckCell(chiplet=0, slot=3, mode="on", start=0,
                               end=20)],
    "pcm-position": [jf.PcmStuckCell(chiplet=1, position=(3, 1),
                                     mode="on")],
    "loss-drift": [jf.LossDrift(db_per_interval=0.07, max_db=1.1, start=4)],
    "mixed": [jf.LinkFlap(chiplet=0, p_down=0.2), jf.LossDrift(start=10),
              jf.GatewayFault(chiplet=3, slot=0, end=30),
              jf.LinkFlap(chiplet=3, p_down=0.5, p_up=0.2),
              jf.PcmStuckCell(chiplet=2, slot=2, mode="on")],
}


@pytest.mark.parametrize("name", list(SPEC_CASES))
def test_every_spec_family_compiles_the_reference_frame(name):
    jspecs = SPEC_CASES[name]
    tspecs = [_pair(s)[1] for s in jspecs]
    for seed in (0, 1, 17):
        for cfg_j, cfg_t in ((JNET, TNET),
                             (JNET.with_topology(n_chiplets=6),
                              TNET.with_topology(n_chiplets=6))):
            want = jf.compile_faults(jspecs, cfg_j, 48, seed=seed)
            got = tf.compile_faults(tspecs, cfg_t, 48, seed=seed)
            for k in tf.FAULT_KEYS:
                assert got[k].dtype == want[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_spec_validation_and_compile_errors():
    for bad in (lambda m: m.GatewayFault(start=-1),
                lambda m: m.GatewayFault(start=5, end=2),
                lambda m: m.LinkFlap(p_down=1.5),
                lambda m: m.PcmStuckCell(mode="sideways"),
                lambda m: m.LossDrift(db_per_interval=-1.0)):
        for mod in (jf, tf):
            with pytest.raises(ValueError):
                bad(mod)
    for specs in ([tf.GatewayFault(chiplet=9)], [tf.GatewayFault(slot=7)]):
        with pytest.raises(ValueError):
            tf.compile_faults(specs, TNET, 8)
    with pytest.raises(TypeError, match="FaultSpec"):
        tf.compile_faults(["gateway"], TNET, 8)


def test_attach_strip_stack():
    tr = interop.trace_from_numpy({k: np.asarray(v) for k, v in
                                   jtr.generate(jtr.ParsecSpec("dedup", 12),
                                                jax.random.PRNGKey(0))
                                   .items() if k != "app"}, "cpu")
    frame = tf.compile_faults([tf.LossDrift()], TNET, 12)
    att = tf.attach_faults(tr, frame)
    for k in tf.FAULT_KEYS:
        assert att[k].dtype == torch.float32
        np.testing.assert_array_equal(att[k].numpy(), frame[k])
    assert set(tf.strip_faults(att)) == set(tr)
    with pytest.raises(ValueError, match="intervals"):
        tf.attach_faults(tr, tf.no_faults(TNET, 5))
    with pytest.raises(ValueError, match="missing"):
        tf.attach_faults(tr, {"gw_ok": frame["gw_ok"]})
    st = tf.stack_fault_frames([frame, tf.no_faults(TNET, 12)])
    want = jf.stack_fault_frames([frame, jf.no_faults(JNET, 12)])
    for k in tf.FAULT_KEYS:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        tf.stack_fault_frames([])


def _frames(cfg_j, t, k):
    """K reference frames: one of each family, then mixed draws."""
    specs = [[], [jf.GatewayFault(chiplet=1, slot=0, start=2, end=14)],
             [jf.LinkFlap(chiplet=2, p_down=0.35, p_up=0.3)],
             [jf.PcmStuckCell(chiplet=0, slot=3, mode="on")],
             [jf.PcmStuckCell(chiplet=3, slot=1, mode="off", start=6)],
             [jf.LossDrift(db_per_interval=0.08, start=3)]]
    while len(specs) < k:
        i = len(specs)
        specs.append([jf.LinkFlap(chiplet=i % 4, p_down=0.25),
                      jf.GatewayFault(chiplet=(i + 1) % 4, slot=i % 4,
                                      start=i % 7)])
    return [jf.compile_faults(s, cfg_j, t, seed=i)
            for i, s in enumerate(specs[:k])]


@pytest.mark.parametrize("grid", [False, True], ids=["frames", "zip-l_m"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sweep_faults_matches_simulate_and_the_reference(arch, grid):
    """Eight frames over one 24-interval trace with destination matrices
    (and, zipped lane for lane, eight L_m values): each lane is the port's
    `simulate` of the attached trace bit for bit; the whole sweep is the
    reference's at 1e-6."""
    jcfg = jsim.SimConfig().with_arch(jsim.Arch(arch))
    tcfg = tsim.SimConfig().with_arch(tsim.Arch(arch))
    ref = {k: (v if k == "app" else np.asarray(v)) for k, v in
           jtr.generate(jtr.ParsecSpec("canneal", 24), jax.random.PRNGKey(4),
                        dest=True).items()}
    frames = _frames(jcfg.cfg, 24, 8)
    fields = {"l_m": np.linspace(0.004, 0.03, 8).astype(np.float32)} \
        if grid else {}
    tr = interop.trace_from_numpy(ref, "cpu")
    got = tsim.sweep_faults(tr, tcfg, frames, device="cpu", **fields)
    want = jsim.sweep_faults(ref, jcfg, frames, **fields)
    for part in ("records", "summary"):
        assert set(got[part]) == set(want[part])
        for k in want[part]:
            w, g = np.asarray(want[part][k]), got[part][k].numpy()
            if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                           err_msg=k)
    stacked = tf.stack_fault_frames(frames)
    again = tsim.sweep_faults(tr, tcfg, stacked, device="cpu", **fields)
    for k in got["records"]:
        assert torch.equal(again["records"][k], got["records"][k])
    for lane in (0, 3, 7):
        sim = tcfg
        if grid:
            sim = dataclasses.replace(tcfg, ctl=dataclasses.replace(
                tcfg.ctl, l_m=float(fields["l_m"][lane])))
        one = tsim.simulate(tf.attach_faults(tr, frames[lane]), sim,
                            device="cpu")
        for k, v in one["records"].items():
            assert torch.equal(got["records"][k][lane], v), (lane, k)


def test_sweep_faults_errors():
    tcfg = tsim.SimConfig()
    tr = interop.trace_from_numpy(
        {k: np.asarray(v) for k, v in jtr.generate(
            jtr.ParsecSpec("dedup", 10), jax.random.PRNGKey(1)).items()
         if k != "app"}, "cpu")
    frames = [tf.no_faults(TNET, 10)] * 3
    with pytest.raises(ValueError, match="clean trace"):
        tsim.sweep_faults(tf.attach_faults(tr, frames[0]), tcfg, frames,
                          device="cpu")
    with pytest.raises(ValueError, match="intervals"):
        tsim.sweep_faults(tr, tcfg, [tf.no_faults(TNET, 9)], device="cpu")
    with pytest.raises(ValueError, match="zip"):
        tsim.sweep_faults(tr, tcfg, frames, device="cpu",
                          l_m=np.float32([0.01, 0.02]))
    with pytest.raises(ValueError, match="missing"):
        tsim.sweep_faults(tr, tcfg, {"gw_ok": torch.ones(2, 10, 4, 4)},
                          device="cpu")


def test_injector_cache_status_register_and_cost():
    """Frames per placement (LRU of `cache_size`, the least recently used
    evicted first, a re-compiled frame bitwise the first), chunk-aligned
    injection, `failed_positions` and the re-placement bill, as the
    reference's."""
    jspecs = [jf.GatewayFault(chiplet=1, position=(1, 0), start=2, end=9),
              jf.PcmStuckCell(chiplet=0, position=(3, 1), mode="off",
                              start=5),
              jf.PcmStuckCell(chiplet=2, position=(0, 2), mode="on"),
              jf.LinkFlap(chiplet=3, p_down=0.4)]
    tspecs = [_pair(s)[1] for s in jspecs]
    jinj = jf.FaultInjector(jspecs, 24, seed=3, cache_size=2)
    tinj = tf.FaultInjector(tspecs, 24, seed=3, cache_size=2)
    placements = [None, ((1, 0), (2, 3), (0, 2), (3, 1)),
                  ((0, 1), (3, 2), (1, 3), (2, 0))]
    first = tinj.frame_for(TNET, 0, 24)
    for p in placements + [placements[1], placements[0]]:
        jc, tc = JNET.with_placement(p), TNET.with_placement(p)
        for t0, t1 in ((0, 8), (8, 24), (5, 6)):
            want, got = jinj.frame_for(jc, t0, t1), tinj.frame_for(tc, t0,
                                                                    t1)
            for k in tf.FAULT_KEYS:
                np.testing.assert_array_equal(got[k], want[k])
        assert list(tinj._frames) == list(jinj._frames)
        assert len(tinj._frames) <= 2
    again = tinj.frame_for(TNET, 0, 24)
    for k in tf.FAULT_KEYS:
        np.testing.assert_array_equal(again[k], first[k])
    for t in range(24):
        assert tinj.failed_positions(t) == jinj.failed_positions(t)
    chunk = interop.trace_from_numpy(
        {k: np.asarray(v) for k, v in jtr.generate(
            jtr.ParsecSpec("dedup", 8), jax.random.PRNGKey(2)).items()
         if k != "app"}, "cpu")
    injected = tinj.inject(chunk, TNET, 8)
    np.testing.assert_array_equal(injected["gw_ok"].numpy(),
                                  jinj.frame_for(JNET, 8, 16)["gw_ok"])
    for bad in ((-1, 4), (3, 3), (20, 25)):
        with pytest.raises(ValueError, match="horizon"):
            tinj.frame_for(TNET, *bad)
    with pytest.raises(ValueError):
        tf.FaultInjector(tspecs, 0)
    with pytest.raises(ValueError):
        tf.FaultInjector(tspecs, 8, cache_size=0)
    for old, new in ((None, placements[1]), (placements[1], placements[2]),
                     (placements[2], placements[2]),
                     (placements[1][:2], placements[2][1:])):
        assert tf.placement_reconfig_cost(old, new) == \
            jf.placement_reconfig_cost(old, new)
