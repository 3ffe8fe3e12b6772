"""The port's optimizers and train step against the JAX reference, on the
CPU: one AdamW and one Adafactor update from the same gradients (factored
and unfactored leaves, three steps so the bias corrections and the
schedule's warmup and cosine branches all run) within 1e-6; the train
state from the twin key (the reference's parameters bit for bit), its
`meta` shapes and partition specs; `make_train_step` in float32 compute
against the reference's jitted step, `accum=2` against `accum=1`, and the
non-finite guard skipping with the state unchanged bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.train import optim as joptim
from repro.train import train_step as jts
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.random import prng_key
from repro_torch.sharding.rules import Rules
from repro_torch.train import optim as toptim
from repro_torch.train import train_step as tts
from torch_train_parity import (  # noqa: F401
    keyed, keyed_torch, one_torch_thread)

SHAPES = {"a": (6, 5), "b": (7,), "c": (2, 3, 4), "d": (5, 1),
          "e": {"f": (4, 2)}}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.randn(*shapes) * scale).astype(np.float32)


def _close(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_the_reference(name):
    rng = np.random.RandomState(1)
    params = _tree(rng, SHAPES)
    kw = {"warmup": 2, "total_steps": 6}
    jinit_, jupd, _ = joptim.make_optimizer(name, **kw)
    tinit_, tupd, _ = toptim.make_optimizer(name, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = interop.params_from_numpy(params, "cpu")
    js, ts = jinit_(jp), tinit_(tp)
    _close(keyed_torch(ts), keyed(js), 0)
    for step in range(3):
        grads = _tree(rng, SHAPES, scale=0.5 + step)
        jp, js, jst = jupd(jax.tree.map(jnp.asarray, grads), js, jp)
        tp, ts, tst = tupd(interop.params_from_numpy(grads, "cpu"), ts, tp)
        _close(keyed_torch(tp), keyed(jp), 1e-6)
        _close(keyed_torch(ts), keyed(js), 1e-6)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tst[k]), float(jst[k]),
                                       rtol=1e-6)
    if name == "adafactor":
        assert set(ts["stats"]["a"]) == {"row", "col"}
        assert set(ts["stats"]["b"]) == set(ts["stats"]["d"]) == {"v"}


def test_clip_and_schedule_match_the_reference():
    rng = np.random.RandomState(2)
    tree = _tree(rng, SHAPES, scale=3.0)
    jc, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    tc, tn = toptim.clip_by_global_norm(interop.params_from_numpy(tree,
                                                                  "cpu"), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close(keyed_torch(tc), keyed(jc), 1e-6)
    jlr, tlr = joptim.cosine_schedule(1e-3, 10, 50), \
        toptim.cosine_schedule(1e-3, 10, 50)
    for s in (0, 3, 10, 11, 30, 50, 70):
        np.testing.assert_allclose(
            float(tlr(torch.tensor(s, dtype=torch.int32))),
            float(jlr(jnp.int32(s))), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("arch", ["stablelm-3b", "grok-1-314b"])
def test_train_state_from_the_twin_key_is_the_references(arch):
    """Parameters bit for bit, the optimizer state's leaves and dtypes the
    reference's; the abstract state's `meta` shapes and the partition
    specs on the production meshes the reference's specs."""
    jm, tm = jget_model(jget_smoke(arch)), get_model(get_smoke_config(arch))
    js = jts.init_train_state(jm, jax.random.PRNGKey(0))
    ts = tts.init_train_state(tm, prng_key(0, device="cpu"))
    _close(keyed_torch(ts), keyed(js), 0)
    ab = tts.abstract_train_state(tm)
    want = jax.tree_util.tree_flatten_with_path(
        jts.abstract_train_state(jm))[0]
    got = dict(_flat(ab))
    assert set(got) == {jax.tree_util.keystr(p) for p, _ in want}
    for p, sds in want:
        leaf = got[jax.tree_util.keystr(p)]
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(sds.shape)
        assert str(leaf.dtype).split(".")[1] == str(sds.dtype)
    for multi_pod, sizes in ((False, {"data": 16, "model": 16}),
                             (True, {"pod": 2, "data": 16, "model": 16})):
        from repro.sharding.rules import Rules as JRules

        trules = Rules(make_production_mesh(multi_pod=multi_pod))
        jrules = JRules(_FakeMesh(sizes))
        want = {jax.tree_util.keystr(p): tuple(v) for p, v in
                jax.tree_util.tree_flatten_with_path(
                    jts.state_pspecs(jm, jrules),
                    is_leaf=lambda x: isinstance(x, jax.sharding.
                                                 PartitionSpec))[0]}
        got = dict(_flat(tts.state_pspecs(tm, trules)))
        assert got == want
        for kind in ("train", "prefill"):
            assert tts.batch_pspecs(tm.cfg, trules, kind) == {
                k: tuple(v) for k, v in
                jts.batch_pspecs(jm.cfg, jrules, kind).items()}


class _FakeMesh:
    """The reference's production mesh without its 256 / 512 devices (as
    `tests/test_specs.py` builds it)."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))
        self.size = int(self.devices.size)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


STEP_KW = {"lr": 1e-2, "warmup": 1, "total_steps": 10}


@functools.lru_cache(maxsize=None)
def _reference_step(arch, accum):
    """The reference's jitted train step, compiled once per (arch, accum)
    for the tests that run it (all in float32 compute)."""
    return jax.jit(jts.make_train_step(jget_model(jget_smoke(arch)),
                                       accum=accum, opt_overrides=STEP_KW))


def _f32_step(arch, accum, nan=False, reference=True):
    """One train step of both packages (the port's alone without
    `reference`) in float32 compute from the twin key's state; -> (port
    state, port metrics, reference state, reference metrics, reference
    state before the step)."""
    from repro.data.pipeline import DataConfig, SyntheticLM

    jm, tm = jget_model(jget_smoke(arch)), get_model(get_smoke_config(arch))
    batch = SyntheticLM(jm.cfg, DataConfig(global_batch=4, seq_len=32)) \
        .host_slice(0)
    js = jts.init_train_state(jm, jax.random.PRNGKey(0))
    ts = tts.init_train_state(tm, prng_key(0, device="cpu"))
    if nan:
        js["params"]["ln_f"]["scale"] = js["params"]["ln_f"]["scale"] \
            .at[0].set(jnp.nan)
        ts["params"]["ln_f"]["scale"][0] = float("nan")
    tfn = tts.make_train_step(tm, accum=accum, opt_overrides=STEP_KW)
    kept = JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE
    JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE = jnp.float32, torch.float32
    jnew = jm_ = None
    try:
        if reference:
            jnew, jm_ = _reference_step(arch, accum)(
                js, {k: jnp.asarray(v) for k, v in batch.items()})
        tnew, tm_ = tfn(ts, {k: torch.as_tensor(v) for k, v in
                             batch.items()})
    finally:
        JL.COMPUTE_DTYPE, TL.COMPUTE_DTYPE = kept
    return tnew, tm_, jnew, jm_, js


@pytest.mark.parametrize("arch", ["stablelm-3b", "grok-1-314b"])
def test_train_step_matches_the_reference(arch):
    """Float32 compute: loss, grad norm and lr at 1e-5; the updated
    parameters and optimizer state at 1e-5 (`_stepped_close`: a gradient
    element within rounding of zero may move its weight the other way)."""
    tnew, tmet, jnew, jmet, _ = _f32_step(arch, accum=1)
    for k in ("loss", "grad_norm", "lr", "collective_bytes"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5)
    assert int(tmet["skipped"]) == int(jmet["skipped"]) == 0
    assert set(tmet) == set(jmet)
    _stepped_close(keyed_torch(tnew), keyed(jnew), 1e-5)


def _stepped_close(got: dict, want: dict, tol: float, lr: float = 1e-2):
    """States after one step: elementwise at `tol`, but for at most 0.1%
    of a leaf's elements, which must stay within 2 lr (a first AdamW step
    moves a weight by lr x sign(g))."""
    assert set(got) == set(want)
    for k in want:
        bad = ~np.isclose(got[k], want[k], rtol=tol, atol=tol)
        assert bad.mean() <= 1e-3, (k, bad.sum())
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=2 * lr,
                                   err_msg=k)


def test_accumulated_step_matches_one_batch():
    """accum=2 (two microbatches, gradients averaged) against accum=1 on
    the same batch: loss and grad norm at 1e-6, the new state at 1e-6 (as
    `_stepped_close` holds it)."""
    a1, m1, *_ = _f32_step("stablelm-3b", accum=1, reference=False)
    a2, m2, *_ = _f32_step("stablelm-3b", accum=2, reference=False)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-6)
    _stepped_close(keyed_torch(a2), keyed_torch(a1), 1e-6)


@pytest.mark.parametrize("arch", ["stablelm-3b", "grok-1-314b"])
def test_guard_skips_a_non_finite_step_and_keeps_the_state(arch):
    """A NaN weight makes the loss NaN: the step reports skipped = 1, as
    the reference's does, and leaves the parameters and the optimizer
    state (AdamW m / v, Adafactor row / col / v, the optimizer's step) bit
    for bit as they were; the train state's step still counts."""
    tnew, tmet, jnew, jmet, jold = _f32_step(arch, accum=1, nan=True)
    assert int(tmet["skipped"]) == int(jmet["skipped"]) == 1
    before = keyed(jold)
    after = keyed_torch(tnew)
    for k, v in before.items():
        if k == "['step']":
            assert after[k] == v + 1
        else:
            np.testing.assert_array_equal(after[k], v, err_msg=k)
    assert int(jnew["step"]) == 1
