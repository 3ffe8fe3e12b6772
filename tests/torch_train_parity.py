"""Shared harness of the training parity tests (`test_torch_train_*.py`):
one family's `train_loss` and gradients through `jax.value_and_grad` and
through the port's `train_step.value_and_grad`, on the reference's smoke
config with the reference's weights and one numpy-made batch, and the two
checks on them (`check_f32`, `check_bf16`; bounds in
`test_torch_train_models.py`'s docstring).

`flash_block_q` / `flash_block_kv` are cut to 16 in both packages, so the
40-token batches take the flash path (the port's flash kernel op, under
autograd) where the family has attention. Results are memoized per (arch,
compute dtype): a file's bf16 test reuses its float32 reference run.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.models.params import init_params as jinit
from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.train.train_step import value_and_grad

B, S = 2, 40
FLASH = {"flash_block_q": 16, "flash_block_kv": 16}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# A leaf whose reference gradient is below this share of the whole
# gradient's norm (mathematically zero, as the cross-attention key bias's:
# softmax ignores a bias common to every key) is held absolutely, to the
# tolerance times this share of the whole norm.
LEAF_FLOOR = 1e-4


def configs(arch: str):
    return (dataclasses.replace(get_smoke_config(arch), **FLASH),
            dataclasses.replace(jget_smoke(arch), **FLASH))


def make_batch(cfg, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.real_vocab, (B, S)).astype(
                 np.int32),
             "labels": rng.randint(0, cfg.real_vocab, (B, S)).astype(
                 np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = (rng.randn(B, cfg.frontend_embeds,
                                           cfg.d_model) * 0.02
                                 ).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = (rng.randn(B, S, cfg.d_model) * 0.02).astype(
            np.float32)
    return batch


def keyed(jtree) -> dict:
    """{keystr: float64 array} of a jax tree."""
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def keyed_torch(tree, path: str = "") -> dict:
    """{keystr: float64 array or None} of a tree of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(keyed_torch(tree[k], f"{path}[{k!r}]"))
        return out
    return {path: None if tree is None
            else tree.detach().double().cpu().numpy()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port while a module that imports this
    runs: the suite runs several pytest workers side by side, each beside
    the reference's own thread pool, and the smoke shapes gain nothing
    from more."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


@functools.lru_cache(maxsize=None)
def reference_params(arch: str):
    """The reference's smoke weights from `PRNGKey(1)`, drawn once."""
    return jinit(jget_model(configs(arch)[1]).spec(), jax.random.PRNGKey(1))


@functools.lru_cache(maxsize=None)
def reference_run(arch: str, dtype: str):
    """(loss, stats, grads) of the reference, keyed grads."""
    _, jcfg = configs(arch)
    jm = jget_model(jcfg)
    jp = reference_params(arch)
    batch = {k: jnp.asarray(v) for k, v in make_batch(jcfg).items()}
    kept = JL.COMPUTE_DTYPE
    JL.COMPUTE_DTYPE = DTYPES[dtype][0]
    try:
        (loss, stats), grads = jax.jit(jax.value_and_grad(
            jm.train_loss, has_aux=True))(jp, batch)
    finally:
        JL.COMPUTE_DTYPE = kept
    stats = {k: np.asarray(v, np.float64) for k, v in stats.items()}
    return float(loss), stats, keyed(grads)


@functools.lru_cache(maxsize=None)
def port_run(arch: str, dtype: str):
    """(loss, stats, grads) of the port, from the reference's weights."""
    cfg, jcfg = configs(arch)
    model = get_model(cfg)
    params = interop.params_from_numpy(
        jax.tree.map(np.asarray, reference_params(arch)), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in make_batch(cfg).items()}
    kept = TL.COMPUTE_DTYPE
    TL.COMPUTE_DTYPE = DTYPES[dtype][1]
    try:
        loss, stats, grads = value_and_grad(model, params, batch)
    finally:
        TL.COMPUTE_DTYPE = kept
    stats = {k: v.double().numpy() for k, v in stats.items()}
    return float(loss), stats, keyed_torch(grads)


def leaf_distances(got: dict, want: dict) -> dict:
    """{leaf: ||got - want|| / max(||want||, LEAF_FLOOR ||want_all||)}."""
    total = np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    return {k: float(np.linalg.norm(got[k] - w)
                     / max(np.linalg.norm(w), LEAF_FLOOR * total))
            for k, w in want.items()}


def check_f32(arch: str) -> None:
    jl, js, jg = reference_run(arch, "f32")
    tl, ts, tg = port_run(arch, "f32")
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    missing = [k for k, g in tg.items() if g is None]
    assert not missing, f"leaves without a gradient: {missing}"
    dist = leaf_distances(tg, jg)
    assert max(dist.values()) <= 1e-4, sorted(dist.items(),
                                              key=lambda kv: -kv[1])[:3]
    assert set(ts) == set(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def check_bf16(arch: str) -> None:
    jl, _, jg = reference_run(arch, "bf16")
    tl, _, tg = port_run(arch, "bf16")
    _, _, truth = reference_run(arch, "f32")
    assert abs(tl - jl) <= 1e-2 * abs(jl), (tl, jl)
    assert all(g is not None for g in tg.values())
    port, ref = leaf_distances(tg, truth), leaf_distances(jg, truth)
    over = {k: (port[k], ref[k]) for k in truth
            if port[k] > max(5e-2, ref[k])}
    assert not over, over
