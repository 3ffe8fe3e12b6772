"""The port's threefry twin (`repro_torch.random`) against `jax.random`.

Keys, splits, 32-bit bits and float32 uniforms must equal jax's bit for bit
under its default configuration (64-bit types off, partitionable threefry).
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch import random as trandom

SEEDS = [0, 5, 13, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (3, 5), (8192, 16), (2, 3, 4)]


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_bitwise(seed):
    key = trandom.prng_key(seed, device="cpu")
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), _np(jkey))
    for num in (1, 2, 3, 512):
        np.testing.assert_array_equal(trandom.split(key, num).numpy(),
                                      _np(jax.random.split(jkey, num)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_bitwise(seed, shape):
    got = trandom.random_bits(trandom.prng_key(seed, device="cpu"), shape)
    want = jax.random.bits(jax.random.PRNGKey(seed), shape)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bitwise(seed, shape):
    got = trandom.uniform(trandom.prng_key(seed, device="cpu"), shape)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


def test_batched_keys_equal_vmap_over_keys():
    """A leading key axis draws as `jax.vmap` over the keys does."""
    keys = trandom.split(trandom.prng_key(13, device="cpu"), 6)
    jkeys = jax.random.split(jax.random.PRNGKey(13), 6)
    got = trandom.uniform(keys, (4, 9))
    want = jax.vmap(lambda k: jax.random.uniform(k, (4, 9)))(jkeys)
    assert tuple(got.shape) == (6, 4, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = trandom.split(keys, 3)
    want = jax.vmap(lambda k: jax.random.split(k, 3))(jkeys)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_seed_keeps_its_low_32_bits_as_jax_does():
    for seed in (-1, 2 ** 32 + 5, -2 ** 31):
        np.testing.assert_array_equal(
            trandom.prng_key(seed, device="cpu").numpy(),
            _np(jax.random.PRNGKey(seed)))
