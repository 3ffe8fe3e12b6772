"""The port's threefry twin (`repro_torch.random`) against `jax.random`.

Keys, splits, 32-bit bits, float32 uniforms, normals and permutations must
equal jax's bit for bit under its default configuration (64-bit types off,
partitionable threefry). The XLA float32 elementary functions the normal
and the trace generators go through (`xla_log`, `xla_log1p`, `xla_exp`,
`erf_inv`) equal XLA's CPU results bit for bit; `sin` is float64 sin
rounded, which parts from XLA's (libm's `sinf`) by one ulp in a small
share of arguments, stated below.
"""
import jax
import jax.numpy as jnp
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



def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


NORMAL_CASES = [(0, (7,)), (3, (200_000,)), (11, (50, 40)),
                (2 ** 31 - 1, (3, 5, 7)), (123, (1,))]


@pytest.mark.parametrize("seed,shape", NORMAL_CASES, ids=str)
def test_normal_bitwise(seed, shape):
    """More than 10^5 normals in one case: the uniform on
    [nextafter(-1, 0), 1), XLA's erf_inv (its log1p and log among it) and
    the sqrt(2) factor, every element's bits."""
    got = trandom.normal(trandom.prng_key(seed, device="cpu"), shape)
    want = jax.random.normal(jax.random.PRNGKey(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.int32), _bits(want))


def test_normal_batched_keys_equal_vmap_over_keys():
    keys = trandom.split(trandom.prng_key(4, device="cpu"), 5)
    want = jax.vmap(lambda k: jax.random.normal(k, (6, 3)))(
        jax.random.split(jax.random.PRNGKey(4), 5))
    np.testing.assert_array_equal(
        trandom.normal(keys, (6, 3)).numpy().view(np.int32), _bits(want))


@pytest.mark.parametrize("n", [1, 2, 4, 16, 257, 1000, 5000, 100_000])
@pytest.mark.parametrize("seed", [0, 7, 99])
def test_permutation_bitwise(seed, n):
    """The sort-based shuffle, its round count (two rounds from n = 1 626
    on) and key splits, stable on equal 32-bit keys."""
    got = trandom.permutation(trandom.prng_key(seed, device="cpu"), n)
    want = jax.random.permutation(jax.random.PRNGKey(seed), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _args():
    rng = np.random.RandomState(0)
    return {
        "log": np.concatenate([rng.uniform(0, 50, 100_000),
                               rng.uniform(1e-6, 1, 100_000),
                               [0.0, 1e-40, 1.0, 2.0, np.inf]]),
        "log1p": np.concatenate([rng.uniform(-1, 0, 100_000),
                                 rng.uniform(-0.5, 0.5, 100_000),
                                 rng.uniform(0, 5, 1000), [0.0, -1.0]]),
        "exp": np.concatenate([rng.uniform(-3, 3, 100_000),
                               rng.uniform(-100, 100, 10_000)]),
        "erf_inv": np.concatenate([rng.uniform(-1, 1, 100_000),
                                   rng.uniform(0.99, 1, 10_000),
                                   [0.0, 1.0, -1.0]]),
    }


@pytest.mark.parametrize("name", ["log", "log1p", "exp", "erf_inv"])
def test_xla_elementary_functions_bitwise(name):
    x = _args()[name].astype(np.float32)
    fn = {"log": trandom.xla_log, "log1p": trandom.xla_log1p,
          "exp": trandom.xla_exp, "erf_inv": trandom.erf_inv}[name]
    jfn = {"log": jnp.log, "log1p": jnp.log1p, "exp": jnp.exp,
           "erf_inv": jax.lax.erf_inv}[name]
    got = fn(torch.tensor(x)).numpy()
    want = np.asarray(jax.jit(jfn)(x))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_sin_is_within_one_ulp_of_xla():
    """float64 sin rounded against XLA's float32 sin (libm's sinf) on the
    PARSEC phase's range: they differ by one ulp in about 2% of the
    arguments (measured 1.7%), never more; the trace generators' note."""
    x = np.random.RandomState(1).uniform(0, 120, 200_000).astype(np.float32)
    got = trandom.sin(torch.tensor(x)).numpy().view(np.int32)
    want = _bits(jax.jit(jnp.sin)(x))
    ulps = np.abs(got.astype(np.int64) - want)
    assert ulps.max() <= 1
    assert (ulps > 0).mean() < 0.03


def test_fma_rounds_once():
    a = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    c = torch.tensor([-(1.0 + 2.0 ** -11)], dtype=torch.float32)
    # a * a + c = 2^-24 exactly; a separate product would round it to 0.
    assert float(trandom.fma(a, a, c)[0]) == 2.0 ** -24
    assert float((a * a + c)[0]) == 0.0
