"""A bit-exact twin of jax's default PRNG (threefry2x32) in plain torch.

`prng_key`, `split`, `random_bits` and `uniform` return the same bits as
`jax.random.PRNGKey`, `split`, `bits` and `uniform` (float32) under jax's
default configuration: 64-bit types off (a seed keeps its low 32 bits) and
`jax_threefry_partitionable=True` (each output element hashes its own flat
index, split into hi/lo 32-bit counters). A key is an int64 tensor [..., 2]
holding two uint32 words; leading key axes batch, as `jax.vmap` over keys
would, and the output gains them in front of `shape`.

The uint32 arithmetic runs in int64 tensors masked to 32 bits, because
torch's uint32 support is thin. Everything is vectorised over the whole
output on the key's device; a draw of N values holds a few int64 [N]
temporaries, so callers that draw billions split the work into groups.

Normal, lognormal and gamma draws (which go through XLA's own `erf_inv`
polynomial) are not here.
"""
from __future__ import annotations

import math

import torch

from repro_torch.backend import resolve_device

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                    # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000              # the bits of 1.0f
_F32_MANTISSA = 23


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple:
    """The threefry2x32 hash (20 rounds) of counter pairs (x1, x2) under the
    key (k1, k2); all int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, *, device=None) -> torch.Tensor:
    """The key `jax.random.PRNGKey(seed)` makes: [0, seed mod 2**32]."""
    dev = resolve_device(device)
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=dev)


def _hash_iota(key: torch.Tensor, shape: tuple) -> tuple:
    """threefry2x32 of the flat index of every element of `shape` (hi/lo
    counters) under each key of `key` [..., 2]; outputs [..., *shape]."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device)
    hi = idx >> 32
    lo = idx & _MASK
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, *(1,) * len(shape))
    k2 = key[..., 1].reshape(*lead, *(1,) * len(shape))
    return _threefry2x32(k1, k2, hi.reshape(shape), lo.reshape(shape))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: [..., num, 2] new keys."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (32-bit): int64 [..., *shape] holding
    uint32 values."""
    b1, b2 = _hash_iota(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` (float32 in [0, 1)): the top 23 bits
    as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    f = ((bits >> (32 - _F32_MANTISSA)) | _ONE_F32_BITS).to(torch.int32)
    return f.view(torch.float32) - 1.0
