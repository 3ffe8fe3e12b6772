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

`normal` and `permutation` return `jax.random.normal` (float32) and
`jax.random.permutation(key, n)` bit for bit. A normal is
`sqrt(2) * erf_inv(u)` for u uniform on [nextafter(-1, 0), 1), and jax's
`erf_inv` is XLA's single-precision polynomial, whose `log1p` and `log` are
XLA's own (Cephes-style) approximations, not libm's: `xla_log`,
`xla_log1p`, `erf_inv` and `xla_exp` below repeat XLA's CPU code operation
for operation, including the multiply-adds its compiler fuses (emulated
exactly: a float32 product is exact in float64, and the float64 sum rounds
to float32 as the fused operation does, barring double rounding), with
division and square root rounded from float64 (torch's float32 CPU `sqrt`
is not correctly rounded). `sin` is float64 `sin` rounded to float32; XLA
calls libm's `sinf`, which differs from the correctly rounded value by an
ulp in about 2% of arguments.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
import struct

import numpy as np
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
    k1 = key[..., 0].reshape(tuple(lead) + (1,) * len(shape))
    k2 = key[..., 1].reshape(tuple(lead) + (1,) * len(shape))
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
    return _unit(random_bits(key, shape))


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1), as `uniform` makes them."""
    f = ((bits >> (32 - _F32_MANTISSA)) | _ONE_F32_BITS).to(torch.int32)
    return f.view(torch.float32) - 1.0


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: threefry2x32 of the counter pair
    (0, data) under `key` (a uint32 `data` seeds the key [0, data]).
    `data` is an int or an int tensor broadcasting against the key's
    leading axes; returns [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64,
                           device=key.device) & _MASK
    b1, b2 = _threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                           data)
    return torch.stack([b1, b2], dim=-1)


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` (mode "low", p float32):
    `uniform(key, shape) < p`."""
    return uniform(key, shape) < float(np.float32(p))


def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32): two
    32-bit words from the two halves of `split(key)`, folded into the span
    as (hi mod span) * (2**32 mod span) + lo mod span, mod span, in uint32
    arithmetic (int64 masked to 32 bits)."""
    minval, maxval = int(minval), int(maxval)
    keys = split(key)
    hi = random_bits(keys[..., 0, :], shape)
    lo = random_bits(keys[..., 1, :], shape)
    span = maxval - minval if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (((hi % span) * mult) & _MASK) + lo % span
    off = (off & _MASK) % span
    return (minval + off).to(torch.int32)


def top_k(x: torch.Tensor, k: int) -> tuple:
    """`jax.lax.top_k(x, k)` over the last axis: (values, indices), the k
    largest in descending order, ties to the lower index first (a stable
    descending sort; `torch.topk` promises no order among ties)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def uniform_range(key: torch.Tensor, shape, minval: float,
                  maxval: float) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`:
    `max(minval, u * (maxval - minval) + minval)` in float32, u = `uniform`
    (the range folded to one float32 constant, as XLA folds it)."""
    return _to_range(uniform(key, shape), minval, maxval)


def _to_range(u: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    # The bounds as float32 on the host: the clamp takes `lo` as a scalar
    # of the same bits, so nothing is copied to the device.
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(lo)))
    return torch.clamp_min(u * span + lo, lo)


# --- XLA's float32 elementary functions (CPU code generator) ---------------

def _f32(hex64: str) -> float:
    """A float32 constant from the 64-bit hex form LLVM IR prints it in."""
    return float(np.float32(struct.unpack(">d", bytes.fromhex(hex64))[0]))


_F32 = torch.float32
_MIN_NORMAL = _f32("3810000000000000")
_LOG_SQRTHF = _f32("3FE6A09E60000000")
_LOG_P = [_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000")]
_LOG_Q1 = _f32("BF2BD01060000000")
_LOG_Q2 = _f32("3FE6300000000000")
_LOG1P_SMALL = _f32("3FDA8279A0000000")          # sqrt(2) - 1
_LOG1P_DEN = [_f32(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000")]
_LOG1P_NUM0 = _f32("3F07BC0960000000")
_LOG1P_NUM = [_f32(h) for h in (
    "3FDFE818A0000000", "401A509F40000000", "403DE97380000000",
    "404E798EC0000000", "404C8E75A0000000", "40340A2020000000")]
_EXP_LO = _f32("C055F33340000000")
_EXP_HI = _f32("4056333340000000")
_LOG2E = _f32("3FF7154760000000")
_EXP_P = [_f32(h) for h in (
    "3F2A0D2CE0000000", "3F56E879C0000000", "3F81112100000000",
    "3FA5553820000000", "3FC5555540000000")]
# Giles' single-precision erf_inv: w < 5 and w >= 5 coefficient sets.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
SQRT2_F32 = float(np.float32(np.sqrt(2)))


def fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding (a fused multiply-add): the
    product is exact in float64 and the sum is rounded once more to
    float32."""
    d = [x.double() if isinstance(x, torch.Tensor) else x for x in (a, b, c)]
    return (d[0] * d[1] + d[2]).to(_F32)


# XLA's CPU tree-reduction rewrite splits rows wider than this into
# windows of this many elements.
XLA_REDUCE_WINDOW = 32


def _index_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order, from 0.0."""
    acc = torch.zeros(x.shape[:-1], dtype=_F32, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _lanes_tree(v: torch.Tensor) -> torch.Tensor:
    """A vector register's horizontal sum, as LLVM lowers a reassociable
    `vector.reduce.fadd`: the high half added to the low half until one
    lane is left."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def xla_row_sum(x: torch.Tensor, fused_with=None, *,
                vectorized: bool = False) -> torch.Tensor:
    """float32 `jnp.sum(x * fused_with, axis=-1)` in the order XLA's CPU
    backend compiles it (`x` alone when `fused_with` is None), from the
    reference generator's dumped HLO and LLVM IR (`--xla_dump_to`):

    - C <= 32: the reduce is one fusion with the multiply. The sum runs in
      index order from 0, each product fused into the running sum (one
      rounding: the backend contracts fmul + fadd into an FMA).
    - C == 32 with `vectorized` (the other factor is a per-column vector
      the fusion computes, loop-invariant over the rows, as the hotspot
      weights and the PARSEC chip weights are): LLVM's loop vectorizer
      takes the row as four 8-lane chunks, lane j summing chunk 0's
      product, rounded, then chunks 1-3 fused in, and ends with the
      8-lane tree (`_lanes_tree`).
    - C == 30 or 31 with `vectorized`: 4-lane vectors over columns 0-23,
      one accumulator taking the chunks at columns 0 (its product
      rounded), then 8, 16, 12, 4 and 20 fused in (the order of the
      compiled x86 code), the lanes summed as (0 + 2) + (1 + 3), then
      columns 24 onward fused in index order. Below 30 the row is not
      vectorized.
    - C > 32: the tree-reduction rewrite (`reduce-window(window={size=1x32
      stride=1x32 pad=0_0xLO_HI})` then `reduce`): the products rounded
      first (a separate `multiply`), the row zero-padded to a multiple of
      32 with LO = pad // 2 in front and HI = pad - LO behind, each window
      summed in index order from 0, and the window sums reduced by the
      same rule until 32 or fewer are left, summed in index order.
    """
    if fused_with is not None:
        x, w = torch.broadcast_tensors(x, torch.as_tensor(
            fused_with, dtype=_F32, device=x.device))
    c = int(x.shape[-1])
    if c > XLA_REDUCE_WINDOW:
        terms = x if fused_with is None else x * w
        while terms.shape[-1] > XLA_REDUCE_WINDOW:
            pad = -terms.shape[-1] % XLA_REDUCE_WINDOW
            terms = torch.nn.functional.pad(terms, (pad // 2, pad - pad // 2))
            terms = _index_order_sum(terms.reshape(
                terms.shape[:-1] + (-1, XLA_REDUCE_WINDOW)))
        return _index_order_sum(terms)
    if fused_with is None:
        return _index_order_sum(x)
    if vectorized and c in (XLA_REDUCE_WINDOW - 2, XLA_REDUCE_WINDOW - 1):
        lanes = x[..., :4] * w[..., :4]
        for k in (8, 16, 12, 4, 20):
            lanes = fma(x[..., k:k + 4], w[..., k:k + 4], lanes)
        acc = (lanes[..., 0] + lanes[..., 2]) + (lanes[..., 1] + lanes[..., 3])
        for i in range(24, c):
            acc = fma(x[..., i], w[..., i], acc)
        return acc
    if vectorized and c == XLA_REDUCE_WINDOW:
        lanes = x[..., :8] * w[..., :8]
        for k in range(8, c, 8):
            lanes = fma(x[..., k:k + 8], w[..., k:k + 8], lanes)
        return _lanes_tree(lanes)
    acc = torch.zeros(x.shape[:-1], dtype=_F32, device=x.device)
    for i in range(c):
        acc = fma(x[..., i], w[..., i], acc)
    return acc


def div(a: torch.Tensor, b) -> torch.Tensor:
    """Correctly rounded float32 a / b."""
    return (a.double() / (b.double() if isinstance(b, torch.Tensor)
                          else b)).to(_F32)


def sqrt(a: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt."""
    return torch.sqrt(a.double()).to(_F32)


def sin(a: torch.Tensor) -> torch.Tensor:
    """float32 sin as float64 sin rounded (XLA calls libm's sinf, which is
    an ulp off the correctly rounded value for some arguments)."""
    return torch.sin(a.double()).to(_F32)


def _full(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, v, dtype=_F32)


def xla_log(v: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log (CPU): exponent split, mantissa in [sqrt(1/2),
    sqrt(2)), a degree-9 Cephes polynomial; denormal inputs read as 0."""
    x = torch.where(v > _MIN_NORMAL, v, _full(_MIN_NORMAL, v))
    bits = x.view(torch.int32)
    e1 = ((bits >> 23) - 127).to(_F32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(_F32)
    low = m < _LOG_SQRTHF
    e = e1 - low.to(_F32)
    xx = (m + -1.0) + torch.where(low, m, _full(0.0, m))
    x2 = xx * xx
    x3 = x2 * xx
    a = fma(fma(xx, _LOG_P[0], _LOG_P[1]), xx, _LOG_P[2])
    b = fma(fma(xx, _LOG_P[3], _LOG_P[4]), xx, _LOG_P[5])
    c = fma(fma(xx, _LOG_P[6], _LOG_P[7]), xx, _LOG_P[8])
    y = fma(fma(fma(a, x3, b), x3, c), x3, e * _LOG_Q1)
    out = ((xx - x2 * 0.5) + y) + e * _LOG_Q2
    out = torch.where(v < _MIN_NORMAL, _full(float("-inf"), v), out)
    out = torch.where(v < 0, _full(float("nan"), v), out)
    return torch.where(v == float("inf"), v, out)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p (CPU): a rational Cephes approximation for
    |x| < sqrt(2) - 1, `xla_log(1 + x)` beyond."""
    x2 = x * x
    d = x + _LOG1P_DEN[0]
    for c in _LOG1P_DEN[1:]:
        d = fma(d, x, c)
    n = fma(x, _LOG1P_NUM0, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        n = fma(n, x, c)
    small = x + (x2 * -0.5 + (x * x2) * div(n, d))
    return torch.where(x.abs() < _LOG1P_SMALL, small, xla_log(x + 1.0))


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 exp (CPU): clamp, n = floor(x log2 e + 1/2), a Cephes
    polynomial of the reduced argument, times 2^n; denormals flushed."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(n, -_LOG_Q1, x - n * _LOG_Q2)
    y = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = fma(y, r, c)
    y = 1.0 + fma(fma(y, r, 0.5), r * r, r)
    out = y * ((n.to(torch.int32) + 127) << 23).view(_F32)
    # XLA's CPU code flushes denormal results to zero.
    return torch.where(out < _MIN_NORMAL, _full(0.0, out), out)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv: Giles' polynomial in w = -log1p(-x^2)."""
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    wv = torch.where(lt, w + -2.5, sqrt(w) + -3.0)
    p = torch.where(lt, _full(_ERFINV_LT5[0], x), _full(_ERFINV_GE5[0], x))
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, wv, torch.where(lt, _full(lo, x), _full(hi, x)))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal_erf_inv(key: torch.Tensor, shape) -> torch.Tensor:
    """`erf_inv(u)` of the uniform a normal draw uses: `normal` is this
    times sqrt(2). XLA folds that factor into a constant that multiplies
    the draw, so a generator mirroring such a fold starts here."""
    return erf_inv(uniform_range(key, shape, _NORMAL_LO, 1.0))


_F32_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.gumbel(key, shape)` (float32, mode "low", jax's
    default): `-log(-log(u))` for u uniform on [tiny, 1), with XLA's log."""
    return -xla_log(-xla_log(uniform_range(key, shape, _F32_TINY, 1.0)))


@functools.lru_cache(maxsize=None)
def _libm_powf():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = lib.powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return fn


def xla_powf(x: float, y: float) -> float:
    """XLA's float32 `x ** y` on the CPU (a host scalar): its code calls
    the C library's `powf`, and flushes a denormal result to zero."""
    out = _libm_powf()(float(np.float32(x)), float(np.float32(y)))
    return 0.0 if abs(out) < _F32_TINY else out


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.normal(key, shape)` (float32), bit for bit."""
    return normal_erf_inv(key, shape) * SQRT2_F32


def normal_range(key: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Elements [start, stop) of the flattened `normal(key, shape)`, float32
    [stop - start], for any `shape` of at least `stop` elements: each
    element hashes its own flat index, so a large draw made in slices of
    the counter holds the bits of the whole draw (with a few int64
    temporaries of the slice's size only). `key` is one key [2]."""
    idx = torch.arange(int(start), int(stop), dtype=torch.int64,
                       device=key.device)
    b1, b2 = _threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
    return erf_inv(_to_range(_unit(b1 ^ b2), _NORMAL_LO, 1.0)) * SQRT2_F32


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)`: arange(n) sorted, stably, by fresh
    32-bit keys in each of ceil(3 ln n / ln(2^32 - 1)) rounds, the round's
    key split off the carried one (`split(key)`: carry [0], round [1]).
    Returns int64 [..., n] for a key [..., 2]."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_MASK)))
    x = torch.arange(n, device=key.device).expand(*key.shape[:-1], n)
    for _ in range(rounds):
        pair = split(key)
        key, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True)[1]
        x = torch.gather(x, -1, order)
    return x
