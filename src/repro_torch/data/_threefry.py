"""JAX's default PRNG, Threefry-2x32, on the host in numpy ``uint32``.

The JAX package draws its synthetic batches with ``jax.random``; the
port's batches must be the same tokens bit for bit, so this module
rebuilds the few ``jax.random`` functions the data pipeline calls:
``PRNGKey``, ``fold_in``, ``split``, ``randint``, ``uniform`` and
``normal`` (32-bit dtypes), under ``jax_threefry_partitionable = True``, the default since
JAX 0.5. In that mode a draw of shape ``s`` hashes the row-major index of
each element, as a 64-bit counter split into its high and low words, and
returns the two output words XORed; ``split`` hashes the key's index the
same way and keeps both words as the new key.

A key is a ``(2,)`` ``uint32`` array, as JAX's raw keys are. Everything
wraps modulo 2^32, as ``uint32`` arithmetic does in XLA.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = np.uint32(0x1BD11BDA)
_MASK = 0xFFFFFFFF


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)``, equal
    ``uint32`` arrays, under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits int32 (JAX's seed
    type without x64): the high word 0, the low word the seed's bits."""
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32")
    return np.array([0, seed & _MASK], np.uint32)


def _counters(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    x0, x1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data & _MASK], np.uint32))
    return np.array([x0[0], x1[0]], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) keys, key i the hash of counter i."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits an element of ``shape``."""
    b0, b1 = threefry2x32(key, *_counters(math.prod(shape)))
    return (b0 ^ b1).reshape(shape)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``: two
    draws of 32 bits an element reduced modulo the span (with the span's
    multiplier ``(2^16 mod span)^2 mod span`` on the high draw, the square
    wrapping modulo 2^32 as JAX's ``uint32`` product does: 0 for any span
    above 2^16)."""
    if not (-2**31 <= minval and maxval <= 2**31 - 1):
        raise ValueError("randint bounds must fit int32")
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(max(maxval - minval, 1))
    mult = np.uint32((2**16 % int(span)) ** 2 % 2**32 % int(span))
    with np.errstate(over="ignore"):
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float32 on [0, 1): the top 23
    bits as the mantissa of a number in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    return ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)


# -- normal: sqrt(2) * erfinv(u), every op as XLA compiles it on the CPU ----
#
# XLA's CPU backend lets LLVM contract a multiply feeding an add into one
# fused multiply-add; ``_fma`` does that in float64, where the product of
# two float32 is exact, and rounds once to float32.

_F32, _F64 = np.float32, np.float64


def _fma(a, b, c):
    return (np.asarray(a, _F64) * np.asarray(b, _F64) + np.asarray(c, _F64)).astype(_F32)


def _poly(x, coeffs):
    """Horner's rule, one fma a coefficient (highest degree first)."""
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _F32(c))
    return p


# log1p's small branch: Cephes's rational approximation (XLA's EmitLog1p)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# the float32 log of XLA's CPU runtime (Cephes's logf, as Eigen's plog)
_LOG_P = tuple(map(_F32, (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)))
_LOG_Q1, _LOG_Q2 = _F32(-2.12194440e-4), _F32(0.693359375)


def _log(v):
    """float32 log of positive normal ``v``: mantissa m in [sqrt(1/2),
    sqrt(2)) and exponent e, log(m) by a polynomial in x = m - 1, plus
    e·ln 2 split into two constants."""
    m, e = np.frexp(v)
    x, e = m.astype(_F32), e.astype(_F32)
    small = x < _F32(0.707106781186547524)
    e = (e - small.astype(_F32)).astype(_F32)
    x = ((x - _F32(1)) + np.where(small, x, _F32(0))).astype(_F32)
    x2 = (x * x).astype(_F32)
    x3 = (x2 * x).astype(_F32)
    y = _fma(_fma(np.full_like(x, _LOG_P[0]), x, _LOG_P[1]), x, _LOG_P[2])
    y1 = _fma(_fma(np.full_like(x, _LOG_P[3]), x, _LOG_P[4]), x, _LOG_P[5])
    y2 = _fma(_fma(np.full_like(x, _LOG_P[6]), x, _LOG_P[7]), x, _LOG_P[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, (_LOG_Q1 * e).astype(_F32))
    x = _fma(x2, _F32(-0.5), x)
    x = (x + y).astype(_F32)
    return _fma(e, _LOG_Q2, x)


def _log1p(x):
    """XLA's log1p: the rational approximation where |x| < sqrt(2) - 1,
    else log(1 + x)."""
    x2 = (x * x).astype(_F32)
    r = (_poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)).astype(_F32)
    r = ((x * x2).astype(_F32) * r).astype(_F32)
    r = (x + _fma(_F32(-0.5), x2, r)).astype(_F32)
    with np.errstate(invalid="ignore", divide="ignore"):
        large = _log((x + _F32(1)).astype(_F32))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), r, large)


# erfinv: Giles's single-precision polynomials, in w - 2.5 below w = 5 and
# in sqrt(w) - 3 above, where w = -log(1 - x^2) (XLA's ErfInv32)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def _erfinv(x):
    w = -_log1p((x * -x).astype(_F32))
    lt = w < _F32(5)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3)).astype(_F32)
    p = np.where(lt, _F32(_ERFINV_LT5[0]), _F32(_ERFINV_GT5[0])).astype(_F32)
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GT5[1:]):
        p = _fma(p, w, np.where(lt, _F32(lo), _F32(hi)))
    return (p * x).astype(_F32)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32: sqrt(2)·erfinv(u) of
    ``u`` uniform on [nextafter(-1, 0), 1), every op as XLA's CPU backend
    computes it. |u| < 1 always, so erfinv's ±1 case never arises."""
    lo = np.nextafter(_F32(-1), _F32(0))
    u = np.maximum(lo, (uniform(key, shape) * _F32(2) + lo).astype(_F32))
    return (_F32(np.sqrt(2)) * _erfinv(u)).astype(_F32)
