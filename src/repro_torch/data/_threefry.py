"""JAX's default PRNG, Threefry-2x32, on the host in numpy ``uint32``.

The JAX package draws its synthetic batches with ``jax.random``; the
port's batches must be the same tokens bit for bit, so this module
rebuilds the few ``jax.random`` functions the data pipeline calls:
``PRNGKey``, ``fold_in``, ``split``, ``randint`` and ``uniform`` (32-bit
dtypes), under ``jax_threefry_partitionable = True``, the default since
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
