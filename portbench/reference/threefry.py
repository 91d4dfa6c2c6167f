"""The host randomness the program derives from a seed, in plain NumPy.

- The master stream: NumPy's PCG64 generator seeded with the seed, one u64
  per experiment or replica (``integers(0, 2**64, dtype=uint64)``).
- Keys: a u64 seed is the threefry2x32 key ``[hi, lo]``; ``split`` is the
  block function at counters ``(0, 0)`` (the next key) and ``(0, 1)`` (the
  sub-key); word ``i`` of ``bits(key, n)`` is ``x0 ^ x1`` at counter
  ``(i >> 32, i & 0xFFFFFFFF)``; a uniform f32 keeps the top 23 bits as the
  mantissa of a float in [1, 2), minus 1; a Bernoulli(1/2) state is +1 where
  the top bit is 0.
- A kernel seed is ``k0 ^ 0x9E3779B9 ^ (k1 << 1)`` as int32.

Threefry2x32 is the 20-round block function with the key schedule
``(k0, k1, k0 ^ k1 ^ 0x1BD11BDA)`` and rotations (13, 15, 26, 6),
(17, 29, 16, 24).
"""

from __future__ import annotations

import numpy as np

__all__ = ["master_seeds", "keys_of", "threefry2x32", "split", "bits", "uniform_f32", "bernoulli_states",
           "kernel_seeds"]

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def master_seeds(gen: np.random.Generator, n: int) -> np.ndarray:
    """The next ``n`` u64 seeds of a master stream."""
    return gen.integers(0, 2**64, size=int(n), dtype=np.uint64)


def keys_of(seeds_u64) -> np.ndarray:
    """u64 seeds -> ``[n, 2]`` uint32 keys ``[hi, lo]``."""
    s = np.asarray(seeds_u64, np.uint64)
    return np.stack([(s >> np.uint64(32)).astype(np.uint32), (s & np.uint64(0xFFFFFFFF)).astype(np.uint32)], -1)


def threefry2x32(k0, k1, x0, x1):
    k0, k1, x0, x1 = (np.asarray(v, np.uint32) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for n in range(5):
            for r in _ROT[n % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(n + 1) % 3]
            x1 = x1 + ks[(n + 2) % 3] + np.uint32(n + 1)
    return x0, x1


def split(keys: np.ndarray):
    """``[n, 2]`` keys -> ``(next keys, sub-keys)``."""
    k = np.asarray(keys, np.uint32).reshape(-1, 2)
    y0, y1 = threefry2x32(k[:, :1], k[:, 1:], np.uint32(0), np.arange(2, dtype=np.uint32))
    out = np.stack([y0, y1], -1)
    return out[:, 0], out[:, 1]


def bits(keys: np.ndarray, n: int) -> np.ndarray:
    k = np.asarray(keys, np.uint32).reshape(-1, 2)
    i = np.arange(int(n), dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)[None]
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)[None]
    y0, y1 = threefry2x32(k[:, :1], k[:, 1:], hi, lo)
    return y0 ^ y1


def uniform_f32(keys: np.ndarray, n: int) -> np.ndarray:
    b = bits(keys, n)
    return ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)


def bernoulli_states(keys: np.ndarray, n: int) -> np.ndarray:
    """``[R, n]`` int8 +-1 states: +1 where the word's top bit is 0."""
    return np.where(bits(keys, n) < np.uint32(1 << 31), 1, -1).astype(np.int8)


def kernel_seeds(keys: np.ndarray) -> np.ndarray:
    k = np.asarray(keys, np.uint32).reshape(-1, 2)
    return (k[:, 0] ^ np.uint32(0x9E3779B9) ^ (k[:, 1] << np.uint32(1))).view(np.int32)
