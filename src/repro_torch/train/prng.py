"""The threefry-2x32 key arithmetic that a JAX ``TrainState`` carries in its
``rng`` leaf, in numpy: ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)``'s
key data and ``fold_in(key, data)`` is ``jax.random.fold_in``'s, bit for bit
(JAX's default threefry-2x32 implementation, 20 rounds). Keys are uint32 [2].
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> np.ndarray:
    """A 64-bit seed bit-cast to two uint32 words, high word first."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


def _rotl(v: int, r: int) -> int:
    return (v << r | v >> (32 - r)) & 0xFFFFFFFF


def threefry_2x32(key: np.ndarray, x0: int, x1: int) -> np.ndarray:
    """One threefry-2x32 block of the counter pair (x0, x1) under ``key``."""
    k0, k1 = (int(k) for k in np.asarray(key, dtype=np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    m = 0xFFFFFFFF
    x = [(x0 + ks[0]) & m, (x1 + ks[1]) & m]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & m
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & m
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & m
    return np.array(x, dtype=np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` on raw key data."""
    return threefry_2x32(key, 0, int(data) & 0xFFFFFFFF)
