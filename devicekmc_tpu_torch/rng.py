"""Threefry-2x32 counter-based RNG, bit-identical to ``jax.random`` with
``jax_threefry_partitionable=True`` (the jax 0.9 default) and 64-bit seeds.

The event loop draws three keys per event, so keys and draws are computed
on the host in plain Python integers: a key is a pair of 32-bit words
``(k0, k1)``, exactly the uint32[2] raw key of ``jax.random.PRNGKey``.

  * ``prng_key(seed)``     == ``jax.random.PRNGKey(seed)``
  * ``split(key, n)``      == ``jax.random.split(key, n)``
  * ``fold_in(key, data)``  == ``jax.random.fold_in(key, data)``
  * ``uniform(key, dtype)`` == ``jax.random.uniform(key, dtype=dtype)``
    for a scalar draw in [0, 1), dtype float32 or float64.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np
import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, count: Tuple[int, int]) -> Tuple[int, int]:
    """The 20-round Threefry-2x32 block function (Salmon et al. 2011), as
    ``jax._src.prng.threefry2x32``."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (count[0] + ks[0]) & _M32
    x1 = (count[1] + ks[1]) & _M32
    for step in range(5):
        for r in _ROT[step % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _M32
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """Raw key of a 64-bit integer seed: (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32) & _M32, seed & _M32


def split(key: Key, n: int = 2) -> List[Key]:
    """Fold-like split: key i is threefry(key, (0, i))."""
    return [threefry2x32(key, (0, i)) for i in range(n)]


def fold_in(key: Key, data: int) -> Key:
    """The key of ``data`` (taken as uint32) folded into ``key``:
    threefry(key, (0, data)), as ``jax.random.fold_in`` computes it from
    ``threefry_seed(uint32(data)) = (0, data)``."""
    return threefry2x32(key, (0, int(data) & _M32))


def uniform(key: Key, dtype=np.float64) -> float:
    """One uniform draw in [0, 1) of ``dtype`` (float32 or float64); the
    value is returned as a Python float holding that dtype's value."""
    b0, b1 = threefry2x32(key, (0, 0))
    if np.dtype(dtype) == np.float64:
        bits = (b0 << 32) | b1
        f = struct.unpack("<d", struct.pack("<Q", (bits >> 12) | 0x3FF0000000000000))[0]
        return f - 1.0
    if np.dtype(dtype) == np.float32:
        bits = b0 ^ b1
        f = np.frombuffer(
            struct.pack("<I", (bits >> 9) | 0x3F800000), dtype=np.float32
        )[0]
        return float(f - np.float32(1.0))
    raise TypeError(f"uniform supports float32 and float64, got {dtype}")


def key_from_array(arr) -> Key:
    """The (k0, k1) pair of a uint32[2] raw key array."""
    a = np.asarray(arr).astype(np.uint32).reshape(2)
    return int(a[0]), int(a[1])


def keys_tensor(keys, device="cpu"):
    """A [B, 2] uint32 tensor of the (k0, k1) pairs ``keys``: the key of
    each replica of a batched state, on ``device``."""
    return torch.tensor([list(k) for k in keys], dtype=torch.uint32, device=device)
