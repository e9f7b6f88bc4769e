"""Counter-based random draws that reproduce JAX's default PRNG bit for
bit: the Threefry-2x32 block cipher under JAX's key derivation
(``jax.random.key``, ``fold_in``) and its partitionable bit stream
(``jax_threefry_partitionable=True``, the default from JAX 0.5), in numpy
``uint32`` arithmetic on the host.

A key is a pair ``(k0, k1)`` of ``uint32`` arrays of one shape, so a
whole fleet's keys derive in one vectorized call.  The uniform-to-normal
map is JAX's too (23 mantissa bits of a draw -> ``[nextafter(-1, 0), 1)``
-> ``sqrt(2) * erfinv``), with ``torch.erfinv`` in float32, which differs
from XLA's float32 polynomial in the last bits: the normals agree with
``jax.random.normal`` to ~1e-7, not bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

# Threefry-2x32's rotation constants, rounds 0-3 and 4-7 of each group of
# eight (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
# SC 2011, Table 4; the constants of ``jax._src.prng.threefry2x32``).
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# The key-schedule parity word of the Threefish family (Skein 1.3
# specification, C240 truncated to 32 bits; ``jax._src.prng``).
_KEY_PARITY = np.uint32(0x1BD11BDA)
_FLOAT_ONE_BITS = np.uint32(0x3F800000)   # float32 1.0
_MANTISSA_SHIFT = np.uint32(32 - 23)      # float32 keeps 23 mantissa bits


def _u32(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, dtype=np.uint32))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 block of key ``(k0, k1)`` and counter
    words ``(x0, x1)`` (uint32 arrays, broadcast together)."""
    k0, k1, x0, x1 = np.broadcast_arrays(_u32(k0), _u32(k1), _u32(x0),
                                         _u32(x1))
    ks = (k0, k1, k0 ^ k1 ^ _KEY_PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(group + 1) % 3]
        x1 = x1 + ks[(group + 2) % 3] + np.uint32(group + 1)
    return x0, x1


def key(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``jax.random.key(seed)`` for a seed below 2^32: ``(0, seed)``."""
    return _u32(0), _u32(seed)


def fold_in(k, data) -> tuple[np.ndarray, np.ndarray]:
    """``jax.random.fold_in``: the block of counter ``(0, data)`` under
    the key (``data`` broadcasts against the key's shape)."""
    return threefry2x32(k[0], k[1], 0, data)


def random_bits(k, n: int) -> np.ndarray:
    """``n`` 32-bit draws of each key (shape ``key_shape + (n,)``): the
    partitionable stream, ``hi ^ lo`` of the block of counter ``(0, i)``
    for draw ``i``."""
    lo = np.arange(n, dtype=np.uint32)
    b0, b1 = threefry2x32(k[0][..., None], k[1][..., None], 0, lo)
    return b0 ^ b1


def uniform(k, n: int, minval: float = 0.0, maxval: float = 1.0
            ) -> np.ndarray:
    """``jax.random.uniform`` in float32 over ``[minval, maxval)``."""
    bits = random_bits(k, n)
    f = ((bits >> _MANTISSA_SHIFT) | _FLOAT_ONE_BITS).view(np.float32)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, (f - np.float32(1.0)) * (hi - lo) + lo)


def normal(k, n: int) -> np.ndarray:
    """``jax.random.normal`` in float32 (shape ``key_shape + (n,)``)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, n, lo, 1.0)
    z = torch.erfinv(torch.from_numpy(np.ascontiguousarray(u))).numpy()
    return np.float32(np.sqrt(2.0)) * z
