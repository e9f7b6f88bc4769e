"""Counter-based random draws that reproduce JAX's default PRNG bit for
bit: the Threefry-2x32 block cipher under JAX's key derivation
(``jax.random.key``, ``fold_in``) and its partitionable bit stream
(``jax_threefry_partitionable=True``, the default from JAX 0.5), in numpy
``uint32`` arithmetic on the host.

A key is a pair ``(k0, k1)`` of ``uint32`` arrays of one shape, so a
whole fleet's keys derive in one vectorized call.  The uniform-to-normal
map is JAX's too (23 mantissa bits of a draw -> ``[nextafter(-1, 0), 1)``
-> ``sqrt(2) * erfinv``), with the inverse error function computed as
XLA computes ``lax.erf_inv`` in float32 (Giles's polynomial in
``w = -log1p(-x^2)``, :func:`erf_inv`).  Only ``log1p``'s last bit may
differ between libraries: the normals agree with ``jax.random.normal`` to
~2.3e-7 relative, most of them bit for bit.
"""
from __future__ import annotations

import numpy as np

# Threefry-2x32's rotation constants, rounds 0-3 and 4-7 of each group of
# eight (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3",
# SC 2011, Table 4; the constants of ``jax._src.prng.threefry2x32``).
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# The key-schedule parity word of the Threefish family (Skein 1.3
# specification, C240 truncated to 32 bits; ``jax._src.prng``).
_KEY_PARITY = np.uint32(0x1BD11BDA)
_FLOAT_ONE_BITS = np.uint32(0x3F800000)   # float32 1.0
_MANTISSA_SHIFT = np.uint32(32 - 23)      # float32 keeps 23 mantissa bits
# Giles's float32 erfinv ("Approximating the erfinv function", GPU Computing
# Gems Jade Edition, 2011), highest power first, for w < 5 and for w >= 5:
# the coefficients of XLA's ErfInv32 (``lax.erf_inv`` in float32).
_ERFINV_W_LT_5 = np.float32([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941])
_ERFINV_W_GE_5 = np.float32([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682])


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


def erf_inv(x: np.ndarray) -> np.ndarray:
    """The inverse error function of float32 ``x`` in ``[-1, 1]`` as XLA
    computes it: ``w = -log1p(-x*x)``, then Horner's rule in ``w - 2.5``
    (``w < 5``) or ``sqrt(w) - 3`` over :data:`_ERFINV_W_LT_5` /
    :data:`_ERFINV_W_GE_5`, times ``x``; ``+-inf`` at ``|x| = 1``."""
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(divide="ignore"):   # w = inf at |x| = 1
        w = -np.log1p(-x * x)
    lt = w < np.float32(5)
    t = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3))
    p = np.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = np.where(lt, a, b) + p * t
    return np.where(np.abs(x) == np.float32(1),
                    np.copysign(np.float32(np.inf), x), p * x)


def normal(k, n: int) -> np.ndarray:
    """``jax.random.normal`` in float32 (shape ``key_shape + (n,)``)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, n, lo, 1.0)
    return np.float32(np.sqrt(2.0)) * erf_inv(u)
