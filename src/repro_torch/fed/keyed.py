"""Keyed counter-based draws in numpy: the threefry-2x32 stream behind the
reference's ``jax.random`` keys, bit for bit.

The reference keys every failure-scenario draw by ``fold_in`` chains of a
``PRNGKey`` (fed/scenarios.py), so a draw is a pure function of its key
and any subset of clients sees the values of the full row.  This module
computes those same words on the host:

* ``prng_key(seed)`` is the key ``(0, seed mod 2³²)``;
* ``fold_in(key, data)`` is ``threefry(key, (0, data))`` — vectorised over
  ``data``, one key per element;
* the bits of a request of shape ``s`` are ``x0 ^ x1`` of
  ``threefry(key, (0, i))`` for the row-major index ``i`` of each element
  (the partitionable counter of ``jax_threefry_partitionable``, on by
  default since jax 0.5).  Element ``i``'s bits depend on ``i`` alone, so
  the first ``n`` draws of a request of length ``L ≥ n`` are those of a
  request of length ``n``: a padded row's draws are its unpadded row's;
* ``uniform`` maps the top 23 bits into [1, 2) and subtracts 1, as
  ``jax.random.uniform`` does (float32, bit for bit);
* ``normal`` is ``√2 · erfinv(u)`` on ``u`` uniform in
  ``[nextafter(−1, 0), 1)``, as ``jax.random.normal``, with XLA's erfinv
  polynomial; numpy's float32 ``log1p`` is not XLA's, so a value is within
  ``NORMAL_MAX_ULP`` float32 ulp of the reference's, not always equal.

All arithmetic is uint32 numpy, whose sums wrap.
"""
from __future__ import annotations

import numpy as np

# ``normal`` against ``jax.random.normal``: at most this many float32 ulp
# apart (the same erfinv polynomial; numpy's float32 log1p is not XLA's)
NORMAL_MAX_ULP = 4
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                        -4.39150654e-06, 0.00021858087, -0.00125372503,
                        -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                        -0.00367342844, 0.00573950773, -0.0076224613,
                        0.00943887047, 1.00167406, 2.83297682], np.float32)

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The 20-round threefry-2x32 block cipher on uint32 arrays (keys and
    counts broadcast against each other)."""
    k0 = np.asarray(k0, np.uint32)
    k1 = np.asarray(k1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
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
    """``jax.random.PRNGKey(seed)`` with 64-bit integers off (jax's
    default): the seed's low 32 bits, ``(2,)`` uint32 ``(0, seed)``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: ``key`` ``(..., 2)`` and ``data``
    an integer array (int32 values, taken mod 2³²) broadcast together;
    the result is ``(*broadcast shape, 2)`` uint32."""
    key = np.asarray(key, np.uint32)
    d = np.asarray(data, np.int64).astype(np.uint32)
    with np.errstate(over="ignore"):
        y0, y1 = threefry2x32(key[..., 0], key[..., 1], np.uint32(0), d)
    return np.stack([y0, y1], axis=-1)


def random_bits(key: np.ndarray, shape=()) -> np.ndarray:
    """32-bit words of ``jax.random.bits(key, shape)``: for ``key``
    ``(..., 2)`` the result is ``(..., *shape)``, one request per key."""
    key = np.asarray(key, np.uint32)
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    lead = key.shape[:-1]
    idx = np.arange(n, dtype=np.uint32)
    k0 = key[..., 0].reshape(lead + (1,))
    k1 = key[..., 1].reshape(lead + (1,))
    with np.errstate(over="ignore"):
        y0, y1 = threefry2x32(k0, k1, np.uint32(0), idx)
    return (y0 ^ y1).reshape(lead + shape)


def uniform(key: np.ndarray, shape=()) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` (float32 on [0, 1)), bit for
    bit; ``key`` ``(..., 2)`` gives ``(..., *shape)``."""
    bits = random_bits(key, shape)
    one = np.uint32(0x3F800000)
    return ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)


def _erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv (Giles' single-precision approximation: one
    degree-8 polynomial in ``w − 2.5`` for ``w = −log1p(−x²) < 5``, another
    in ``√w − 3`` past it), step for step in float32 numpy."""
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, c_lt, c_ge) + p * w
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x)


def normal(key: np.ndarray, shape=()) -> np.ndarray:
    """``jax.random.normal(key, shape)`` (float32) within
    ``NORMAL_MAX_ULP``: ``√2 · erfinv(u)``, u uniform in
    ``[nextafter(−1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    hi = np.float32(1.0)
    u = np.maximum(lo, uniform(key, shape) * (hi - lo) + lo)
    return np.float32(np.sqrt(2.0)) * _erfinv(u)
