"""JAX's default random bits and normals in numpy (threefry2x32).

The JAX package draws fixed projection matrices from ``jax.random`` (the
gather matcher's patch projection, ``jax.random.normal(PRNGKey(42), (256,
128))``; gist's ``PRNGKey(7)`` projection). The port needs the same
matrices and cannot import JAX, so this module computes them:

  * ``PRNGKey(seed)`` is the key pair (0, seed) for a 32-bit seed;
  * ``bits(key, shape)`` is JAX's partitionable threefry path
    (``jax_threefry_partitionable``, the default since jax 0.5): the counter
    of element n is its flat index split into (hi, lo) 32-bit words, hashed
    by threefry2x32 (5 x 4 rounds, rotations 13, 15, 26, 6 / 17, 29, 16,
    24, key schedule with 0x1BD11BDA), and the two output words XORed —
    bit for bit ``jax.random.bits``;
  * ``normal(key, shape)`` maps ``bits >> 9`` to a uniform on
    [nextafter(-1, 0), 1) and returns sqrt(2) * erfinv(u) with XLA's f32
    erfinv polynomial (M. Giles' single-precision approximation), evaluated
    in f32. XLA may contract some products into FMAs, so a value can differ
    from JAX's in the last bits (~5% of the values, by at most 5e-7 for the
    seeds in use; tests/test_torch_gather.py holds them within 3e-5);
  * ``fold_in(key, data)`` is threefry2x32 of the counter (0, data) under
    ``key``; ``uniform`` and ``truncated_normal`` follow ``jax.random``'s
    f32 paths (``truncated_normal`` reuses the erfinv above);
  * ``fold_in_static(key, names)`` is flax's ``_fold_in_static``: the first
    32 bits of the SHA-1 of a module path's names and a ``make_rng``
    counter, folded in. With these, ``models/descriptor.py`` draws the
    parameters ``flax.linen.Module.init(PRNGKey(seed), ...)`` draws.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> tuple:
    """The (hi, lo) uint32 words of ``jax.random.PRNGKey(seed)`` for a seed
    in [0, 2**32) (wider seeds depend on JAX's x64 mode)."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return (np.uint32(0), np.uint32(seed))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: tuple, x0: np.ndarray, x1: np.ndarray):
    """threefry2x32 of the counter words (x0, x1) under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    for step in range(5):
        for r in _ROT[step % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(step + 1) % 3]
        x1 = x1 + ks[(step + 2) % 3] + np.uint32(step + 1)
    return x0, x1


def bits(key: tuple, shape) -> np.ndarray:
    """uint32 array equal to ``jax.random.bits(key, shape)``."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


# XLA's ErfInv for f32 (xla/client/lib/math.cc): two polynomials in w
_ERFINV_LO = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_HI = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    f = np.float32
    w = -np.log1p(-x * x)
    small = w < f(5.0)
    ws = w - f(2.5)
    wl = np.sqrt(np.maximum(w, f(0.0))) - f(3.0)
    p_s = np.full_like(x, f(_ERFINV_LO[0]))
    p_l = np.full_like(x, f(_ERFINV_HI[0]))
    for c_s, c_l in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p_s = f(c_s) + p_s * ws
        p_l = f(c_l) + p_l * wl
    out = np.where(small, p_s, p_l) * x
    return np.where(np.abs(x) == f(1.0), np.copysign(f(np.inf), x), out).astype(f)


def normal(key: tuple, shape) -> np.ndarray:
    """float32 standard normals matching ``jax.random.normal(key, shape)``
    (to the last bits; see the module docstring)."""
    f = np.float32
    u_bits = (bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = u_bits.view(np.float32) - f(1.0)  # [0, 1)
    lo = np.nextafter(f(-1.0), f(0.0))
    hi = f(1.0)
    u = np.maximum(lo, floats * (hi - lo) + lo)
    return (f(np.sqrt(2.0)) * _erfinv_f32(u)).astype(f)


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    with np.errstate(over="ignore"):
        y0, y1 = threefry2x32(
            key, np.zeros(1, np.uint32), np.asarray([data], np.uint64).astype(np.uint32)
        )
    return (np.uint32(y0[0]), np.uint32(y1[0]))


def fold_in_static(key: tuple, data) -> tuple:
    """flax.core.scope._fold_in_static: fold the first 32 bits of the SHA-1
    of ``data`` (strings as UTF-8, ints as their shortest big-endian bytes,
    no separator: flax's ``flax_fix_rng_separator`` is off by default) into
    ``key``. A parameter's key is this of the init key and (module path
    names..., the scope's make_rng counter)."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def uniform(key: tuple, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 values equal to ``jax.random.uniform(key, shape,
    minval=minval, maxval=maxval)``."""
    f = np.float32
    lo, hi = f(minval), f(maxval)
    u_bits = (bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = u_bits.view(np.float32) - f(1.0)  # [0, 1)
    # XLA contracts floats * (hi - lo) + lo into one FMA: the product and
    # sum in f64, rounded to f32 once
    scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(f)
    return np.maximum(lo, scaled)


def truncated_normal(key: tuple, lower, upper, shape) -> np.ndarray:
    """float32 normals truncated to (lower, upper), as
    ``jax.random.truncated_normal(key, lower, upper, shape)``: erf of the
    bounds, a uniform between them, sqrt(2) * erfinv, then the clip to the
    open interval (to the last bits, as ``normal``)."""
    f = np.float32
    sqrt2 = f(np.sqrt(2.0))
    lower, upper = f(lower), f(upper)
    # the f32 erf of the bounds (XLA's polynomial and the correctly rounded
    # value agree at the bounds in use, +-2 / sqrt 2)
    a = f(math.erf(float(lower / sqrt2)))
    b = f(math.erf(float(upper / sqrt2)))
    out = (sqrt2 * _erfinv_f32(uniform(key, shape, a, b))).astype(f)
    return np.clip(out, np.nextafter(lower, f(np.inf)), np.nextafter(upper, f(-np.inf))).astype(f)
