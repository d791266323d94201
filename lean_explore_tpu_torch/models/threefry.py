"""The JAX package's random draw, in numpy: threefry2x32 keys and normals.

``jax.random`` with its default threefry2x32 generator (the
"partitionable" layout: element ``i`` of a draw hashes the counter ``i``)
makes the JAX package's random inits, ``qwen3.init_params(config,
PRNGKey(seed))``. This module repeats that draw without JAX, so that a
model the port trains can start from the very weights the JAX package's
run at the same seed starts from (``qwen3.init_params_threefry``):

- ``key(seed)``, ``split(key, n)`` and ``bits(key, shape)`` equal
  ``jax.random.PRNGKey``, ``split`` and ``bits`` bit for bit;
- ``normal(key, shape)`` is ``jax.random.normal``'s float32 draw: the
  same uniform bits through Giles' float32 ``erf_inv`` polynomial, the
  one XLA evaluates, with each multiply-add rounded once as a fused one.
  XLA's own ``log1p`` inside it may round its last bit differently, so a
  value can differ from JAX's by a few units in the last place (at most 3
  in the tests, in under 1% of values).
"""

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)

# Giles, "Approximating the erfinv function" (GPU Computing Gems 2, 2010),
# single precision: for w = -log1p(-x^2) < 5 and otherwise.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 block cipher of ``key`` (two uint32)
    over the counter pairs ``(x1, x2)``."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << _U32(r)) | (x[1] >> _U32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def _counters(key: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The cipher over the 64-bit counters 0..n-1 (high word 0)."""
    if n >= 2**32:
        raise ValueError(f"{n} draws: the counter's high word is not modelled")
    return threefry2x32(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s data for a seed of 32 bits."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed}: a non-negative int32 is modelled")
    return np.array([0, seed], _U32)


def split(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.split(key, n)``: [n, 2] uint32."""
    return np.stack(_counters(key, n), axis=1)


def bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(key, shape)``: uint32 of ``shape``."""
    b1, b2 = _counters(key, int(np.prod(shape)))
    return (b1 ^ b2).reshape(shape)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(f32)
    small = w < f32(5)
    w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3))
    p = np.where(small, f32(_ERFINV_SMALL[0]), f32(_ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, f32(a), f32(b))
        # One rounding, as a fused multiply-add: the float64 product of two
        # float32 values is exact.
        p = (c.astype(np.float64) + p.astype(np.float64) * w).astype(f32)
    return p * x


def normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32 (module docstring)."""
    f32 = np.float32
    mantissa = (bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = mantissa.view(f32) - f32(1)
    lo = np.nextafter(f32(-1), f32(0))
    uniform = np.maximum(lo, floats * (f32(1) - lo) + lo)
    return f32(np.sqrt(2)) * _erf_inv(uniform)
