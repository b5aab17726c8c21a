"""``jax.random``'s key stream in numpy: threefry2x32 keys, their splits
and folds, and the float draws made from them.

The card's host has no JAX, yet the fixture trainers start where the JAX
package's tools do: ``init_tiny(jax.random.key(0))`` and batch keys split
from ``jax.random.key(1)``. This module reproduces, with numpy only, the
``jax.random`` calls those tools make, as JAX 0.9 makes them with its
default ``jax_threefry_partitionable=True``:

- ``key(seed)``, ``split``, ``fold_in`` and ``random_bits`` are bit-exact:
  a key is a (..., 2) uint32 array (``jax.random.key_data``'s layout).
  Under the partitionable layout, element i of a draw of shape ``shape``
  hashes the 64-bit counter i (its row-major index), split into its high
  and low 32 bits, and XORs the hash's two words; a split's i-th key is
  the hash of counter i itself, which is ``fold_in(key, i)``.
- ``uniform`` and ``bernoulli`` are bit-exact: 23 random mantissa bits
  under exponent 0 give [1, 2), minus 1, then ``x * (max - min) + min``,
  which XLA on the CPU contracts into one fused multiply-add (emulated in
  float64, rounded once to float32; a float32 product is exact in
  float64).
- ``normal`` and ``truncated_normal`` go through XLA's float32
  ``erf_inv`` (Giles' polynomial of degree 8 in w = -log1p(-x^2), which
  XLA also contracts into fused multiply-adds), and that through XLA's
  float32 ``log1p``, emulated here (``log1p32``) to within one ulp, so a
  draw may sit one ulp off JAX's (``tests/test_torch_jax_random.py``
  counts them).
- ``flax_param_key`` derives a flax parameter's key: flax folds the first
  four bytes (big-endian) of the SHA-1 of the parameter's scope path and
  its per-scope counter into the module key (``flax.core.scope.
  _fold_in_static``; flax's ``flax_fix_rng_separator`` flag off, its
  default, so no separator bytes).
"""

from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple

import numpy as np

_F32 = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block hash (20 rounds) of counters (x0, x1) under
    key (k0, k1), elementwise over broadcast uint32 arrays."""
    k0, k1, x0, x1 = (np.asarray(a, np.uint32) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` for 0 <= seed < 2**32."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return np.array([0, seed], np.uint32)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _hash(k: np.ndarray, hi: np.ndarray, lo: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Hash counters (hi, lo) (n,) under keys k (..., 2): (..., n) words."""
    k = np.asarray(k, np.uint32)
    return threefry2x32(k[..., 0, None], k[..., 1, None], hi, lo)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: (num, 2) keys, or (..., num, 2) for
    keys (..., 2) (JAX's ``vmap`` of ``split``)."""
    return np.stack(_hash(k, *_counters(num)), axis=-1)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)`` for 0 <= data < 2**32, of one key
    (2,) or of keys (..., 2)."""
    b0, b1 = _hash(k, np.zeros(1, np.uint32), np.full(1, data, np.uint32))
    return np.stack([b0[..., 0], b1[..., 0]], axis=-1)


def random_bits(k: np.ndarray, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.bits(k, shape)`` (uint32): (*shape) for one key (2,),
    (..., *shape) for keys (..., 2)."""
    shape = tuple(shape)
    b0, b1 = _hash(k, *_counters(math.prod(shape)))
    return (b0 ^ b1).reshape(np.shape(k)[:-1] + shape)


def fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as a fused multiply-add: the float32
    product is exact in float64, and the float64 sum is rounded to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(_F32)


def uniform(k: np.ndarray, shape: Sequence[int] = (), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``; the bounds
    may be arrays that broadcast against ``shape``."""
    lo, hi = np.asarray(minval, _F32), np.asarray(maxval, _F32)
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(_F32) - _F32(1.0)
    return np.maximum(lo, fma32(floats, hi - lo, lo))


def randint(k: np.ndarray, shape: Sequence[int], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32): two 32-bit
    draws a value, reduced modulo the span in uint32 arithmetic that wraps
    as XLA's does."""
    k1, k2 = split(k)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(1 if maxval <= minval else maxval - minval)
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = (mult * mult) % span
        offset = ((higher % span) * mult + lower % span) % span
    return (np.int32(minval) + offset.astype(np.int32)).astype(np.int32)


def bernoulli(k: np.ndarray, p: float = 0.5, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.bernoulli(k, p, shape)``."""
    return uniform(k, shape) < _F32(p)


# Giles' erfinv for float32, as XLA writes it: coefficients for w < 5, then w >= 5.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


# XLA's float32 log1p: Cephes' rational approximation where |x| < sqrt(2) - 1
# (coefficients highest degree first), else log(1 + x) by Cephes' logf as
# Eigen writes it (range reduction to [sqrt(1/2), sqrt(2)), a degree-8
# polynomial in three parts).
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
           -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _logf(v: np.ndarray) -> np.ndarray:
    v = np.maximum(v, np.finfo(_F32).tiny).astype(_F32)
    bits = v.view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 126).astype(_F32)
    x = ((bits & np.uint32(0x807FFFFF)) | _F32(0.5).view(np.uint32)).view(_F32)
    low = x < _F32(0.707106781186547524)
    x = (x - _F32(1.0) + np.where(low, x, _F32(0.0))).astype(_F32)
    e = (e - low.astype(_F32)).astype(_F32)
    x2 = (x * x).astype(_F32)
    x3 = (x2 * x).astype(_F32)
    p = [_F32(c) for c in _LOGF_P]
    y = fma32(fma32(p[0], x, p[1]), x, p[2])
    y1 = fma32(fma32(p[3], x, p[4]), x, p[5])
    y2 = fma32(fma32(p[6], x, p[7]), x, p[8])
    y = (fma32(fma32(y, x3, y1), x3, y2) * x3).astype(_F32)
    y = fma32(e, _F32(-2.12194440e-4), y)
    x = (fma32(_F32(-0.5), x2, x) + y).astype(_F32)
    return fma32(e, _F32(0.693359375), x)


def _horner(coefs, t: np.ndarray) -> np.ndarray:
    """float32 Horner evaluation of a polynomial (coefficients highest
    degree first) with each multiply-add fused."""
    t64 = t.astype(np.float64)
    p = np.full(t.shape, _F32(coefs[0]))
    for c in coefs[1:]:
        p = (p * t64 + np.float64(_F32(c))).astype(_F32)
    return p


def log1p32(v: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` on the CPU, its multiply-adds fused: exact
    on the rational branch, within one ulp of XLA's on the other."""
    v = np.asarray(v, _F32)
    out = np.empty_like(v)
    sm = np.abs(v) < _F32(0.41421356237309504880)
    x = v[sm]
    x2 = (x * x).astype(_F32)
    ratio = (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)).astype(_F32)
    out[sm] = (x + fma32(_F32(-0.5), x2, ((x * x2).astype(_F32) * ratio).astype(_F32))).astype(_F32)
    out[~sm] = _logf((v[~sm] + _F32(1.0)).astype(_F32))
    return out


def erf_inv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` on the CPU, its multiply-adds fused."""
    x = np.asarray(x, _F32)
    w = -log1p32(-(x * x).astype(_F32))
    p = np.empty_like(x)
    sm = w < _F32(5.0)
    p[sm] = _horner(_ERFINV_SMALL, (w[sm] - _F32(2.5)).astype(_F32))
    p[~sm] = _horner(_ERFINV_LARGE, (np.sqrt(w[~sm]) - _F32(3.0)).astype(_F32))
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(np.abs(x) == _F32(1.0), x * _F32(np.inf), p * x).astype(_F32)


_SQRT2 = _F32(np.sqrt(2.0))


def normal(k: np.ndarray, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.normal(k, shape)`` (float32), to XLA's ``log1p``."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0), dtype=_F32)
    return _SQRT2 * erf_inv32(uniform(k, shape, lo, _F32(1.0)))


def _erf32(x: float) -> np.float32:
    """float32 erf of a float32 bound: float64's, rounded once."""
    return _F32(math.erf(float(_F32(x))))


def truncated_normal(k: np.ndarray, lower: float, upper: float, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.truncated_normal(k, lower, upper, shape)`` (float32)."""
    lo, hi = _F32(lower), _F32(upper)
    a, b = _erf32(lo / _SQRT2), _erf32(hi / _SQRT2)
    out = _SQRT2 * erf_inv32(uniform(k, shape, a, b))
    return np.clip(out, np.nextafter(lo, _F32(np.inf)), np.nextafter(hi, _F32(-np.inf))).astype(_F32)


def flax_param_key(k: np.ndarray, path: Sequence[str], counter: int) -> np.ndarray:
    """The key flax's ``init`` draws a parameter from: ``k`` (the init's
    "params" key) folded with the SHA-1 of the submodule names on the
    parameter's scope path and the scope's parameter counter (1 for its
    first parameter)."""
    m = hashlib.sha1()
    for x in (*path, counter):
        m.update(x.encode("utf-8") if isinstance(x, str) else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(k, int.from_bytes(m.digest()[:4], "big"))


def lecun_normal(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """flax's default kernel initialiser: truncated normal in [-2, 2] times
    sqrt(1 / fan_in) / 0.87962566103423978 (each step in float32, as JAX
    computes it), fan_in the product of all but the last axis (flax's
    kernel layout: (..., in, out))."""
    std = np.sqrt(_F32(1.0 / math.prod(shape[:-1]))) / _F32(0.87962566103423978)
    return truncated_normal(k, -2.0, 2.0, shape) * std


def flax_init_params(tree: dict, k: np.ndarray) -> dict:
    """flax's default initialisation of a variable tree of Conv / Dense
    layers drawn from ``k`` (the key given to the module's ``init``):
    ``tree`` gives the layout ({"params": {module: {"kernel", "bias"}}},
    nested modules as nested dicts; the values only give shapes). Each
    kernel is ``lecun_normal`` from its scope's first parameter key, each
    bias zeros."""
    def walk(node, path):
        if "kernel" in node:
            if set(node) - {"kernel", "bias"}:
                raise ValueError(f"{'/'.join(path)}: only kernel and bias leaves are drawn, got {sorted(node)}")
            out = {"kernel": lecun_normal(flax_param_key(k, path, 1), np.shape(node["kernel"]))}
            if "bias" in node:
                out["bias"] = np.zeros(np.shape(node["bias"]), _F32)
            return out
        return {name: walk(sub, (*path, name)) for name, sub in node.items()}

    return {"params": walk(tree["params"], ())}
