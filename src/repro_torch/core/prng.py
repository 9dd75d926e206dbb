"""Counter-based random numbers: the parts of ``jax.random`` the JAX package
calls, equal to them bit for bit.

JAX's default generator is threefry-2x32 (Salmon et al. 2011, 20 rounds)
with partitionable bits (``jax_threefry_partitionable``, on by default
since JAX 0.5):

  * a key is two 32-bit words; ``PRNGKey(seed)`` is ``(0, seed mod 2^32)``;
  * ``fold_in(key, d)`` and ``split(key, n)[i]`` both hash the 64-bit
    counter ``(0, d)`` (resp. ``(0, i)``) under the key and keep both words;
  * ``random_bits(key, shape)`` hashes the row-major index of every element
    (high word, low word) and returns the xor of the two output words;
  * ``uniform`` puts 23 of those bits into the mantissa of a float in
    [1, 2) and subtracts 1; ``normal`` is ``sqrt(2) * erf_inv(u)`` with u
    uniform on (nextafter(-1, 0), 1).

Keys here are int64 tensors of shape (..., 2) holding the two uint32 words
(``as_key`` also takes a JAX key as a numpy uint32 array).  Every function
takes a leading batch of keys and draws ``batch + shape``, so one call
draws a round's noise window for every slot.  Work runs on the key's
device.  The words are hashed in int32 tensors: two's-complement addition
wraps as uint32 addition does, and the rotations mask away the sign bits an
arithmetic right shift brings in.

``erf_inv`` is XLA's float32 polynomial (Giles' single-precision
approximation), not ``torch.erfinv``, whose float32 results are up to 63
ulps from XLA's.  XLA's ``log1p`` is its own, so ``normal`` is within a
few ulps of ``jax.random.normal`` (``NORMAL_ULPS``) rather than equal.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA  # the threefry key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# the largest distance, in float32 ulps, of ``normal`` from
# ``jax.random.normal`` on the same key, and of the card's draws from the
# CPU's (tests/test_torch_prng.py measures it)
NORMAL_ULPS = 4

# XLA's float32 erf_inv: coefficients for w < 5 and for w >= 5, highest first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def as_key(key, device=None) -> torch.Tensor:
    """A key (or a batch of keys, shape (..., 2)) as the int64 tensor of its
    two uint32 words; takes tensors, numpy arrays (a JAX key as
    ``np.asarray(key)``) and sequences."""
    if isinstance(key, torch.Tensor):
        k = key.to(device=device, dtype=torch.int64)
    else:
        k = torch.from_numpy(np.asarray(key).astype(np.int64)).to(device)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key has 2 words on its last axis, got shape {tuple(k.shape)}")
    return k


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)``: the words (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & _MASK32], dtype=torch.int64, device=device)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 -> the same bits in int32."""
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value in int64."""
    return x.to(torch.int64) & _MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter words (x0, x1) under the key words
    (k0, k1), all int32 and broadcast together; returns the two words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = torch.broadcast_tensors(x0 + k0, x1 + k1)
    x0, x1 = x0.clone(), x1.clone()
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 += x1
            x1 = _rotl(x1, r)
            x1 ^= x0
        x0 += ks[(block + 1) % 3]
        x1 += ks[(block + 2) % 3] + (block + 1)
    return x0, x1


def _key_words(key: torch.Tensor, n_trailing: int):
    """The key's two int32 words with ``n_trailing`` unit axes appended,
    to broadcast against a draw of that many dims."""
    k = _i32(as_key(key))
    shape = tuple(k.shape[:-1]) + (1,) * n_trailing
    return k[..., 0].reshape(shape), k[..., 1].reshape(shape)


def _hash_counter(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Hash the counter (0, data) under each key: keys (..., 2), data
    broadcastable to their batch; returns keys (..., 2)."""
    key = as_key(key)
    k0, k1 = _key_words(key, 0)
    x1 = _i32(torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK32)
    h0, h1 = _threefry(k0, k1, torch.zeros_like(x1), x1)
    return torch.stack([_u32(h0), _u32(h1)], dim=-1)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: a batch of keys (..., 2) and ``data`` (an int,
    or an integer tensor broadcastable to the batch, taken mod 2^32)."""
    return _hash_counter(key, data)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys (..., 2) -> (..., num, 2)."""
    key = as_key(key)
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    return _hash_counter(key[..., None, :], idx)


def _bits32(key, shape) -> torch.Tensor:
    """The 32-bit draw of ``random_bits`` as int32 bits, shape
    batch + shape."""
    key = as_key(key)
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise NotImplementedError("draws of 2^32 elements or more")
    k0, k1 = _key_words(key, len(shape))
    lo = _i32(torch.arange(n, dtype=torch.int64, device=key.device)).reshape(shape)
    h0, h1 = _threefry(k0, k1, torch.zeros_like(lo), lo)
    return h0 ^ h1


def random_bits(key, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): uint32 values in int64, shape
    batch + shape."""
    return _u32(_bits32(key, shape))


def uniform(key, shape=(), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: batch + shape draws on
    [minval, maxval)."""
    bits = _bits32(key, shape)
    floats = (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0
    # the bounds as float32 values, held in Python floats: no tensor is
    # copied to the device, so a draw never waits on it
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA contracts floats * (hi - lo) + lo into one FMA; in float64 the
    # float32 product is exact, so the sum rounds to float32 as the FMA does
    scaled = (floats.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp(scaled, min=float(lo))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: a degree-8 polynomial in w - 2.5 (w < 5) or
    sqrt(w) - 3 (w >= 5), w = -log1p(-x^2), times x; +-inf at +-1."""
    w = -torch.log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):  # filled on the device: no host tensor copied over
        return torch.full_like(w, _ERFINV_GE5[i]).masked_fill_(small, _ERFINV_LT5[i])

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32, within ``NORMAL_ULPS`` of it:
    batch + shape draws."""
    return erf_inv(uniform(key, shape, _NORMAL_LO, 1.0)) * _SQRT2
