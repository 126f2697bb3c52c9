"""Threefry-2x32 streams equal to ``jax.random``'s, in PyTorch.

The reference's samplers draw from ``jax.random`` with its default threefry
PRNG: ``jax.random.key(seed)``, ``fold_in``, ``uniform``, ``gumbel`` and
``categorical``. This module computes the same functions on torch tensors,
so a port stream equals the reference's for the same seed, request id and
token index: keys, random bits and uniforms bit for bit; gumbel noise up to
the last bit of ``log``, which differs between the frameworks' math
libraries.

Representation. A key is a ``(..., 2)`` int64 tensor holding two uint32
words. torch cannot add ``uint32`` tensors, so every word lives in an int64,
each sum is masked with ``& 0xFFFFFFFF`` and a rotation shifts a masked
value, which leaves no sign bit to smear. This is exact on the CPU and on
CUDA. Every function is batched over the key's leading dimensions (one key
a row) and is a pure function of its arguments: there is no global state.

Random bits follow JAX's partitionable mode (``jax_threefry_partitionable``,
the default since JAX 0.5): element ``i`` of a draw of shape ``S`` hashes
the 64-bit linear index ``i`` as the counter pair ``(i >> 32, i & mask)``,
and its bits are the xor of the two output words.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32 constants of jax.random: the smallest normal (gumbel's lower
# bound) and the bit pattern of 1.0
_TINY = float(np.finfo(np.float32).tiny)
_ONE_BITS = 0x3F800000


def threefry2x32(
    k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash, 20 rounds with the key schedule, on int64
    tensors of uint32 values (broadcast together). Returns the two output
    words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            a &= MASK
            hi = b >> (32 - r)
            b = b << r
            b &= MASK
            b |= hi
            b ^= a
        a = a + ks[(i + 1) % 3]
        a &= MASK
        b = b + ks[(i + 2) % 3]
        b += i + 1
        b &= MASK
    return a, b


def seed_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)``'s data, ``[seed >> 32, seed & mask]``, for
    a seed as JAX reads it without x64 (the reference's mode): a 32-bit
    integer, so the high word is 0."""
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` for a batch: ``key`` (..., 2) and integer
    ``data`` broadcast together; -1 folds in as 0xFFFFFFFF, as JAX's uint32
    cast of it."""
    data = data.to(torch.int64) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` for every key of ``key``
    (..., 2): a ``key.shape[:-1] + shape`` int64 tensor of uint32 values."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    idx = idx.reshape(shape)
    tail = (1,) * len(shape)
    k1 = key[..., 0].reshape(key.shape[:-1] + tail)
    k2 = key[..., 1].reshape(key.shape[:-1] + tail)
    y1, y2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return y1 ^ y2


def uniform(
    key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled to [minval, maxval). XLA fuses the
    scaling into one multiply-add, rounded once: the float64 product of two
    float32 values is exact, so one rounding of the float64 sum gives it."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    out = (floats.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in its default mode "low", float32:
    ``-log(-log(u))`` for u uniform on [tiny, 1)."""
    u = uniform(key, shape, _TINY, 1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: the argmax of gumbel
    noise plus ``logits`` (first index on ties). ``key`` (..., 2) keys the
    leading ``key.ndim - 1`` axes of ``logits``; the noise of each key spans
    the remaining axes, indexed by their linear index, as one JAX call."""
    noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits, dim=-1)
