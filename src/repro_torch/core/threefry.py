"""The reference's sampling noise: JAX's threefry2x32 PRNG on torch tensors.

The reference samples at ``temperature > 0`` with Gumbel noise drawn from
``jax.random`` (``launch/steps.py :: sample_tokens``). To give the same tokens
the port computes the same bits. This module is its own copy of what that
takes, written from the installed ``jax._src.prng`` and ``jax._src.random``
(jax 0.9.0, ``jax_threefry_partitionable`` on, ``jax_enable_x64`` off):

* :func:`threefry2x32`: the Threefry-2x32 block cipher, 20 rounds;
* :func:`prng_key`: ``jax.random.PRNGKey(seed)`` is ``(0, seed mod 2^32)``;
* :func:`fold_in`: ``threefry2x32(key, (0, data))``;
* :func:`random_bits`: 32-bit words of a key, the partitionable layout: word
  ``n`` is ``y1 ^ y2`` of ``threefry2x32(key, (n >> 32, n mod 2^32))``;
* :func:`uniform`: the top 23 bits as the mantissa of a float in ``[1, 2)``,
  minus 1, scaled into ``[minval, maxval)`` and clamped below at ``minval``;
* :func:`gumbel`: ``-log(-log(uniform(minval=tiny, maxval=1)))`` (jax's mode
  "low");
* :func:`split`: ``jax.random.split``, key ``i`` both words of
  ``threefry2x32(key, (i >> 32, i mod 2^32))``;
* :func:`categorical`: ``jax.random.categorical`` with replacement along the
  last axis, ``argmax(gumbel(key, logits.shape) + logits)`` (the Gumbel
  words indexed in row-major order over the logits' shape).

A key is an int64 tensor ``[..., 2]`` holding two 32-bit words: torch's
``uint32`` supports few operations, on CUDA especially, so every 32-bit word
lives in an int64 and is masked after each add and rotate. Every function
takes a batch of keys (leading axes) on any device; bits and uniforms are
the same on every device, the Gumbel noise up to the device's ``log``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: smallest normal fp32, jax's ``finfo(float32).tiny``
TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the count words ``(x1, x2)`` under the key ``(k1,
    k2)``; int64 tensors of 32-bit words that broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as the reference builds it (64-bit
    integers off): ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``[..., 2]`` and data (an int or an
    integer tensor broadcasting against the keys' leading axes, taken mod
    2^32) -> keys ``[..., 2]``."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``: keys ``[..., 2]`` -> 32-bit
    words ``[..., n]`` in int64."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None],
                          count >> 32, count & MASK)
    return y1 ^ y2


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: keys
    ``[..., 2]`` -> fp32 ``[..., n]``."""
    bits = random_bits(key, n)
    one = (bits >> 9) | 0x3F800000                 # a float in [1, 2)
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = bound(minval, key.device), bound(maxval, key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


@functools.lru_cache(maxsize=None)
def bound(value: float, device: torch.device) -> torch.Tensor:
    """``value`` as a 0-d fp32 tensor on ``device``, built once per (value,
    device) and never written: a copy from host memory, which a CUDA
    graph's capture refuses, happens at the first call only (a step's
    warm-up, before its capture)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` in mode "low": keys
    ``[..., 2]`` -> fp32 ``[..., n]``."""
    return -torch.log(-torch.log(uniform(key, n, minval=TINY, maxval=1.0)))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: keys ``[..., 2]`` -> ``[..., num,
    2]``."""
    count = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[..., 0, None], key[..., 1, None], count >> 32,
                          count & MASK)
    return torch.stack([y1, y2], dim=-1)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` (axis -1, with replacement,
    mode "low"): one key ``[2]``, fp32 logits ``[..., V]`` -> int32
    ``[...]``."""
    noise = gumbel(key, logits.numel()).reshape(logits.shape)
    return torch.argmax(noise + logits, dim=-1).to(torch.int32)
