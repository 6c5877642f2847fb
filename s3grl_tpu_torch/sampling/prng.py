"""``jax.random``'s float32 uniforms, bit for bit, in torch integer ops.

The JAX package draws each link's per-hop sampling priorities as
``jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), hop), (N,))``
(``s3grl_tpu/sampling/extraction.py``, ``_bfs_distances``). With the
threefry PRNG and ``jax_threefry_partitionable`` on, that is:

- ``PRNGKey(s)`` = ``(0, s mod 2^32)``;
- ``fold_in(k, d)`` = ``threefry2x32(k, (0, d))``;
- the uniform at index i: the bits ``b0 ^ b1`` of
  ``threefry2x32(k, (0, i))``, then ``(bits >> 9) | 0x3F800000`` read as a
  float32, minus 1.

Every value here is an int64 tensor holding a 32-bit word, masked after
each add and shift, so the CPU and the card give the same bits. The uniform
at node i depends on (seed, hop, i) alone, so :func:`uniforms` is evaluated
only where a caller needs it.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # threefry's key-schedule constant
_ONE_F32_BITS = 0x3F800000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (JAX's ``threefry_2x32``) on 32-bit words
    held in int64 tensors that broadcast together; returns (y0, y1)."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK32
    x1 = (x1 + k1) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def prng_key(seeds: torch.Tensor):
    """``jax.random.PRNGKey`` of each integer seed: (0, seed mod 2^32)."""
    s = seeds.to(torch.int64) & _MASK32
    return torch.zeros_like(s), s


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)`` for a non-negative int ``data``."""
    k0, k1 = key
    return threefry2x32(k0, k1, torch.zeros_like(k0), torch.full_like(k0, data & _MASK32))


def uniforms(link_seeds: torch.Tensor, hop: int, node_ids: torch.Tensor) -> torch.Tensor:
    """[B, M] float32: entry (b, j) is element ``node_ids[b, j]`` of
    ``jax.random.uniform(fold_in(PRNGKey(link_seeds[b]), hop), (N,))``.

    ``link_seeds`` is [B] and ``node_ids`` [B, M] (any N above the largest
    id gives the same values); both on one device.
    """
    k0, k1 = fold_in(prng_key(link_seeds), hop)
    i = node_ids.to(torch.int64) & _MASK32
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(i), i)
    bits = ((b0 ^ b1) >> 9) | _ONE_F32_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0
