"""Threefry-2x32 in PyTorch, bit-exact with ``jax.random`` for the three
calls the engine's seeded sampling makes: ``PRNGKey(seed)``,
``fold_in(key, position)`` and the scalar float32 ``uniform(key)``.

Seeded streams are keyed by ``uniform(fold_in(PRNGKey(seed), pos))`` in
the reference engine, so a port that serves the same streams needs JAX's
exact bits. Those depend on the ``jax_threefry_partitionable`` flag (on by
default in newer jax, off in older releases): the scalar uniform draws
the hash of counter (0, 0) under the key and keeps ``y0 ^ y1`` when the
flag is on and ``y0`` when it is off; key derivation and ``fold_in`` do
not depend on it. ``partitionable`` selects the mode.

All arithmetic runs on int64 tensors masked to 32 bits (PyTorch on the CPU
has no right shift for uint32), vectorized over rows, on the tensors'
device — no host sync.
"""
from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters (x1, x2) under key
    (k1, k2); every argument an int64 tensor of 32-bit values (they
    broadcast). Returns (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x1, x2


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` as a (hi, lo) pair of Python ints
    (seeds are 32-bit integers, as the reference without x64)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return 0, seed & _M


def fold_in(key, data):
    """``jax.random.fold_in`` row-wise: key (..., 2) int64, data (...)
    integer -> (..., 2) int64."""
    d = data.to(torch.int64) & _M
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def uniform(key, partitionable: bool = True):
    """Scalar float32 ``jax.random.uniform(key)`` row-wise: key (..., 2)
    int64 -> (...) float32 in [0, 1)."""
    zero = torch.zeros_like(key[..., 0])
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], zero, zero)
    bits = (y1 ^ y2) if partitionable else y1
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)
