"""Counter-based random numbers bit-compatible with `jax.random` (threefry).

The JAX package draws its RANSAC hypotheses from `jax.random`
(frontend/tracker.py splits a key every tick, frontend/ransac.py and
init/relative_pose.py call `randint`, the estimator seeds `PRNGKey`).
Different draws give different inlier sets, so the port reproduces the
draws bit for bit: threefry2x32 with JAX's default "partitionable" bit
layout, written in int64 tensor ops masked to 32 bits.

Keys are int64 tensors of shape (2,) holding the two uint32 words of a
JAX key.  `randint` samples with `bits` random bits per value: 64 is what
`jax.random.randint` does with its default dtype under jax_enable_x64 (the
setting the JAX golden trace was produced with), 32 without x64.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Raw threefry key of a 64-bit integer seed (jax.random.PRNGKey)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64,
                        device=device)


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 hash (20 rounds) of the count pair (x1, x2) under the
    key (k1, k2); all int64 tensors of uint32 values, broadcasting."""
    ks = [k1, k2, k1 ^ k2 ^ 0x1BD11BDA]
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def _iota_2x32(shape, device):
    """(hi, lo) words of a row-major uint64 iota of `shape`."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _M32


def split(key, num: int = 2):
    """(num, 2) child keys (jax.random.split)."""
    hi, lo = _iota_2x32((num,), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def _bits_words(key, shape):
    hi, lo = _iota_2x32(shape, key.device)
    return threefry2x32(key[0], key[1], hi, lo)


def randint(key, shape, minval, maxval, bits: int = 64):
    """Uniform integers in [minval, maxval) exactly as jax.random.randint
    draws them (two words of random bits per value, modulus with the
    2**bits % span multiplier).  minval/maxval: python ints or 0-d tensors
    with maxval - minval < 2**31.  Returns int64."""
    if bits not in (32, 64):
        raise ValueError(f"bits must be 32 or 64, got {bits}")
    shape = tuple(int(d) for d in shape)
    dev = key.device
    minval = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    k = split(key)
    span = torch.where(maxval <= minval, torch.ones_like(maxval),
                       maxval - minval)

    def mod_span(words):
        hi, lo = words
        if bits == 32:
            return (hi ^ lo) % span
        # (hi·2³² + lo) mod span without leaving int64
        return ((hi % span) * ((1 << 32) % span) + lo % span) % span

    higher = mod_span(_bits_words(k[0], shape))
    lower = mod_span(_bits_words(k[1], shape))
    # JAX computes the products below in the unsigned type of the sample,
    # so with bits=32 they wrap at 2**32
    wrap = (lambda v: v & _M32) if bits == 32 else (lambda v: v)
    mult = (1 << (bits // 2)) % span
    mult = wrap(mult * mult) % span
    return minval + wrap(higher * mult + lower) % span
