"""Counter-based hash PRNG, bit-exact with the JAX package's
ops/pallas/wavernn_gen.py `_fmix32` / `_uniform` (a murmur3 finalizer over
(seed, step, salt, element index)).

The JAX version works in wrapping int32 arithmetic with logical right
shifts. Torch's `>>` on int32 is an arithmetic shift, so this version
emulates uint32 in int64 with `& 0xFFFFFFFF` after every step; each 32x32-bit
product is split in 16-bit halves so no int64 intermediate overflows. The
CUDA kernels carry the same hash as a device function on `uint32_t`
(csrc/hash_prng.cuh).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
C1 = 0x85EBCA6B
C2 = 0xC2B2AE35
GOLD = 0x9E3779B9


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a uint32 constant."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def fmix32(x):
    """murmur3 32-bit finalizer on int64 tensors holding uint32 values."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, C1)
    x = x ^ (x >> 13)
    x = _mul32(x, C2)
    return x ^ (x >> 16)


def step_key(seed: int, step: int) -> int:
    """Per-step key fmix32(seed + step * GOLD) as a uint32 Python int."""
    x = torch.tensor([(seed + step * GOLD) & MASK32], dtype=torch.int64)
    return int(fmix32(x)[0])


def uniform(shape: tuple[int, int], key: int, salt: int, device=None):
    """Uniform(0, 1) [rows, width], element (r, c) hashed from
    r * width + c — the JAX `_uniform` for a 2-D shape."""
    rows, width = shape
    lin = torch.arange(rows * width, dtype=torch.int64, device=device)
    x = fmix32(_mul32(lin, GOLD) + key + salt * 7919)
    mant = (x & 0xFFFFFF).to(torch.float32)
    return ((mant + 0.5) * (1.0 / 16777216.0)).reshape(rows, width)
