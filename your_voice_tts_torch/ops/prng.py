"""Counter-based hash PRNG, bit-exact with the JAX package's
ops/pallas/wavernn_gen.py `_fmix32` / `_uniform` (a murmur3 finalizer over
(seed, step, salt, element index)).

The JAX version works in wrapping int32 arithmetic with logical right
shifts. Torch's `>>` on int32 is an arithmetic shift, so this version
emulates uint32 in int64 with `& 0xFFFFFFFF` after every step; each 32x32-bit
product is split in 16-bit halves so no int64 intermediate overflows. The
CUDA kernels carry the same hash as a device function on `uint32_t`
(csrc/hash_prng.cuh).

Inside a traced program (`infer/export.py`) the seed is a tensor: `seed_key`
makes the key from it on its device with no host round trip, and
`uniform`, `normal` and `gl_phase` take that key tensor where the kernels'
hosts pass an int.
"""

from __future__ import annotations

import math

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


def seed_key(seed, step: int = 0):
    """Per-step key fmix32(seed + step * GOLD) of a seed tensor (int64 [1]),
    computed in the graph: an int64 tensor [1] holding a uint32."""
    return fmix32((seed.to(torch.int64) + step * GOLD) & MASK32)


def step_key(seed: int, step: int) -> int:
    """`seed_key` of an int seed, as a uint32 Python int."""
    return int(seed_key(torch.tensor([seed & MASK32]), step)[0])


def uniform(shape: tuple[int, ...], key, salt: int, device=None):
    """Uniform(0, 1) of `shape`, each element hashed from its row-major
    index (for [rows, width]: r * width + c, the JAX `_uniform`). `key`: a
    uint32 int, or a `seed_key` tensor on `device`."""
    lin = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x = fmix32(_mul32(lin, GOLD) + key + salt * 7919)
    mant = (x & 0xFFFFFF).to(torch.float32)
    return ((mant + 0.5) * (1.0 / 16777216.0)).reshape(shape)


def normal(shape: tuple[int, ...], key, salts: tuple[int, int], device=None):
    """Standard normal of `shape` by Box-Muller over two `uniform` draws,
    one a salt (neither reaches 0 or 1)."""
    u1, u2 = (uniform(shape, key, s, device) for s in salts)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


# salts of the draws a traced serving program makes from its seed input (the
# decodes' prenet dropout keeps 11-12 and 21-22, the WaveRNN loop its own)
GL_PHASE_SALT = 31
NOISE_SALTS = (41, 42)
DROPOUT_SALT = 51


def gl_phase(T: int, n_freq: int, seed):
    """The Griffin-Lim initial phase [T, n_freq] from a seed tensor: 2 pi x
    `uniform`, one pattern every row of a batch shares."""
    return (2.0 * math.pi) * uniform((T, n_freq), seed_key(seed), GL_PHASE_SALT, seed.device)


class HashDraws:
    """Uniform draws keyed by a seed tensor, for `nn.core.dropout` in a
    traced program: each `rand` call takes the next salt from
    DROPOUT_SALT."""

    def __init__(self, seed):
        self.key, self.device, self.salt = seed_key(seed), seed.device, DROPOUT_SALT

    def rand(self, shape) -> torch.Tensor:
        self.salt += 1
        return uniform(tuple(shape), self.key, self.salt - 1, self.device)
