"""WaveRNN output distributions (the JAX package's vocoder/models/distribs.py):
the log-scale floor and the sampling of the generation kernel.

The samplers follow the JAX package's kernel route
(ops/pallas/wavernn_gen.py `_sample_mulaw`, `_sample_mol`, `_sample_gauss`):
every random number comes from the counter hash of ops/prng.py keyed by
(seed, global sample step), so the plain version, the CUDA kernel and the
Pallas kernel draw the same numbers. Argmax takes the lowest index on ties.
The MoL and Gaussian losses come with WaveRNN training.
"""

from __future__ import annotations

import math

import torch

from ...ops.prng import uniform

# ln(1e-7): the reference clamps log-scales to keep exp(-log_s) finite in f32
LOG_SCALE_MIN = float(math.log(1e-7))


def _gumbel(shape, key: int, salt: int, device):
    return -torch.log(-torch.log(uniform(shape, key, salt, device)))


def mulaw_width(n_classes: int) -> int:
    """Width of the mu-law Gumbel draw: the class count rounded up to 128,
    the lane-padded logits the Pallas kernel draws for."""
    return -(-n_classes // 128) * 128


def sample_mulaw(logits, key: int, bits: int, greedy: bool):
    """logits [B, 2**bits] -> (next RNN input, emitted sample), both [B]:
    the input is the LINEAR class value 2 cls / mu - 1 (the training
    encoding), the sample its mu-law decoding, exp(.) - 1 as the kernel
    computes it (not expm1), clipped to [-1, 1]."""
    B, n = logits.shape
    if greedy:
        cls = torch.argmax(logits, -1)
    else:
        g = _gumbel((B, mulaw_width(n)), key, 0, logits.device)[:, :n]
        cls = torch.argmax(logits + g, -1)
    mu = float(2 ** bits - 1)
    log1p_mu = float(math.log1p(mu))
    f = 2.0 * cls.float() / mu - 1.0
    return f, torch.clamp(torch.sign(f) * (torch.exp(f.abs() * log1p_mu) - 1.0) / mu, -1.0, 1.0)


def _pick(x, idx):
    return x.gather(1, idx[:, None])[:, 0]


def sample_mol(logits, key: int, num_mixtures: int, greedy: bool):
    """Mixture of logistics, logits [B, >= 3M] (mixture logits | means |
    log-scales) -> sample [B]: Gumbel-argmax mixture (hash salt 1), then
    the logistic inverse CDF at u (salt 2) clipped to [1e-5, 1 - 1e-5];
    greedy takes the most probable mixture's mean."""
    M = num_mixtures
    lp, means = logits[:, :M], logits[:, M:2 * M]
    log_s = torch.clamp_min(logits[:, 2 * M:3 * M], LOG_SCALE_MIN)
    if greedy:
        return torch.clamp(_pick(means, torch.argmax(lp, -1)), -1.0, 1.0)
    idx = torch.argmax(lp + _gumbel(lp.shape, key, 1, lp.device), -1)
    u = torch.clamp(_pick(uniform(lp.shape, key, 2, lp.device), idx), 1e-5, 1.0 - 1e-5)
    x = _pick(means, idx) + torch.exp(_pick(log_s, idx)) * (torch.log(u) - torch.log1p(-u))
    return torch.clamp(x, -1.0, 1.0)


def sample_gauss(logits, key: int, greedy: bool):
    """Gaussian, logits [B, >= 2] (mean | log-scale) -> sample [B]:
    Box-Muller from two uniforms (salts 3 and 4); greedy takes the mean."""
    mu = logits[:, 0]
    if greedy:
        return torch.clamp(mu, -1.0, 1.0)
    log_s = torch.clamp_min(logits[:, 1], LOG_SCALE_MIN)
    B = logits.shape[0]
    u1 = uniform((B, 1), key, 3, logits.device)[:, 0]
    u2 = uniform((B, 1), key, 4, logits.device)[:, 0]
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return torch.clamp(mu + torch.exp(log_s) * z, -1.0, 1.0)
