"""WaveRNN output distributions (the JAX package's vocoder/models/distribs.py):
the log-scale floor, the training losses of the mixture of logistics and
the Gaussian, and the sampling of the generation kernel.

The samplers follow the JAX package's kernel route
(ops/pallas/wavernn_gen.py `_sample_mulaw`, `_sample_mol`, `_sample_gauss`):
every random number comes from the counter hash of ops/prng.py keyed by
(seed, global sample step), so the plain version, the CUDA kernel and the
Pallas kernel draw the same numbers. Argmax takes the lowest index on ties.
"""

from __future__ import annotations

import math

import torch

from ...ops.prng import uniform
from ...ops.taco2_decode import softplus
from ...parallel.mesh import global_mean

# ln(1e-7): the reference clamps log-scales to keep exp(-log_s) finite in f32
LOG_SCALE_MIN = float(math.log(1e-7))


def discretized_mix_logistic_loss(y_hat, y, num_classes: int = 65536, reduce: bool = True):
    """Negative log-likelihood of y [...] in [-1, 1] under a discretized
    mixture of logistics y_hat [..., 3M] (mixture logits | means |
    log-scales, floored at LOG_SCALE_MIN): the PixelCNN++ formulation with
    num_classes bins (16-bit), the edge bins (y < -0.999, y > 0.999)
    integrating the whole tail, and a bin whose CDF difference is 1e-5 or
    less taking the log-density at its centre. The mean unless reduce is
    False."""
    M = y_hat.shape[-1] // 3
    logit_probs, means = y_hat[..., :M], y_hat[..., M:2 * M]
    log_scales = y_hat[..., 2 * M:3 * M].clamp_min(LOG_SCALE_MIN)
    yb = y[..., None]
    centered = yb - means
    inv_stdv = torch.exp(-log_scales)
    half_bin = 1.0 / (num_classes - 1)
    plus_in = inv_stdv * (centered + half_bin)
    min_in = inv_stdv * (centered - half_bin)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - softplus(plus_in)
    log_one_minus_cdf_min = -softplus(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * softplus(mid_in)
    inner = torch.where(cdf_delta > 1e-5, torch.log(cdf_delta.clamp_min(1e-12)),
                        log_pdf_mid - math.log((num_classes - 1) / 2.0))
    log_probs = torch.where(yb < -0.999, log_cdf_plus,
                            torch.where(yb > 0.999, log_one_minus_cdf_min, inner))
    nll = -torch.logsumexp(log_probs + torch.log_softmax(logit_probs, -1), -1)
    return global_mean(nll) if reduce else nll


def gaussian_loss(y_hat, y, reduce: bool = True):
    """Negative log-likelihood of y [...] under N(mu, sigma^2), y_hat
    [..., 2] = (mu, log sigma floored at LOG_SCALE_MIN). The mean unless
    reduce is False."""
    mu = y_hat[..., 0]
    log_s = y_hat[..., 1].clamp_min(LOG_SCALE_MIN)
    nll = 0.5 * math.log(2.0 * math.pi) + log_s + 0.5 * torch.exp(-2.0 * log_s) * (y - mu) ** 2
    return global_mean(nll) if reduce else nll


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
