"""Core layers, channel-last like the JAX package's nn/core.py.

Activations are [B, ..., C]. Weights use PyTorch's own layouts (Linear
[out, in], Conv1d [out, in, k]); train/checkpoint.params_from_jax converts the
JAX package's layouts into them. Dense and Embedding are torch's own
nn.Linear and nn.Embedding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

Dense = nn.Linear
Embedding = nn.Embedding

GAINS = {"linear": 1.0, "relu": math.sqrt(2.0), "tanh": 5.0 / 3.0}


class Conv1d(nn.Module):
    """Channel-last 1D convolution [B, T, C_in] -> [B, T', C_out], stride 1,
    zero padding as the JAX package's Conv1d: "same" keeps T, "valid" pads
    nothing, an int pads both sides by it."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 use_bias: bool = True, padding: str | int = "same"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None
        if padding == "same":
            total = kernel_size - 1
            self.pad = (total // 2, total - total // 2)
        elif padding == "valid":
            self.pad = (0, 0)
        else:
            self.pad = (int(padding), int(padding))

    def forward(self, x):
        x = F.pad(x.transpose(1, 2), self.pad)
        return F.conv1d(x, self.weight, self.bias).transpose(1, 2)


class BatchNorm1d(nn.Module):
    """BatchNorm over the last (channel) axis, the JAX package's op order:
    (x - mean) * rsqrt(var + eps) * scale + bias, in the activation dtype.

    In training mode the statistics are the batch's, in float32, over every
    axis but the last and only where `mask` ([B, T] bool) is true; the
    running statistics then move by `momentum` towards them. The running
    variance takes the BIASED batch variance (divided by the count), as the
    JAX package does; torch.nn.BatchNorm1d would take the unbiased one. In
    eval mode the running statistics normalize."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x, mask=None):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            xs = x.float()
            axes = tuple(range(x.dim() - 1))
            if mask is None:
                mean = xs.mean(axes)
                var = xs.var(axes, unbiased=False)
            else:
                m = mask[..., None].float()
                cnt = m.sum().clamp_min(1.0)
                mean = (xs * m).sum(axes) / cnt
                var = (((xs - mean) ** 2) * m).sum(axes) / cnt
            with torch.no_grad():
                mo = self.momentum
                self.running_mean.copy_((1 - mo) * self.running_mean + mo * mean)
                self.running_var.copy_((1 - mo) * self.running_var + mo * var)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def dropout(x, rate: float, generator: torch.Generator | None):
    """Inverted dropout drawn from `generator` (on x's device); the identity
    when no generator is given, as the JAX package skips it for rng=None."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    m = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def xavier_uniform_(w: torch.Tensor, gain: float, generator: torch.Generator):
    """Xavier-uniform init of a Linear [out, in] or Conv1d [out, in, k]
    weight, drawn from `generator` (JAX package nn/core.xavier_uniform)."""
    rf = w.shape[2] if w.dim() == 3 else 1
    fan_out, fan_in = w.shape[0] * rf, w.shape[1] * rf
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-a, a, generator=generator)
