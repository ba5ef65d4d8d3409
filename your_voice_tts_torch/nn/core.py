"""Core layers, channel-last like the JAX package's nn/core.py.

Activations are [B, ..., C]. Weights use PyTorch's own layouts (Linear
[out, in], Conv1d [out, in, k]); train/checkpoint.params_from_jax converts the
JAX package's layouts into them. Dense and Embedding are torch's own
nn.Linear and nn.Embedding, and LayerNorm is torch's nn.LayerNorm.
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
    """Channel-last 1D convolution [B, T, C_in] -> [B, T', C_out], padded as
    the JAX package's Conv1d: "same" keeps T at stride 1 (dilation d pads
    d * (k - 1) in all, the odd one on the right), "valid" pads nothing, an
    int pads both sides by it. pad_mode "reflect" mirrors the input instead
    of zero-filling it (the MelGAN family's choice). stride and groups as
    the JAX Conv1d's (`feature_group_count`): its weight [k, in / groups,
    out] is torch's [out, in / groups, k], which the checkpoint bridge maps
    as any Conv1d's. init_gain names the nonlinearity whose gain the owning
    model's xavier init uses."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 use_bias: bool = True, padding: str | int = "same", dilation: int = 1,
                 pad_mode: str = "zeros", init_gain: str = "linear", stride: int = 1,
                 groups: int = 1):
        super().__init__()
        if pad_mode not in ("zeros", "reflect"):
            raise ValueError(f"pad_mode must be zeros or reflect, got {pad_mode!r}")
        if in_dim % groups or out_dim % groups:
            raise ValueError(f"groups {groups} must divide in {in_dim} and out {out_dim}")
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None
        self.dilation, self.pad_mode, self.gain = dilation, pad_mode, GAINS[init_gain]
        self.stride, self.groups = stride, groups
        if padding == "same":
            total = dilation * (kernel_size - 1)
            self.pad = (total // 2, total - total // 2)
        elif padding == "valid":
            self.pad = (0, 0)
        else:
            self.pad = (int(padding), int(padding))

    def forward(self, x):
        mode = "reflect" if self.pad_mode == "reflect" and self.pad != (0, 0) else "constant"
        x = F.pad(x.transpose(1, 2), self.pad, mode=mode)
        return F.conv1d(x, self.weight, self.bias, stride=self.stride, dilation=self.dilation,
                        groups=self.groups).transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """Channel-last transposed 1D convolution [B, T, C_in] -> [B, T * stride,
    C_out], the MelGAN upsampler's (the JAX package's ConvTranspose1d):
    padding stride // 2 + stride % 2 and output_padding stride % 2, for even
    and odd strides. The weight is torch's [in, out, k]; the JAX package's
    is [k, in, out] with the kernel axis flipped (`jax_layout` tells
    train/checkpoint.params_from_jax so). A bf16 convolution of CPU tensors
    sums in float32 and rounds once, as cuDNN's bf16 convolution
    accumulates: oneDNN's bf16 transposed convolution on the CPU returns a
    wrong input gradient at some shapes (16 -> 8 channels over 32 steps at
    stride 4, a narrow MelGAN's second upsampler), which mixed-precision
    GAN training reaches."""

    jax_layout = "conv_transpose"

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, stride: int,
                 use_bias: bool = True, init_gain: str = "linear"):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_dim, out_dim, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None
        self.stride, self.gain = stride, GAINS[init_gain]

    def forward(self, x):
        u = self.stride
        w, b = self.weight, self.bias
        cpu_bf16 = x.device.type == "cpu" and x.dtype == torch.bfloat16
        if cpu_bf16:
            x, w, b = x.float(), w.float(), None if b is None else b.float()
        y = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=u, padding=u // 2 + u % 2,
                               output_padding=u % 2).transpose(1, 2)
        return y.to(torch.bfloat16) if cpu_bf16 else y


class LayerNorm(nn.LayerNorm):
    """Per-position LayerNorm over the channel (last) axis, the JAX
    package's: (x - mean) * rsqrt(var + eps) * scale + bias with the biased
    variance, eps 1e-5, no running statistics (train and eval are the same
    math). torch's nn.LayerNorm computes exactly this; its ``weight`` and
    ``bias`` are the JAX ``scale`` and ``bias`` leaves
    (train/checkpoint.params_from_jax maps them)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)


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


def init_convs_(model: nn.Module, generator: torch.Generator) -> None:
    """Xavier-uniform weights at each convolution's own `gain` and zero
    biases, for every Conv1d and ConvTranspose1d of `model` in module
    order."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv1d, ConvTranspose1d)):
                xavier_uniform_(m.weight, m.gain, generator)
                if m.bias is not None:
                    m.bias.zero_()


def dropout(x, rate: float, generator):
    """Inverted dropout drawn from `generator` (a torch.Generator on x's
    device, or an `ops.prng.HashDraws` in a traced program); the identity
    when no generator is given, as the JAX package skips it for rng=None."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = (torch.rand(x.shape, generator=generator, device=x.device)
         if isinstance(generator, torch.Generator) else generator.rand(x.shape))
    m = u < keep
    return torch.where(m, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def xavier_uniform_(w: torch.Tensor, gain: float, generator: torch.Generator):
    """Xavier-uniform init of a Linear [out, in], Conv1d [out, in, k] or
    ConvTranspose1d [in, out, k] weight, drawn from `generator` (JAX package
    nn/core.xavier_uniform)."""
    rf = w.shape[2] if w.dim() == 3 else 1
    fan_out, fan_in = w.shape[0] * rf, w.shape[1] * rf
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-a, a, generator=generator)
