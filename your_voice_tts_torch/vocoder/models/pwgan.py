"""Parallel WaveGAN generator (the JAX package's vocoder/models/pwgan.py).

A non-autoregressive WaveNet: Gaussian noise at the sample rate in, a stack
of gated dilated-conv residual blocks conditioned on the upsampled mel, a
skip-sum head. Same serving shape as MelGAN: mel [B, T, n_mels] -> audio
[B, T * hop]. The JAX package has no Pallas kernel here (cuDNN convolutions
on the card). torch cannot reproduce the JAX package's `jax.random.normal`
noise, so `forward` takes the noise injected, or draws it from an explicit
torch.Generator. `ParallelWaveganDiscriminator` is what vocoder/train_gan.py
trains it against.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ... import resolve_device
from ...nn.core import Conv1d, init_convs_
from .wavernn import _stretch


class PWGANResBlock(nn.Module):
    """Dilated conv + 1x1 mel conditioning -> tanh(first half) *
    sigmoid(second half) -> 1x1 residual (scaled by sqrt(1/2)) and skip."""

    def __init__(self, residual_ch: int, gate_ch: int, skip_ch: int, aux_ch: int,
                 kernel_size: int, dilation: int):
        super().__init__()
        self.half = gate_ch // 2
        self.conv = Conv1d(residual_ch, gate_ch, kernel_size, dilation=dilation)
        self.cond = Conv1d(aux_ch, gate_ch, 1, use_bias=False)
        self.res = Conv1d(self.half, residual_ch, 1)
        self.skip = Conv1d(self.half, skip_ch, 1)

    def forward(self, x, c):
        h = self.conv(x) + self.cond(c)
        z = torch.tanh(h[..., : self.half]) * torch.sigmoid(h[..., self.half:])
        return (x + self.res(z)) * (0.5 ** 0.5), self.skip(z)


class ParallelWaveganGenerator(nn.Module):
    def __init__(self, n_mels: int = 80, num_layers: int = 30, stacks: int = 3,
                 residual_ch: int = 64, gate_ch: int = 128, skip_ch: int = 64,
                 kernel_size: int = 3, upsample_factors=(4, 4, 4, 4),
                 aux_context_window: int = 0, device=None, seed: int = 0):
        """Seeded random weights (xavier-uniform, zero biases; the upsample
        convs start as averaging filters, as the JAX package's) until a
        checkpoint is loaded; on `device`, CUDA unless given."""
        super().__init__()
        self.n_mels = n_mels
        self.factors = tuple(upsample_factors)
        self.hop = math.prod(self.factors)
        self.aux_context_window = aux_context_window
        if aux_context_window > 0:
            # the mel's context frames each side, edge-padded so T is kept
            self.aux_conv = Conv1d(n_mels, n_mels, 2 * aux_context_window + 1,
                                   padding="valid", use_bias=False)
        self.up = nn.ModuleList(Conv1d(n_mels, n_mels, 2 * f + 1, use_bias=False)
                                for f in self.factors)
        self.conv_in = Conv1d(1, residual_ch, 1)
        per_stack = num_layers // stacks
        self.blocks = nn.ModuleList(
            PWGANResBlock(residual_ch, gate_ch, skip_ch, n_mels, kernel_size,
                          2 ** (i % per_stack)) for i in range(num_layers))
        self.out1 = Conv1d(skip_ch, skip_ch, 1, init_gain="relu")
        self.out2 = Conv1d(skip_ch, 1, 1)
        self.skip_scale = 1.0 / math.sqrt(num_layers)
        init_convs_(self, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            for conv in self.up:
                k = conv.weight.shape[-1]
                conv.weight.copy_(torch.eye(n_mels)[:, :, None].expand(-1, -1, k) / k)
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.conv_in.weight.device

    def upsample(self, mel):
        """mel [B, T, n_mels] -> conditioning [B, T * hop, n_mels]."""
        c = mel
        if self.aux_context_window > 0:
            w = self.aux_context_window
            c = self.aux_conv(F.pad(c.transpose(1, 2), (w, w), mode="replicate").transpose(1, 2))
        for conv, f in zip(self.up, self.factors):
            c = conv(_stretch(c, f))
        return c

    def forward(self, mel, noise=None, generator: torch.Generator | None = None):
        """mel [B, T, n_mels] -> audio [B, T * hop]. noise [B, T * hop] is
        the input at the sample rate; without it, standard normal noise is
        drawn from `generator` (on its device, then moved to the mel's),
        a generator seeded 0 when none is given."""
        c = self.upsample(mel)
        B, L, _ = c.shape
        if noise is None:
            generator = generator or torch.Generator().manual_seed(0)
            noise = torch.randn(B, L, generator=generator, device=generator.device)
        x = self.conv_in(noise.to(device=c.device, dtype=c.dtype)[..., None])
        skips = 0.0
        for block in self.blocks:
            x, s = block(x, c)
            skips = skips + s
        h = F.relu(skips * self.skip_scale)
        return self.out2(F.relu(self.out1(h)))[..., 0]


class ParallelWaveganDiscriminator(nn.Module):
    """num_layers - 1 dilated convs (dilation max(1, i), "same" padding,
    leaky ReLU 0.2 after each), then a conv to a per-sample score. Seeded
    random weights until a checkpoint is loaded; on `device`, CUDA unless
    given."""

    def __init__(self, num_layers: int = 10, channels: int = 64, kernel_size: int = 3,
                 device=None, seed: int = 1):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(1 if i == 0 else channels, channels, kernel_size, dilation=max(1, i),
                   init_gain="relu") for i in range(num_layers - 1))
        self.out = Conv1d(channels if num_layers > 1 else 1, 1, kernel_size)
        init_convs_(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, x):
        """x [B, T] -> (score [B, T, 1], [each conv's output])."""
        feats, h = [], x[..., None]
        for conv in self.convs:
            h = F.leaky_relu(conv(h), 0.2)
            feats.append(h)
        return self.out(h), feats
