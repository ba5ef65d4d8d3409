"""MelGAN generator (the JAX package's vocoder/models/melgan.py), the
vocoder of BASELINE config #2.

conv7 -> for each upsample factor u: a transposed conv (kernel 2u, stride
u) and a stack of residual blocks with dilations 3^i -> conv7 -> tanh.
One feed-forward pass: mel [B, T, n_mels] -> audio [B, T * hop]. The JAX
package has no Pallas kernel here, so the convolutions are cuDNN's on the
card, the discriminators' too (`MelganDiscriminator`,
`MelganMultiscaleDiscriminator`, which vocoder/train_gan.py trains
against).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ... import resolve_device
from ...nn.core import Conv1d, ConvTranspose1d, init_convs_


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualStack(nn.Module):
    """num_blocks dilated residual blocks (dilation kernel_size^i), each
    x = shortcut(x) + c2(lrelu(c1(lrelu(x)))) with reflection padding and a
    learned 1x1 shortcut."""

    def __init__(self, channels: int, num_blocks: int = 3, kernel_size: int = 3):
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.ModuleDict({
                "c1": Conv1d(channels, channels, kernel_size, dilation=kernel_size ** i,
                             pad_mode="reflect", init_gain="relu"),
                "c2": Conv1d(channels, channels, 1),
                "sc": Conv1d(channels, channels, 1)})
            for i in range(num_blocks))

    def forward(self, x):
        for b in self.blocks:
            x = b["sc"](x) + b["c2"](_lrelu(b["c1"](_lrelu(x))))
        return x


class MelganUp(nn.Module):
    """One upsampling stage: a transposed conv, then a residual stack."""

    def __init__(self, channels: int, factor: int, num_res_blocks: int):
        super().__init__()
        self.up = ConvTranspose1d(channels, channels // 2, 2 * factor, factor, init_gain="relu")
        self.res = ResidualStack(channels // 2, num_res_blocks)

    def forward(self, x):
        return self.res(self.up(_lrelu(x)))


class MelganGenerator(nn.Module):
    def __init__(self, n_mels: int = 80, upsample_factors=(8, 8, 2, 2),
                 base_channels: int = 512, num_res_blocks: int = 3, kernel_size: int = 7,
                 device=None, seed: int = 0):
        """Seeded random weights (xavier-uniform at each layer's gain, zero
        biases) until a checkpoint is loaded; on `device`, CUDA unless
        given."""
        super().__init__()
        self.n_mels = n_mels
        self.hop = math.prod(upsample_factors)
        self.conv_in = Conv1d(n_mels, base_channels, kernel_size, pad_mode="reflect")
        ups, ch = [], base_channels
        for u in upsample_factors:
            ups.append(MelganUp(ch, u, num_res_blocks))
            ch //= 2
        self.ups = nn.ModuleList(ups)
        self.conv_out = Conv1d(ch, 1, kernel_size, pad_mode="reflect", init_gain="tanh")
        init_convs_(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.conv_in.weight.device

    def forward(self, mel):
        """mel [B, T, n_mels] -> audio [B, T * hop]."""
        x = self.conv_in(mel)
        for up in self.ups:
            x = up(x)
        return torch.tanh(self.conv_out(_lrelu(x)))[..., 0]


class MelganDiscriminator(nn.Module):
    """One scale: a strided conv stack, leaky ReLU 0.2 after each conv,
    then a 3-tap conv to a score. The downsampling convs are grouped
    (groups = in // 4), as the reference's."""

    LAYERS = ((1, 15, 1), (4, 41, 4), (16, 41, 4), (64, 41, 4), (64, 5, 1))  # (mult, k, stride)

    def __init__(self, base_channels: int = 16):
        super().__init__()
        convs, in_ch = [], 1
        for mult, k, stride in self.LAYERS:
            out_ch = min(base_channels * mult, 1024)
            groups = max(1, in_ch // 4) if stride > 1 else 1
            convs.append(Conv1d(in_ch, out_ch, k, padding=k // 2, init_gain="relu",
                                stride=stride, groups=groups))
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.out = Conv1d(in_ch, 1, 3, padding=1)

    def forward(self, x):
        """x [B, T] -> (score [B, T', 1], [each conv's output])."""
        feats, h = [], x[..., None]
        for conv in self.convs:
            h = _lrelu(conv(h))
            feats.append(h)
        return self.out(h), feats


def avg_pool_same(x):
    """Average pooling over time, kernel 4, stride 2, under XLA's "SAME"
    padding (the JAX package's reduce_window sum / 4): ceil(T / 2) outputs,
    zero padding of (2 + T % 2) split with the odd one on the right (1 and
    1 for an even T, 1 and 2 for an odd one), which avg_pool1d's symmetric
    padding does not give."""
    total = 2 + x.shape[-1] % 2
    return F.avg_pool1d(F.pad(x, (total // 2, total - total // 2))[:, None], 4, 2)[:, 0]


class MelganMultiscaleDiscriminator(nn.Module):
    """num_scales discriminators on the waveform average-pooled 2x between
    scales (`avg_pool_same`). Seeded random weights until a checkpoint is
    loaded; on `device`, CUDA unless given."""

    def __init__(self, num_scales: int = 3, base_channels: int = 16, device=None,
                 seed: int = 1):
        super().__init__()
        self.scales = nn.ModuleList(MelganDiscriminator(base_channels)
                                    for _ in range(num_scales))
        init_convs_(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    def forward(self, x):
        """x [B, T] -> [(score, feature maps) for each scale]."""
        outs = []
        for i, d in enumerate(self.scales):
            if i:
                x = avg_pool_same(x)
            outs.append(d(x))
        return outs
