"""Global Style Tokens (the JAX package's models/gst.py).

ReferenceEncoder: six 3x3 stride-2 convolutions with BatchNorm and ReLU
over the style mel, then a GRU whose last (or last real) output sums the
style up. StyleTokenLayer: multi-head attention of that summary over a bank
of learned tokens. GST projects the result to the encoder width; the model
adds it to every position of the encoder outputs.

In training mode the reference encoder's BatchNorms normalize with the
batch statistics over (B, T, F) and move their running statistics towards
them (the JAX package's `train=True`), which the model's "state" then
carries beside the encoder's and the postnet's; in eval mode the running
statistics normalize.

The reference runs its convolutions channel-last (NHWC, H = time, W = mel
bins) and flattens [B, T, F, C] to [B, T, F * C] with C minor. Here they are
torch's Conv2d in NCHW, so the activations go to [B, T, F, C] (a permute)
before BatchNorm and before that flattening: the GRU reads its inputs in
the reference's order.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import GSTConfig
from ..nn.core import BatchNorm1d, Dense
from ..nn.rnn import GRU


class Conv2d(nn.Conv2d):
    """torch's Conv2d, but a bf16 convolution of CPU tensors sums in
    float32 and rounds once, as cuDNN's bf16 convolution accumulates:
    oneDNN's bf16 Conv2d on the CPU returns wrong sums (or NaN) where the
    mel axis is 1 or 2 wide and 64 channels or more come in, which a
    20-mel config reaches in its last two convolutions."""

    def forward(self, x):
        if x.device.type == "cpu" and x.dtype == torch.bfloat16:
            return self._conv_forward(x.float(), self.weight.float(),
                                      self.bias.float()).to(x.dtype)
        return super().forward(x)


class Conv2dBN(nn.Module):
    """A 3x3 stride-2 convolution (explicit (1, 1) padding: each side of
    length L becomes (L + 1) // 2) + BatchNorm over (B, T, F) per channel +
    ReLU. The JAX package keeps the convolution's w [3, 3, in, ch] (HWIO)
    and b beside a "bn" subtree, and the BatchNorm's running statistics
    one level up: `jax_layout` tells train/checkpoint.py so."""

    jax_layout = "conv2d_bn"

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 3, stride=2, padding=1)
        self.bn = BatchNorm1d(out_ch)

    def forward(self, x):
        """x [B, C_in, T, F] -> [B, C_out, (T + 1) // 2, (F + 1) // 2]."""
        y = self.bn(self.conv(x).permute(0, 2, 3, 1))
        return torch.relu(y).permute(0, 3, 1, 2)


class ReferenceEncoder(nn.Module):
    CHANNELS = (32, 32, 64, 64, 128, 128)

    def __init__(self, n_mels: int, out_dim: int = 128):
        super().__init__()
        chans = (1,) + self.CHANNELS
        self.convs = nn.ModuleList(Conv2dBN(chans[i], chans[i + 1])
                                   for i in range(len(self.CHANNELS)))
        f = n_mels
        for _ in self.CHANNELS:
            f = (f + 1) // 2
        self.gru = GRU(f * self.CHANNELS[-1], out_dim, batch_first=True)

    def forward(self, mel, style_len=None):
        """mel [B, T, n_mels] -> [B, out_dim]: the GRU's output at its last
        step, or with style_len [B] at the last step a row's real frames
        reach through the six halvings."""
        x = mel[:, None]
        for conv in self.convs:
            x = conv(x)
        B, C, T, F = x.shape
        out = self.gru(x.permute(0, 2, 3, 1).reshape(B, T, F * C))[0]
        if style_len is None:
            return out[:, -1]
        L = torch.as_tensor(style_len, device=out.device)
        for _ in self.CHANNELS:
            L = (L + 1) // 2
        return out[torch.arange(B, device=out.device), (L - 1).clamp(0, T - 1)]


class StyleTokenLayer(nn.Module):
    def __init__(self, query_dim: int, num_tokens: int, token_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.tokens = nn.Parameter(torch.zeros(num_tokens, token_dim // num_heads))
        self.q = Dense(query_dim, token_dim, bias=False)
        self.k = Dense(token_dim // num_heads, token_dim, bias=False)
        self.v = Dense(token_dim // num_heads, token_dim, bias=False)

    def forward(self, query):
        """query [B, query_dim] -> style embedding [B, token_dim]."""
        B, N, H = query.shape[0], self.tokens.shape[0], self.num_heads
        D = self.tokens.shape[1]
        tokens = torch.tanh(self.tokens)
        q = self.q(query).reshape(B, H, D)
        k = self.k(tokens).reshape(N, H, D)
        v = self.v(tokens).reshape(N, H, D)
        w = torch.softmax(torch.einsum("bhd,nhd->bhn", q, k) / math.sqrt(D), dim=-1)
        return torch.einsum("bhn,nhd->bhd", w, v).reshape(B, H * D)


class GST(nn.Module):
    def __init__(self, n_mels: int, encoder_dim: int, cfg: GSTConfig | None = None):
        super().__init__()
        cfg = cfg or GSTConfig()
        self.ref = ReferenceEncoder(n_mels, 128)
        self.style = StyleTokenLayer(128, cfg.gst_style_tokens, cfg.gst_embedding_dim,
                                     cfg.gst_num_heads)
        self.proj = Dense(cfg.gst_embedding_dim, encoder_dim)

    def forward(self, style_mel, style_len=None):
        """style_mel [B, T, n_mels] -> style [B, encoder_dim]."""
        return self.proj(self.style(self.ref(style_mel, style_len)))

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """The JAX package's init families: xavier-uniform convolutions
        (over its [3, 3 * in, ch] view) and Dense layers, zero biases,
        U(-1/sqrt(H), 1/sqrt(H)) GRU, N(0, 0.25) tokens, BatchNorm at
        identity."""
        for blk in self.ref.convs:
            w = blk.conv.weight
            a = math.sqrt(6.0 / (9 * w.shape[1] + 3 * w.shape[0]))
            w.uniform_(-a, a, generator=generator)
            blk.conv.bias.zero_()
        for lin in (self.style.q, self.style.k, self.style.v, self.proj):
            a = math.sqrt(6.0 / (lin.weight.shape[0] + lin.weight.shape[1]))
            lin.weight.uniform_(-a, a, generator=generator)
        self.proj.bias.zero_()
        s = 1.0 / math.sqrt(self.ref.gru.hidden_size)
        for p in self.ref.gru.parameters():
            p.uniform_(-s, s, generator=generator)
        self.style.tokens.normal_(0.0, 0.5, generator=generator)
