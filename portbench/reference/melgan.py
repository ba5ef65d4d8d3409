"""The MelGAN generator (Kumar et al. 2019, the Mozilla TTS LJSpeech
recipe's widths) in plain torch, float32: conv7 -> for each upsampling
factor u a leaky ReLU and a transposed conv (kernel 2u, stride u) halving
the channels, then a stack of residual blocks (dilation 3^i: shortcut(x) +
conv1(lrelu(conv3(lrelu(x))))) -> leaky ReLU -> conv7 -> tanh. Reflection
padding on every conv wider than 1. Nothing here reads the program under
test."""

from __future__ import annotations

import math

import torch

from .precision import conv1d, rounder


def weight_spec(m: dict, n_mels: int) -> list:
    """(name, shape, std, mean) of every tensor: xavier-normal weights at the
    layer's gain, zero biases."""
    spec = []
    relu, tanh = math.sqrt(2.0), 5.0 / 3.0

    def conv(name, i, o, k, gain=1.0):
        spec.append((name + ".weight", (o, i, k), gain * math.sqrt(2.0 / (k * (i + o))), 0.0))
        spec.append((name + ".bias", (o,), 0.0, 0.0))

    ch, k = m["base_channels"], m["kernel_size"]
    conv("conv_in", n_mels, ch, k)
    for u_i, u in enumerate(m["upsample_factors"]):
        # the transposed conv's weight is [in, out, k]
        spec.append((f"ups.{u_i}.up.weight", (ch, ch // 2, 2 * u),
                     relu * math.sqrt(2.0 / (2 * u * (ch + ch // 2))), 0.0))
        spec.append((f"ups.{u_i}.up.bias", (ch // 2,), 0.0, 0.0))
        ch //= 2
        for b in range(m["num_res_blocks"]):
            conv(f"ups.{u_i}.res.blocks.{b}.c1", ch, ch, 3, relu)
            conv(f"ups.{u_i}.res.blocks.{b}.c2", ch, ch, 1)
            conv(f"ups.{u_i}.res.blocks.{b}.sc", ch, ch, 1)
    conv("conv_out", ch, 1, k, tanh)
    return spec


def _lrelu(x):
    return torch.nn.functional.leaky_relu(x, 0.2)


def _conv(W, name, x, rnd, dilation=1):
    w = W[name + ".weight"]
    total = dilation * (w.shape[-1] - 1)
    pad = (total // 2, total - total // 2)
    return conv1d(x, w, W[name + ".bias"], pad, "reflect" if total else "constant",
                  dilation, rnd)


def generate(W, mel, m: dict, mode: str = "f32"):
    """mel [B, T, n_mels] -> waveform [B, T * prod(upsample_factors)]."""
    rnd = rounder(mode)
    x = _conv(W, "conv_in", mel.transpose(1, 2), rnd)
    for u_i, u in enumerate(m["upsample_factors"]):
        w = W[f"ups.{u_i}.up.weight"]
        # a transposed conv of stride u, kernel 2u: output length T * u
        x = torch.nn.functional.conv_transpose1d(
            rnd(_lrelu(x)), rnd(w), W[f"ups.{u_i}.up.bias"], stride=u,
            padding=u // 2 + u % 2, output_padding=u % 2)
        for b in range(m["num_res_blocks"]):
            n = f"ups.{u_i}.res.blocks.{b}"
            y = _conv(W, n + ".c1", _lrelu(x), rnd, dilation=3 ** b)
            x = _conv(W, n + ".sc", x, rnd) + _conv(W, n + ".c2", _lrelu(y), rnd)
    return torch.tanh(_conv(W, "conv_out", _lrelu(x), rnd))[:, 0]
