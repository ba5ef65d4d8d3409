"""Shared model blocks (the JAX package's models/common.py): Prenet, conv+BN
blocks, sequence masks and the prenet fold the decode kernel needs.

Training mode follows the module's `training` flag for BatchNorm; dropout
is drawn only when a torch.Generator is passed (the JAX package's
`rng is not None`)."""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..nn.core import BatchNorm1d, Conv1d, Dense, dropout


def sequence_mask(lengths, max_len: int):
    """[B] lengths -> [B, max_len] bool validity mask."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


class Prenet(nn.Module):
    """2-layer bottleneck ahead of the decoder. prenet_type="original" is
    Linear+ReLU (+ dropout 0.5 that stays on at inference, applied by the
    decode from its hash PRNG); "bn" is Linear(no bias)+BatchNorm+ReLU.
    `forward` applies the original prenet's dropout only when given a
    generator (teacher forcing draws it there)."""

    def __init__(self, in_dim: int, prenet_type: str = "original",
                 prenet_dropout: bool = True, out_dims=(256, 256)):
        super().__init__()
        self.prenet_type = prenet_type
        self.dropout_enabled = prenet_dropout
        dims = (in_dim,) + tuple(out_dims)
        self.linears = nn.ModuleList(
            Dense(dims[i], dims[i + 1], bias=(prenet_type == "original"))
            for i in range(len(out_dims)))
        if prenet_type == "bn":
            self.bns = nn.ModuleList(BatchNorm1d(d) for d in out_dims)

    def forward(self, x, generator: torch.Generator | None = None):
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if self.prenet_type == "bn":
                x = torch.relu(self.bns[i](x))
            else:
                x = torch.relu(x)
                if self.dropout_enabled:
                    x = dropout(x, 0.5, generator)
        return x


def fold_bn_prenet(prenet: Prenet, eps: float = 1e-5):
    """Inference-mode BN prenet -> plain Linear (weight [out, in], bias)
    pairs: each BN affine folds into its Linear."""
    out = []
    for lin, bn in zip(prenet.linears, prenet.bns):
        k = bn.weight * torch.rsqrt(bn.running_var + eps)
        out.append((lin.weight * k[:, None], bn.bias - bn.running_mean * k))
    return out


def kernel_prenet(prenet: Prenet, prenet_dropout: bool):
    """(Linear (weight, bias) pairs, dropout flag) for the decode kernel.
    BN prenets fold their running-stats affine into the Linears and never
    apply dropout."""
    if prenet.prenet_type == "bn":
        return fold_bn_prenet(prenet), False
    return ([(lin.weight, lin.bias) for lin in prenet.linears],
            prenet_dropout and prenet.dropout_enabled)


def cached_decode_weights(decoder: nn.Module, dtype, build) -> dict:
    """`build(dtype)`, the decode kernel's weight layout, kept in
    `decoder._prepared` per (dtype, device, parameter version): loading new
    weights rebuilds it, repeated inference reuses it."""
    version = tuple(t._version for t in decoder.state_dict().values())
    key = (dtype, next(decoder.parameters()).device)
    hit = decoder._prepared.get(key)
    if hit is None or hit[0] != version:
        hit = decoder._prepared[key] = (version, build(dtype))
    return hit[1]


def compute_copy(model: nn.Module, name: str, dtype) -> nn.Module:
    """`model.<name>` with every float parameter and buffer cast to `dtype`,
    for inference at the config's `inference_compute_dtype` (the JAX
    package's `cast_compute`). Kept in `model._compute_copies` per (name,
    dtype, device, parameter version), like `cached_decode_weights`."""
    module = getattr(model, name)
    version = tuple(t._version for t in module.state_dict().values())
    key = (name, dtype, next(module.parameters()).device)
    cache = model.__dict__.setdefault("_compute_copies", {})
    hit = cache.get(key)
    if hit is None or hit[0] != version:
        cast = copy.deepcopy(module).to(dtype).eval().requires_grad_(False)
        hit = cache[key] = (version, cast)
    return hit[1]


class ConvBNBlock(nn.Module):
    """conv(k) + BatchNorm (statistics over `mask` when training) +
    activation + dropout 0.5 (training mode with a generator only)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int,
                 activation: str | None = "relu"):
        super().__init__()
        self.conv = Conv1d(in_dim, out_dim, kernel_size)
        self.bn = BatchNorm1d(out_dim)
        self.activation = activation

    def forward(self, x, mask=None, generator: torch.Generator | None = None):
        x = self.bn(self.conv(x), mask)
        if self.activation == "relu":
            x = torch.relu(x)
        elif self.activation == "tanh":
            x = torch.tanh(x)
        return dropout(x, 0.5, generator) if self.training else x
