"""WaveRNN vocoder with batched sequence folding (the JAX package's
vocoder/models/wavernn.py), generation side.

A MelResNet + stretch-upsample conditioning network, then a sample-rate
core of two GRUs and three FCs predicting, per sample, a 2**bits-way mu-law
categorical (or a mixture of logistics, or a Gaussian). Generation folds
one utterance into overlapping segments that ride the batch axis
(`fold_with_overlap`), decodes all folds at once in the sample loop
(ops/wavernn_gen.py: the CUDA kernel on the card, its plain version on the
CPU), and crossfades the overlaps back (`xfade_and_unfold`). Activations
are channel-last [B, T, C] like the JAX package's; weights are in the
port's layouts (train/checkpoint.params_from_jax maps a JAX checkpoint
onto them). Teacher-forced training comes with a later slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.core import GAINS, Conv1d, Dense, xavier_uniform_
from ...nn.rnn import GRUCell
from ...ops.wavernn_gen import generation_weights, pack_weights, wavernn_generate

# --- mu-law ------------------------------------------------------------------


def encode_mulaw(x, bits: int):
    """float [-1, 1] -> int class [0, 2**bits)."""
    mu = 2 ** bits - 1
    y = torch.sign(x) * torch.log1p(mu * x.abs()) / math.log1p(mu)
    return torch.clamp((y + 1.0) * 0.5 * mu + 0.5, 0, mu).to(torch.int32)


def decode_mulaw(y, bits: int):
    """int class -> float [-1, 1] (expm1, as the JAX package's scan route;
    the generation kernel's own decoding is distribs.sample_mulaw)."""
    mu = 2 ** bits - 1
    f = 2.0 * y.float() / mu - 1.0
    return torch.sign(f) * torch.expm1(f.abs() * math.log1p(mu)) / mu


def label_to_float(y, bits: int):
    """class id -> scaled float input in [-1, 1] (the network's input
    encoding)."""
    return 2.0 * y.float() / (2 ** bits - 1.0) - 1.0


# --- conditioning network ----------------------------------------------------


class MelResNet(nn.Module):
    """Kernel-5 'valid' conv + 1x1 residual blocks -> aux features; the
    output is 2 * pad frames shorter than the input. The biases stand in
    for the reference's inference-mode BatchNorms, as in the JAX package."""

    def __init__(self, n_mels: int, compute_dims: int, res_out_dims: int,
                 num_blocks: int, pad: int):
        super().__init__()
        self.conv_in = Conv1d(n_mels, compute_dims, 2 * pad + 1, padding="valid")
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"c1": Conv1d(compute_dims, compute_dims, 1),
                           "c2": Conv1d(compute_dims, compute_dims, 1)})
            for _ in range(num_blocks))
        self.out = Conv1d(compute_dims, res_out_dims, 1)

    def forward(self, mel):
        x = F.relu(self.conv_in(mel))
        for blk in self.blocks:
            x = x + blk["c2"](F.relu(blk["c1"](x)))
        return self.out(x)


def _stretch(x, factor: int):
    """Nearest-neighbour upsampling along time: [B, T, C] -> [B, T * factor, C]."""
    return torch.repeat_interleave(x, factor, dim=1)


class UpsampleNetwork(nn.Module):
    """Stretch + smoothing-conv pyramid to the sample rate: mel [B, T, M] ->
    cond [B, (T - 2 pad) hop, M], aux [B, (T - 2 pad) hop, res_out_dims]."""

    def __init__(self, n_mels: int, upsample_factors, compute_dims: int,
                 res_out_dims: int, num_blocks: int, pad: int):
        super().__init__()
        self.factors = tuple(upsample_factors)
        self.pad = pad
        self.resnet = MelResNet(n_mels, compute_dims, res_out_dims, num_blocks, pad)
        self.smooth = nn.ModuleList(Conv1d(n_mels, n_mels, 2 * f + 1, use_bias=False)
                                    for f in self.factors)
        self.hop = math.prod(self.factors)

    def forward(self, mel):
        aux = _stretch(self.resnet(mel), self.hop)
        x = mel
        for conv, f in zip(self.smooth, self.factors):
            x = conv(_stretch(x, f))
        trim = self.pad * self.hop
        return x[:, trim: x.shape[1] - trim], aux


# --- the model ---------------------------------------------------------------


class WaveRNN(nn.Module):
    def __init__(self, n_mels: int = 80, bits: int = 10, rnn_dims: int = 512,
                 fc_dims: int = 512, compute_dims: int = 128,
                 res_out_dims: int = 128, num_res_blocks: int = 10,
                 pad: int = 2, upsample_factors=(4, 8, 8), mode: str = "mulaw",
                 num_mixtures: int = 10, device=None, seed: int = 0):
        """Weights are seeded random (xavier-uniform, the JAX package's init
        scheme) until a checkpoint is loaded."""
        super().__init__()
        if res_out_dims % 4 or mode not in ("mulaw", "mol", "gauss"):
            raise ValueError(f"res_out_dims {res_out_dims} must be a multiple of 4 and "
                             f"mode one of mulaw/mol/gauss (got {mode!r})")
        self.n_mels, self.bits, self.mode = n_mels, bits, mode
        self.num_mixtures = num_mixtures
        self.n_classes = {"mulaw": 2 ** bits, "mol": 3 * num_mixtures, "gauss": 2}[mode]
        self.aux_dims = res_out_dims // 4
        self.pad = pad
        self.upsample = UpsampleNetwork(n_mels, upsample_factors, compute_dims,
                                        res_out_dims, num_res_blocks, pad)
        self.hop = self.upsample.hop
        self.I = Dense(n_mels + self.aux_dims + 1, rnn_dims)
        self.rnn1 = GRUCell(rnn_dims, rnn_dims)
        self.rnn2 = GRUCell(rnn_dims + self.aux_dims, rnn_dims)
        self.fc1 = Dense(rnn_dims + self.aux_dims, fc_dims)
        self.fc2 = Dense(fc_dims + self.aux_dims, fc_dims)
        self.fc3 = Dense(fc_dims, self.n_classes)
        self.rnn_dims = rnn_dims
        self._packed = None
        self._init(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    def _init(self, g: torch.Generator) -> None:
        relu = ({id(self.upsample.resnet.conv_in), id(self.fc1), id(self.fc2)}
                | {id(b["c1"]) for b in self.upsample.resnet.blocks})
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, GRUCell):
                    s = 1.0 / math.sqrt(m.hidden_size)
                    for prm in m.parameters():
                        prm.uniform_(-s, s, generator=g)
                elif isinstance(m, (Conv1d, nn.Linear)):
                    gain = GAINS["relu"] if id(m) in relu else GAINS["linear"]
                    xavier_uniform_(m.weight, gain, g)
                    if m.bias is not None:
                        m.bias.zero_()
            for conv in self.upsample.smooth:     # averaging filters, as the reference
                k = conv.weight.shape[-1]
                conv.weight.copy_(torch.eye(conv.weight.shape[0])[:, :, None].expand(-1, -1, k) / k)

    @torch.no_grad()
    def generate(self, mel, seed: int, batched: bool = True, target: int = 5_500,
                 overlap: int = 550):
        """mel [T, n_mels] (one utterance with `pad` context frames each
        side) -> waveform [(T - 2 pad) hop] on the model's device. `seed`
        keys the sample loop's hash PRNG. batched folds the samples into
        overlapping segments decoded together, then crossfades them."""
        cond, aux = self.upsample(mel[None].to(self.I.weight))
        cond, aux = cond[0], aux[0]
        L = cond.shape[0]
        if not batched:
            return self._decode(cond[None], aux[None], seed)[0]
        samples = self._decode(fold_with_overlap(cond, target, overlap),
                               fold_with_overlap(aux, target, overlap), seed)
        return xfade_and_unfold(samples, target, overlap)[:L]

    def _decode(self, cond, aux, seed: int):
        w = generation_weights(self)
        packed = self.packed_weights(w) if cond.device.type == "cuda" else None
        return wavernn_generate(w, cond.contiguous(), aux.contiguous(), seed, bits=self.bits,
                                mode=self.mode, num_mixtures=self.num_mixtures, packed=packed)

    def packed_weights(self, w: dict | None = None) -> dict:
        """The sample-loop kernel's layout of the weights (`pack_weights`),
        kept on the module and made again when a parameter of the sample
        loop changes: its `_version` (an in-place edit, load_checkpoint, an
        optimizer step) or its `data_ptr` (a move or a new tensor)."""
        params = [t for m in (self.I, self.rnn1, self.rnn2, self.fc1, self.fc2, self.fc3)
                  for t in m.parameters()]
        key = tuple((t._version, t.data_ptr()) for t in params)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_weights(w or generation_weights(self)))
        return self._packed[1]


# --- folding -----------------------------------------------------------------


def fold_with_overlap(x, target: int, overlap: int):
    """[L, C] -> [n_folds, target + 2 overlap, C] overlapping segments
    (reference WaveRNN.fold_with_overlap); zero-pads the tail."""
    L = x.shape[0]
    n_folds = max(1, -(-max(L - overlap, 1) // (target + overlap)))
    total = n_folds * (target + overlap) + overlap
    if total > L:
        x = F.pad(x, (0, 0, 0, total - L))
    return torch.stack([x[i * (target + overlap): i * (target + overlap) + target + 2 * overlap]
                        for i in range(n_folds)])


def xfade_and_unfold(y, target: int, overlap: int):
    """[n_folds, target + 2 overlap] -> [n_folds (target + overlap) + overlap]
    with a linear crossfade over the overlaps; the first fold's head and the
    last fold's tail keep unit gain, as in the JAX package."""
    n_folds, seg = y.shape
    if seg != target + 2 * overlap:
        raise ValueError(f"fold length {seg} is not target + 2 overlap")
    fade_in = torch.from_numpy(np.linspace(0.0, 1.0, overlap, dtype=np.float32)).to(y.device)
    ones = torch.ones(target + overlap, device=y.device)
    head = torch.cat([fade_in, ones])
    tail = torch.cat([ones, 1.0 - fade_in])
    out = torch.zeros(n_folds * (target + overlap) + overlap, device=y.device)
    for i in range(n_folds):
        env = torch.minimum(head if i else torch.ones_like(head),
                            tail if i < n_folds - 1 else torch.ones_like(tail))
        s = i * (target + overlap)
        out[s: s + seg] += y[i] * env
    return out
