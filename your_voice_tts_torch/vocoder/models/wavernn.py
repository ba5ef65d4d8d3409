"""WaveRNN vocoder with batched sequence folding (the JAX package's
vocoder/models/wavernn.py): generation and teacher-forced training.

A MelResNet + stretch-upsample conditioning network, then a sample-rate
core of two GRUs and three FCs predicting, per sample, a 2**bits-way mu-law
categorical (or a mixture of logistics, or a Gaussian). Generation folds
one utterance into overlapping segments that ride the batch axis
(`fold_with_overlap`), decodes all folds at once in the sample loop
(ops/wavernn_gen.py: the CUDA kernel on the card, its plain version on the
CPU), and crossfades the overlaps back (`xfade_and_unfold`). Activations
are channel-last [B, T, C] like the JAX package's; weights are in the
port's layouts (train/checkpoint.params_from_jax maps a JAX checkpoint
onto them). Training (`forward`, `loss`) runs each GRU over the whole
sequence as one call (cuDNN on the card), in float32 under mixed precision
as the reference's scan does.
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
from .distribs import discretized_mix_logistic_loss, gaussian_loss

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

    def forward(self, x, mels):
        """Teacher-forced pass: x [B, L] the input samples (x_{t-1}) in
        [-1, 1], mels [B, T_mel, n_mels] with (T_mel - 2 pad) hop == L ->
        logits [B, L, n_classes]. The upsampled conditioning, I over
        [x | mel | a1], rnn1, the residual, rnn2 over [x + o1 | a2], the
        residual, fc1 over [. | a3], fc2 over [. | a4], fc3. The reference
        scans `_core_step` one sample at a time; every input of either GRU
        is known before it runs here, so each is one whole-sequence GRU
        call over the same weights (torch's (r, z, n) gates, b_hn inside
        the reset, as the JAX GRUCell), the same function with its sums in
        another order.

        Dtypes follow the reference's scan: the GRU states start in float32,
        so on bf16 parameters (mixed precision) the conditioning network and
        I run in bf16, while both recurrences, the residual stream and
        fc1-fc3 run in float32 on the bf16 weights cast up (the reference
        rounds rnn1's input projection to bf16 before it meets the float32
        state; the port keeps it in float32)."""
        cond, aux = self.upsample(mels)
        d = self.aux_dims
        a1, a2, a3, a4 = (aux[..., i * d:(i + 1) * d] for i in range(4))
        h = self.I(torch.cat([x[..., None].to(cond.dtype), cond, a1], -1))
        h = _up(h) + self._gru(self.rnn1, h)
        h = h + self._gru(self.rnn2, torch.cat([h, _up(a2)], -1))
        h = torch.relu(_linear(self.fc1, torch.cat([h, _up(a3)], -1)))
        h = torch.relu(_linear(self.fc2, torch.cat([h, _up(a4)], -1)))
        return _linear(self.fc3, h)

    @staticmethod
    def _gru(cell, x):
        """A GRUCell's weights run over x [B, L, in] as one batch-first GRU
        from a zero state -> outputs [B, L, H], in float32 at least (x and
        the weights cast up, `_up`)."""
        x = _up(x)
        h0 = x.new_zeros(1, x.shape[0], cell.hidden_size)
        weights = [w.to(x.dtype) for w in (cell.weight_ih, cell.weight_hh, cell.bias_ih,
                                           cell.bias_hh)]
        return torch.gru(x, h0, weights, True, 1, 0.0, cell.training, False, True)[0]

    def loss(self, mels, audio, compute_dtype=None, params: dict | None = None):
        """Teacher-forced negative log-likelihood of audio [B, L] in
        [-1, 1]: mu-law, the cross-entropy of each sample's class given the
        previous one's (label_to_float of the targets shifted by one, the
        first input class 0); MoL and Gaussian, their likelihoods given the
        audio shifted by one (zero first). compute_dtype casts the input
        samples (the caller casts the mels, and hands the parameters' casts
        as `params`, which the forward runs on: mixed-precision training);
        the NLL is float32 always."""
        if self.mode == "mulaw":
            targets = encode_mulaw(audio, self.bits).long()
            x_in = label_to_float(F.pad(targets[:, :-1], (1, 0)), self.bits)
        else:
            x_in = F.pad(audio[:, :-1], (1, 0))
        if compute_dtype is not None:
            x_in = x_in.to(compute_dtype)
        y_hat = (self(x_in, mels) if params is None
                 else torch.func.functional_call(self, params, (x_in, mels))).float()
        if self.mode == "mulaw":
            logp = torch.log_softmax(y_hat, -1)
            return -logp.gather(-1, targets[..., None]).mean()
        if self.mode == "mol":
            return discretized_mix_logistic_loss(y_hat, audio.float())
        return gaussian_loss(y_hat, audio.float())

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


def _up(t):
    """t in float32 at least: a bf16 tensor cast up, float32 and float64 as
    they are."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _linear(lin, x):
    """A Dense layer on x in x's dtype, its weights cast to it."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


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
