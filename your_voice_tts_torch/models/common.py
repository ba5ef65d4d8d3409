"""Shared model blocks (the JAX package's models/common.py): Prenet, conv+BN
blocks, sequence masks, the prenet fold the decode kernel needs, and the
style and speaker conditioning of the encoder outputs both Tacotrons use,
and `ServingWeights`, what a traced inference reads beside the model's
parameters.

Training mode follows the module's `training` flag for BatchNorm; dropout
is drawn only when a torch.Generator is passed (the JAX package's
`rng is not None`)."""

from __future__ import annotations

import copy
import logging

import torch
from torch import nn

from ..nn.core import BatchNorm1d, Conv1d, Dense, dropout

_log = logging.getLogger(__name__)


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


def add_style(model, enc_out, style_mel, cast=None, style_len=None):
    """A GST model's style of style_mel [B, T_style, n_mels], or [1, ...]
    for one style of every row (float32, cast to the memory's dtype as the
    reference casts it) through `cast("gst")`, added to every position of
    enc_out [B, T, C]; with style_len [B] the reference encoder reads each
    row's last real step (training passes the teacher mels and their
    lengths). With no style_mel the reference's warning, and enc_out as it
    is. enc_out itself for a model without GST."""
    if not model.use_gst:
        return enc_out
    if style_mel is None:
        _log.warning("GST model conditioned WITHOUT a style reference: the GST branch is "
                     "skipped and the decoder sees encoder outputs it never saw un-shifted "
                     "in training — pass style_wav/style_mel")
        return enc_out
    mel = torch.as_tensor(style_mel, dtype=torch.float32, device=enc_out.device)
    style = (cast("gst") if cast else model.gst)(mel.to(enc_out.dtype), style_len)
    return enc_out + style[:, None, :]


def concat_speaker(model, enc_out, speaker_ids=None, speaker_embeddings=None, cast=None):
    """enc_out [B, T, C] -> [B, T, C + spk_dim] for a speaker-conditioned
    model (Tacotron2 or Tacotron(1)): the speaker vector of each row (its
    row of the table, `cast("speaker_embedding")` where a compute-dtype
    copy is wanted, or its d-vector from speaker_embeddings [B, spk_dim])
    cast to the memory's dtype and concatenated onto every position;
    enc_out itself for an unconditioned model."""
    if not model.num_speakers:
        return enc_out
    B, T, _ = enc_out.shape
    if model.use_external_speaker_embedding:
        if speaker_embeddings is None:
            raise ValueError("this model is conditioned on d-vectors: "
                             "pass speaker_embeddings [B, spk_dim]")
        spk = torch.as_tensor(speaker_embeddings, dtype=torch.float32, device=enc_out.device)
    else:
        if speaker_ids is None:
            raise ValueError("this model is conditioned on speaker ids: pass speaker_ids [B]")
        ids = torch.as_tensor(speaker_ids, dtype=torch.long, device=enc_out.device)
        spk = (cast("speaker_embedding") if cast else model.speaker_embedding)(ids)
    if tuple(spk.shape) != (B, model.spk_dim):
        raise ValueError(f"speaker vectors of shape {tuple(spk.shape)}, "
                         f"expected {(B, model.spk_dim)}")
    spk = spk.to(enc_out.dtype)[:, None, :].expand(B, T, model.spk_dim)
    return torch.cat([enc_out, spk], -1)


class ServingWeights(nn.Module):
    """What a traced inference (`infer/export.py`) reads beside a model's
    own parameters, registered so that an exported program carries it: the
    compute-dtype copies (`compute_copy`) of `names` (dotted paths from the
    model, e.g. "encoder" or "decoder.attention.inputs"; absent ones are
    skipped) and the decode's weights (`decoder.decode_weights`, with the
    kernel's packed layout on a CUDA model, or the given `weights` dict) as
    buffers. Passed to the model's `inference` as `traced`, it routes the
    decode through the registered op (`ops/library.py`) of `kind`
    ("taco2", "taco1", or "taco1_step" for Tacotron(1)'s step loop)."""

    def __init__(self, model: nn.Module, kind: str, names, compute_dtype, decode_dtype,
                 pack=None, weights: dict | None = None):
        from ..ops.library import flatten_weights

        super().__init__()
        self.kind = kind
        self.copies = nn.ModuleDict()
        if compute_dtype is not None:
            for name in names:
                *owner, attr = name.split(".")
                mod = model
                for part in owner:
                    mod = getattr(mod, part, None)
                if mod is not None and hasattr(mod, attr):
                    self.copies[name.replace(".", "__")] = compute_copy(mod, attr, compute_dtype)
        w = weights
        if w is None:
            w = model.decoder.decode_weights(decode_dtype)
            if pack is not None and model.device.type == "cuda":
                pack(w)
        self.spec, tensors = flatten_weights(w)
        self.n_weights = len(tensors)
        for i, t in enumerate(tensors):
            self.register_buffer(f"w{i}", t)

    def cast(self, name: str) -> nn.Module:
        return self.copies[name.replace(".", "__")]

    def decode(self, enc_out, pinp, mask, seed, **kw):
        """The registered decode on these weights (`ops.library.decode`)."""
        from ..ops.library import decode

        return decode(self.kind, self.spec, self._weights(), enc_out, pinp, mask, seed, **kw)

    def step_decode(self, enc_out, lengths, seed, *, r: int, max_steps: int):
        """Tacotron(1)'s step loop as the registered op on these weights
        (`torch.ops.yvt.taco1_step_decode`)."""
        return torch.ops.yvt.taco1_step_decode(self._weights(), enc_out, lengths, seed,
                                               self.spec, r, max_steps)

    def _weights(self) -> list:
        return [getattr(self, f"w{i}") for i in range(self.n_weights)]
