"""ParallelTTS (the JAX package's models/parallel_tts.py): the
non-autoregressive, duration-based text-to-mel family.

- text encoder: the Tacotron2 conv + BiLSTM `Encoder` (cfg.parallel_encoder
  "shared", the default) or `ConvTextEncoder`, six residual dilated
  conv + LayerNorm blocks ("conv");
- conditioning: a GST style added to the encoder states, then a speaker
  vector (a row of a 64-wide table, or a d-vector) concatenated and
  projected back to encoder_dim by `spk_proj`;
- duration predictor: conv + LayerNorm blocks over the (detached, in
  training) encoder states -> per-token log(1 + duration);
- length regulator (`length_regulate`): frame i of a row reads token
  #{t : cum_dur[t] <= i}, a comparison-sum and one gather, with static
  shapes; frames past the row's total are masked;
- optional energy adaptor (cfg.parallel_energy_predictor): a predictor of
  per-frame energy over the detached frames, and `energy_proj` adding the
  teacher energy (training) or the prediction (inference) to the frames;
- decoder: residual conv + LayerNorm blocks, a linear mel head, and the
  Tacotron2 `Postnet`, called without a mask: in training its BatchNorm
  takes statistics over every frame of the batch, padded ones too, as the
  reference's does.

No kernel runs inside the model: it is convolutions, matmuls and the
shared BiLSTM, as in the reference, which has no Pallas kernel here.
Serving reaches the Griffin-Lim kernels after it, and the teacher
durations (bin/extract_durations.py) the training forward kernel through
Tacotron2's teacher-forced pass.

Inference runs in float32 whatever `inference_compute_dtype` says, and its
output does not depend on the seed: the reference's `inference` swallows
`compute_dtype`, `use_pallas` and `rng`, and this one takes the port's
serving keywords (`seed`, `decode_dtype`, `compute_dtype`) and ignores
them. With the energy adaptor and `energy_scale != 1` the reference runs
the energy predictor a second time and throws that output away; this
inference runs it once (the same outputs). Dropout draws from one
torch.Generator, so training dropout cannot reproduce the reference's
threefry keys (nor the key it reuses between the energy predictor and the
first decoder block).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..nn.core import GAINS, Conv1d, Dense, Embedding, LayerNorm, dropout, xavier_uniform_
from .common import ConvBNBlock, sequence_mask
from .gst import GST
from .tacotron2 import Encoder, Postnet


class ConvLNBlock(nn.Module):
    """conv(k, "same", dilation) + LayerNorm + ReLU + dropout (training mode
    with a generator only) + the mask."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, dropout: float = 0.1,
                 dilation: int = 1):
        super().__init__()
        self.conv = Conv1d(in_dim, out_dim, kernel_size, padding="same", init_gain="relu",
                           dilation=dilation)
        self.ln = LayerNorm(out_dim)
        self.rate = dropout

    def forward(self, x, generator=None, mask=None):
        x = torch.relu(self.ln(self.conv(x)))
        if self.training:
            x = dropout(x, self.rate, generator)
        if mask is not None:
            x = x * mask[..., None].to(x.dtype)
        return x


def length_regulate(enc_out, durations, max_frames: int):
    """Expand token states to frame states by integer durations.

    enc_out [B, T, D]; durations [B, T] integers (frames a token, 0 on pad
    tokens). Returns (frames [B, max_frames, D] masked, frame_mask
    [B, max_frames] bool, idx [B, max_frames] int32, total [B] int32): frame
    i reads token idx = #{t : cum[t] <= i}, clamped to T - 1, and rows whose
    total passes max_frames are cut there."""
    T = enc_out.shape[1]
    cum = torch.cumsum(durations.long(), 1)                              # [B, T]
    total = cum[:, -1].clamp(max=max_frames)
    i = torch.arange(max_frames, device=enc_out.device)
    idx = (i[None, :, None] >= cum[:, None, :]).sum(-1).clamp(max=T - 1)  # [B, M]
    frames = torch.gather(enc_out, 1, idx[..., None].expand(-1, -1, enc_out.shape[2]))
    frame_mask = i[None, :] < total[:, None]
    return (frames * frame_mask[..., None].to(frames.dtype), frame_mask, idx.int(),
            total.int())


class ConvTextEncoder(nn.Module):
    """The scan-free text encoder (cfg.parallel_encoder "conv"): residual
    ConvLN blocks at dilations 1, 2, 4, 1, 2, 4, masked by the text lengths.
    Called as the Tacotron2 `Encoder` is, so the model swaps them."""

    def __init__(self, dim: int, n_blocks: int = 6, kernel: int = 5):
        super().__init__()
        self.blocks = nn.ModuleList(ConvLNBlock(dim, dim, kernel, dropout=0.1,
                                                dilation=(1, 2, 4)[i % 3])
                                    for i in range(n_blocks))

    def forward(self, x, lengths, generator=None, unpacked: bool = False):
        m = sequence_mask(lengths, x.shape[1])
        mf = m[..., None].to(x.dtype)
        for blk in self.blocks:
            x = (x + blk(x, generator, mask=m)) * mf
        return x


class DurationPredictor(nn.Module):
    """ConvLN blocks + a linear head -> per-token log(1 + duration), masked
    (also the energy adaptor's per-frame predictor)."""

    def __init__(self, in_dim: int, hidden: int = 256, kernel: int = 3, n_layers: int = 2,
                 dropout: float = 0.1):
        super().__init__()
        dims = [in_dim] + [hidden] * n_layers
        self.blocks = nn.ModuleList(ConvLNBlock(dims[i], dims[i + 1], kernel, dropout=dropout)
                                    for i in range(n_layers))
        self.proj = Dense(hidden, 1)

    def forward(self, x, mask, generator=None):
        for blk in self.blocks:
            x = blk(x, generator, mask=mask)
        return self.proj(x)[..., 0] * mask.to(x.dtype)


class ParallelTTS(nn.Module):
    SPEAKER_TABLE_DIM = 64    # the reference's table width

    def __init__(self, num_chars: int, cfg, n_mels: int = 80, num_speakers: int = 0,
                 speaker_embedding_dim: int = 0, use_gst: bool = False, gst_cfg=None,
                 device=None, seed: int = 0):
        """Weights start seeded random (`seed`, drawn on the CPU), then the
        model moves to `device` (CUDA unless given). num_speakers > 1 with
        no speaker_embedding_dim adds a 64-wide speaker table; a
        speaker_embedding_dim conditions on d-vectors of that width. The
        frame cap of inference is cfg.max_decoder_steps * max(cfg.r, 1):
        the config's r, not the model's, which stays 1."""
        super().__init__()
        self.cfg, self.n_mels, self.num_speakers = cfg, n_mels, num_speakers
        dim = cfg.encoder_dim
        self.embedding = Embedding(num_chars, cfg.embedding_dim)
        self.embed_proj = Dense(cfg.embedding_dim, dim) if cfg.embedding_dim != dim else None
        self.encoder = ConvTextEncoder(dim) if cfg.parallel_encoder == "conv" else Encoder(dim)
        spk_dim = 0
        self.speaker_table = None
        if num_speakers > 1 and speaker_embedding_dim == 0:
            spk_dim = self.SPEAKER_TABLE_DIM
            self.speaker_table = Embedding(num_speakers, spk_dim)
        elif speaker_embedding_dim:
            spk_dim = speaker_embedding_dim
        self.spk_dim = spk_dim
        self.spk_proj = Dense(dim + spk_dim, dim) if spk_dim else None
        self.use_gst = use_gst
        if use_gst:
            self.gst = GST(n_mels, dim, gst_cfg)
        self.duration = DurationPredictor(dim, cfg.duration_predictor_dim)
        self.energy = self.energy_proj = None
        if cfg.parallel_energy_predictor:
            self.energy = DurationPredictor(dim, cfg.duration_predictor_dim)
            self.energy_proj = Dense(1, dim)
        self.decoder = nn.ModuleList(ConvLNBlock(dim, dim, 5, dropout=0.1)
                                     for _ in range(cfg.parallel_decoder_blocks))
        self.mel_head = Dense(dim, n_mels)
        self.postnet = Postnet(n_mels, cfg.postnet_dim)
        self.r = 1
        self.max_frames = cfg.max_decoder_steps * max(cfg.r, 1)
        self._init_random(torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.embedding.weight.device

    def set_r(self, r: int) -> None:
        """A no-op that keeps r = 1 (gradual training's hook)."""
        self.r = 1

    @torch.no_grad()
    def _init_random(self, generator: torch.Generator) -> None:
        """The JAX package's init families: xavier-uniform Linear / Conv
        weights at each conv's gain (a ConvBNBlock's by its activation),
        zero biases, N(0, 0.3) embeddings, U(-1/sqrt(H), 1/sqrt(H)) LSTM,
        LayerNorm at identity."""
        gain = {id(m.conv): GAINS[m.activation or "linear"]
                for m in self.modules() if isinstance(m, ConvBNBlock)}
        for mod in self.modules():
            if isinstance(mod, (Dense, Conv1d)):
                xavier_uniform_(mod.weight, gain.get(id(mod), getattr(mod, "gain", 1.0)),
                                generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Embedding):
                mod.weight.normal_(0.0, 0.3, generator=generator)
            elif isinstance(mod, nn.LSTM):
                s = 1.0 / math.sqrt(mod.hidden_size)
                for name, p in mod.named_parameters():
                    if name.startswith("bias_hh"):
                        p.zero_()
                    else:
                        p.uniform_(-s, s, generator=generator)
        if self.use_gst:
            self.gst.init_random_(generator)

    # --- the shared trunk ----------------------------------------------------

    def _encode(self, text, text_lengths, generator, speaker_ids, speaker_embeddings,
                style_mel=None, style_len=None, unpacked: bool = False):
        """Embedding (+ embed_proj) -> encoder -> + GST style (given a
        style_mel) -> speaker projection (given ids for a table model, or
        d-vectors for a conditioned one; the reference's rules: missing
        inputs leave the states as they are)."""
        x = self.embedding(text)
        if self.embed_proj is not None:
            x = self.embed_proj(x)
        enc = self.encoder(x, text_lengths, generator, unpacked=unpacked)
        if self.use_gst and style_mel is not None:
            mel = torch.as_tensor(style_mel, dtype=torch.float32, device=enc.device)
            enc = enc + self.gst(mel.to(enc.dtype), style_len)[:, None, :]
        spk = None
        if self.speaker_table is not None and speaker_ids is not None:
            spk = self.speaker_table(torch.as_tensor(speaker_ids, dtype=torch.long,
                                                     device=enc.device))
        elif speaker_embeddings is not None:
            spk = torch.as_tensor(speaker_embeddings, dtype=torch.float32,
                                  device=enc.device).to(enc.dtype)
        if spk is not None and self.spk_proj is not None:
            B, T, _ = enc.shape
            enc = self.spk_proj(torch.cat([enc, spk[:, None, :].expand(B, T, spk.shape[-1])], -1))
        return enc

    def _add_energy(self, frames, frame_mask, energy):
        """frames + energy_proj(energy) on the real frames (the energy
        adaptor's conditioning)."""
        m = frame_mask.to(frames.dtype)
        return frames + self.energy_proj((energy * m)[..., None]) * m[..., None]

    def _decode(self, frames, frame_mask, generator=None):
        """Residual ConvLN blocks, the mel head and the postnet (no mask,
        no dropout, as the reference calls it) -> (mel, postnet mel), both
        masked."""
        m = frame_mask[..., None].to(frames.dtype)
        x = frames
        for blk in self.decoder:
            x = (x + blk(x, generator, mask=frame_mask)) * m
        mel = self.mel_head(x)
        return mel * m, (mel + self.postnet(mel)) * m

    # --- training ------------------------------------------------------------

    def forward(self, text, text_lengths, durations, max_frames: int | None = None,
                generator: torch.Generator | None = None, speaker_ids=None,
                speaker_embeddings=None, return_alignments: bool = False, style_mel=None,
                style_len=None, energies=None) -> dict:
        """Teacher-duration pass (the JAX package's `ParallelTTS.forward`):
        text [B, T] ids, text_lengths [B], durations [B, T] integer frames a
        token (0 on pad tokens); max_frames the frame count trained against
        (the mel bucket), else the largest duration sum. In training mode
        BatchNorm takes batch statistics and dropout draws from `generator`
        (none without one). A GST model takes style_mel [B, T_s, n_mels]
        (and style_len [B]); an energy model conditions on energies
        [B, M] (the teacher's `frame_energy`), else on its prediction.
        Returns decoder_outputs / postnet_outputs [B, M, n_mels],
        log_durations [B, T], frame_mask, frame_token_idx, mel_lengths,
        energy_pred [B, M] for an energy model, the one-hot alignments
        [B, M, T] when asked, and "state": the BatchNorm running statistics
        after the pass."""
        enc = self._encode(text, text_lengths, generator, speaker_ids, speaker_embeddings,
                           style_mel, style_len)
        tok_mask = sequence_mask(text_lengths, text.shape[1])
        # the duration predictor must not steer the encoder
        logd = self.duration(enc.detach(), tok_mask, generator)
        M = int(durations.sum(1).max()) if max_frames is None else max_frames
        frames, frame_mask, idx, total = length_regulate(enc, durations, M)
        e_pred = None
        if self.energy is not None:
            e_pred = self.energy(frames.detach(), frame_mask, generator)
            frames = self._add_energy(frames, frame_mask,
                                      e_pred if energies is None else energies)
        mel, post = self._decode(frames, frame_mask, generator)
        out = {"decoder_outputs": mel, "postnet_outputs": post, "log_durations": logd,
               "frame_mask": frame_mask, "frame_token_idx": idx, "mel_lengths": total}
        if e_pred is not None:
            out["energy_pred"] = e_pred
        if return_alignments:
            out["alignments"] = pseudo_alignment(idx, frame_mask, text.shape[1])
        out["state"] = {k: v.detach().clone() for k, v in self.named_buffers()}
        return out

    # --- serving -------------------------------------------------------------

    def serving_weights(self, compute_dtype=None, decode_dtype=None) -> nn.Module:
        """What a traced `inference` (infer/export.py) reads beside the
        model's parameters: nothing, as it runs in float32 and has no
        decode. Passing it as `traced` runs the BiLSTM unpacked."""
        return nn.Module()

    @torch.no_grad()
    def inference(self, text, text_lengths, max_decoder_steps: int | None = None,
                  speed: float = 1.0, speaker_ids=None, speaker_embeddings=None,
                  style_mel=None, style_len=None, energy_scale: float = 1.0, seed=0,
                  decode_dtype=None, compute_dtype=None, traced=None) -> dict:
        """Predicted-duration synthesis on the model's device, in float32.
        max_decoder_steps is in frames here (default `max_frames`); speed > 1
        shortens durations: round((exp(logd) - 1) / speed), at least one
        frame a real token, zero on pad tokens. style_mel conditions a GST
        model, energy_scale scales an energy model's predicted energy.
        seed, decode_dtype and compute_dtype are taken and ignored (the
        reference's `**_compat`); `traced` (`serving_weights`) runs the
        BiLSTM unpacked for a traced program. Returns decoder_outputs /
        postnet_outputs [B, M, n_mels] float32, mel_lengths [B] int64,
        alignments (one-hot) [B, M, T], stop_probs (zeros) [B, M] and
        durations [B, T] int32."""
        dev = self.device
        text = torch.as_tensor(text, dtype=torch.long, device=dev)
        text_lengths = torch.as_tensor(text_lengths, dtype=torch.long, device=dev)
        was_training = self.training
        self.eval()
        try:
            enc = self._encode(text, text_lengths, None, speaker_ids, speaker_embeddings,
                               style_mel, style_len, unpacked=traced is not None)
            tok_mask = sequence_mask(text_lengths, text.shape[1])
            logd = self.duration(enc, tok_mask)
            d = torch.round((torch.exp(logd) - 1.0) / speed)
            # every real token speaks for at least one frame
            d = (torch.clamp(d, min=1.0) * tok_mask.to(d.dtype)).int()
            M = max_decoder_steps or self.max_frames
            frames, frame_mask, idx, total = length_regulate(enc, d, M)
            if self.energy is not None:
                frames = self._add_energy(frames, frame_mask,
                                          self.energy(frames, frame_mask) * energy_scale)
            mel, post = self._decode(frames, frame_mask)
        finally:
            self.train(was_training)
        return {"decoder_outputs": mel.float(), "postnet_outputs": post.float(),
                "mel_lengths": total.long(),
                "alignments": pseudo_alignment(idx, frame_mask, text.shape[1]),
                "stop_probs": torch.zeros(frame_mask.shape, device=dev), "durations": d}


def pseudo_alignment(idx, frame_mask, T_text: int):
    """The one-hot frame -> token map [B, frames, T_text] float32, in the
    autoregressive models' alignment layout."""
    return F.one_hot(idx.long(), T_text).float() * frame_mask[..., None].float()


def frame_energy(mel, frame_mask):
    """The energy adaptor's per-frame target: the mean of the (normalized)
    mel over channels on the real frames. mel [B, M, n_mels] -> [B, M]."""
    return mel.mean(-1) * frame_mask.to(mel.dtype)


class ParallelTTSLoss:
    """Masked L1 (decoder + postnet) + duration_alpha x the masked MSE on
    log(1 + duration); an energy model adds energy_alpha x the masked MSE
    of its energy track against `frame_energy` of the target."""

    def __init__(self, duration_alpha: float = 0.1, energy_alpha: float = 0.1):
        self.duration_alpha, self.energy_alpha = duration_alpha, energy_alpha

    def __call__(self, outputs, mel_target, durations, text_lengths):
        fm = outputs["frame_mask"].float()
        m = fm[..., None]
        denom = torch.clamp(m.sum() * mel_target.shape[-1], min=1.0)
        tgt = mel_target[:, : outputs["decoder_outputs"].shape[1]]
        l_dec = ((outputs["decoder_outputs"] - tgt) * m).abs().sum() / denom
        l_post = ((outputs["postnet_outputs"] - tgt) * m).abs().sum() / denom
        tok = sequence_mask(text_lengths, durations.shape[1]).float()
        logd_t = torch.log1p(durations.float())
        l_dur = (((outputs["log_durations"] - logd_t) ** 2) * tok).sum() \
            / torch.clamp(tok.sum(), min=1.0)
        total = l_dec + l_post + self.duration_alpha * l_dur
        parts = {"loss_decoder": l_dec, "loss_postnet": l_post, "loss_duration": l_dur}
        if "energy_pred" in outputs:
            e_t = frame_energy(tgt, outputs["frame_mask"])
            l_en = (((outputs["energy_pred"] - e_t) ** 2) * fm).sum() \
                / torch.clamp(fm.sum(), min=1.0)
            total = total + self.energy_alpha * l_en
            parts["loss_energy"] = l_en
        parts["loss"] = total
        return total, parts


def repair_row_durations(d, mel_len: int, T: int):
    """Repair one duration row (int64 [<= T]) so that it sums to the
    loader's mel length: a deficit goes onto the last real token, an excess
    comes off the tail tokens (never below zero)."""
    d = np.asarray(d, np.int64)[:T].copy()
    diff = int(mel_len) - int(d.sum())
    if diff > 0:
        nz = np.nonzero(d)[0]
        d[nz[-1] if len(nz) else 0] += diff
    elif diff < 0:
        excess = -diff
        for j in range(len(d) - 1, -1, -1):
            take = min(excess, int(d[j]))
            d[j] -= take
            excess -= take
            if excess == 0:
                break
    return d


def uniform_durations(text_lengths, mel_lengths, T_text: int):
    """Each row's mel frames spread uniformly over its real tokens (the
    remainder on the leading ones), 0 on pad tokens: int32 [B, T_text]
    summing exactly to mel_lengths."""
    tl = torch.as_tensor(text_lengths).long()
    ml = torch.as_tensor(mel_lengths, device=tl.device).long()
    base = ml // torch.clamp(tl, min=1)
    rem = ml - base * tl
    t = torch.arange(T_text, device=tl.device)[None, :]
    return (base[:, None] * (t < tl[:, None]) + (t < rem[:, None])).int()
