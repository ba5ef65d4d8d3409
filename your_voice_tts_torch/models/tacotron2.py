"""Tacotron2 (the JAX package's models/tacotron2.py): embedding -> 3 x
conv5+BN+ReLU -> BiLSTM encoder -> decoder (prenet, attention LSTM,
attention, decoder LSTM, mel x r projection and stop token) -> 5-conv
postnet residual. The attention is location-sensitive (with windowing,
forward attention, the transition agent or the forward mask as options)
or Graves GMM attention (models/attention.py).

`Tacotron2.forward` is the teacher-forced training pass: BatchNorm takes
batch statistics in training mode (the encoder's masked by the text
lengths, the postnet's by the mel lengths) and dropout is drawn from the
torch.Generator passed in. The decoder recurrence takes one of the JAX
package's two routes, by its own predicate (`Decoder.fast_grad_supported`):
plain location-sensitive attention runs on the training kernels through
the custom backward of models/decoder_grad.py; forward attention, the
transition agent and Graves run as a step loop under autograd
(`Decoder._scan`), as the reference's `lax.scan` over its `_step`. Either
way the projection and stopnet apply over the whole sequence outside it.
With `bidirectional_decoder` a second decoder, `decoder_backward`, reads
the time-reversed mels in training (the DDC terms of models/losses.py);
eval and inference never run it.

The decode loop follows the reference's kernel route (`Decoder.
inference_pallas`): it runs on the decode kernel (ops/taco2_decode.py), with
prenet dropout from the hash PRNG seeded by `seed`, and a row that has
stopped keeps advancing its state with zeroed frames until the chunk's end.
Every attention variant decodes there (`Decoder.attn_kernel_flags`).

Conditioning (the reference's `_condition`): a GST model adds the style
of a reference mel (models/gst.py) to every position of the encoder
outputs, keeping their width; then a speaker vector, a row of the model's
own table or an external d-vector, is concatenated onto every position,
so the decoder (and its decode kernel, or the training kernels) sees
E = encoder_dim + spk_dim. Training conditions the same way, with the
teacher mels as the style.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device
from ..nn.core import GAINS, Conv1d, Dense, Embedding, xavier_uniform_
from ..nn.rnn import LSTMCell, bilstm, bilstm_unpacked
from ..ops.taco2_decode import prepare_weights, tacotron2_decode
from .attention import GravesAttention, LocationSensitiveAttention, init_attn, key_projection
from .decoder_grad import DecoderCore, dropout_masks
from .common import (ConvBNBlock, Prenet, ServingWeights, add_style, cached_decode_weights,
                     compute_copy, concat_speaker, kernel_prenet, sequence_mask)
from .gst import GST


class Encoder(nn.Module):
    """3 conv blocks + BiLSTM."""

    def __init__(self, dim: int = 512):
        super().__init__()
        self.blocks = nn.ModuleList(ConvBNBlock(dim, dim, 5, "relu") for _ in range(3))
        self.lstm = nn.LSTM(dim, dim // 2, batch_first=True, bidirectional=True)
        # one summed bias per direction, as the JAX package's LSTMCell: the
        # second stays zero and out of training
        self.lstm.bias_hh_l0.requires_grad_(False)
        self.lstm.bias_hh_l0_reverse.requires_grad_(False)

    def forward(self, x, lengths, generator: torch.Generator | None = None,
                unpacked: bool = False):
        """x [B, T, C] -> [B, T, C]; unpacked runs the BiLSTM as
        `bilstm_unpacked` (a traced program)."""
        mask = sequence_mask(lengths, x.shape[1])
        for blk in self.blocks:
            x = blk(x, mask, generator)
        x = x * mask[..., None].to(x.dtype)
        return (bilstm_unpacked if unpacked else bilstm)(self.lstm, x, lengths)


class Postnet(nn.Module):
    """5 conv blocks refining the decoder output."""

    def __init__(self, n_mels: int, dim: int = 512, n_blocks: int = 5):
        super().__init__()
        blocks = [ConvBNBlock(n_mels, dim, 5, "tanh")]
        blocks += [ConvBNBlock(dim, dim, 5, "tanh") for _ in range(n_blocks - 2)]
        blocks += [ConvBNBlock(dim, n_mels, 5, None)]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, mask=None, generator: torch.Generator | None = None):
        for blk in self.blocks:
            x = blk(x, mask, generator)
        return x


class Decoder(nn.Module):
    """Free-running decoder. r_init is the largest reduction factor the
    model is trained with: the projection and stopnet are sized for it and
    the active r takes a prefix slice."""

    P_DROPOUT = 0.1  # attention / decoder LSTM output dropout in training

    def __init__(self, in_dim: int, n_mels: int, r_init: int, cfg):
        super().__init__()
        self.n_mels, self.r_init, self.cfg = n_mels, r_init, cfg
        self.prenet = Prenet(n_mels, cfg.prenet_type, cfg.prenet_dropout,
                             (cfg.prenet_dim, cfg.prenet_dim))
        self.attention_rnn = LSTMCell(cfg.prenet_dim + in_dim, cfg.attention_rnn_dim)
        self.attention = init_attn(cfg, cfg.attention_rnn_dim, in_dim)
        self.decoder_rnn = LSTMCell(cfg.attention_rnn_dim + in_dim, cfg.decoder_rnn_dim)
        self.projection = Dense(cfg.decoder_rnn_dim + in_dim, n_mels * r_init)
        self.stopnet = Dense(cfg.decoder_rnn_dim + n_mels * r_init, 1)
        self._prepared: dict = {}

    def decode_weights(self, dtype) -> dict:
        """The decode kernel's weight layout in `dtype`, cached
        (`cached_decode_weights`)."""
        return cached_decode_weights(self, dtype, self._build_decode_weights)

    def _build_decode_weights(self, dtype) -> dict:
        """What each attention reads: Graves its l1 and l2 in place of the
        query, location and v weights; the transition agent its `ta`."""
        prenet, _ = kernel_prenet(self.prenet, self.cfg.prenet_dropout)
        a = self.attention
        rnn = lambda c: (c.weight_ih, c.weight_hh, c.bias)  # noqa: E731
        rest = dict(decoder_rnn=rnn(self.decoder_rnn),
                    projection=(self.projection.weight, self.projection.bias),
                    stopnet=(self.stopnet.weight, self.stopnet.bias), dtype=dtype)
        if isinstance(a, GravesAttention):
            return prepare_weights(prenet, rnn(self.attention_rnn), None, None, None, None,
                                   graves=(a.l1.weight, a.l1.bias, a.l2.weight, a.l2.bias),
                                   **rest)
        return prepare_weights(
            prenet, rnn(self.attention_rnn), a.query.weight,
            a.location_kernel() if a.location_attention else None, a.v.weight, a.v.bias,
            trans_agent=(a.ta.weight, a.ta.bias) if a.trans_agent else None, **rest)

    def attn_kernel_flags(self) -> dict:
        """The attention options the decode is given (the JAX package's
        `Decoder._attn_kernel_flags`); Graves comes with its weights."""
        a = self.attention
        if isinstance(a, GravesAttention):
            return {}
        return dict(windowing=a.windowing, win_back=a.win_back, win_front=a.win_front,
                    forward_attn=a.forward_attn, trans_agent=a.trans_agent,
                    forward_attn_mask=a.forward_attn_mask)

    # fast_grad: train through the training kernels (DecoderCore) where the
    # attention allows it; tests clear it on an instance to hold the two
    # routes against each other
    fast_grad = True

    def fast_grad_supported(self) -> bool:
        """The JAX package's predicate for its custom-VJP core (kernels 5 and
        6): location-sensitive attention without forward attention or the
        transition agent, sigmoid or softmax norm. Anything else trains
        through the step loop (`_scan`)."""
        a = self.attention
        return (self.fast_grad and isinstance(a, LocationSensitiveAttention)
                and not a.forward_attn and not a.trans_agent
                and a.norm in ("sigmoid", "softmax"))

    def forward(self, inputs, input_lengths, mels, r: int,
                generator: torch.Generator | None = None):
        """Teacher-forced decode. inputs [B, T_in, E] encoder memory; mels
        [B, T_mel, n_mels] with T_mel % r == 0. The decoder input of step s
        is the go frame (s = 0) or the last frame of r-group s - 1. Dropout
        (prenet 0.5, LSTM outputs 0.1) is drawn from `generator` in training
        mode. Returns (frames [B, T_mel, n_mels], alignments [B, T_r, T_in]
        float32, stop logits [B, T_r]). Where `fast_grad_supported`, the
        recurrence runs on the training kernels; otherwise (forward
        attention, the transition agent, Graves) as the step loop `_scan`
        under autograd, as the JAX package's `lax.scan` over `_step`.
        Windowing acts at inference only."""
        a = self.attention
        B, T_mel, _ = mels.shape
        if T_mel % r:
            raise ValueError(f"mel length {T_mel} is not a multiple of r={r}")
        T_r = T_mel // r
        mask = sequence_mask(input_lengths, inputs.shape[1])
        pinp = a.preprocess_inputs(inputs)
        memories = torch.cat([torch.zeros_like(mels[:, :1]), mels[:, r - 1::r][:, :-1]], 1)
        prenet_t = self.prenet(memories, generator).transpose(0, 1)
        m_a = m_d = None
        if self.training and generator is not None:
            m_a, m_d = dropout_masks(T_r, B, self.attention_rnn.hidden,
                                     self.decoder_rnn.hidden, prenet_t.dtype, generator,
                                     prenet_t.device, self.P_DROPOUT)
        ar, dr = self.attention_rnn, self.decoder_rnn
        if self.fast_grad_supported():
            dech_t, ctx_t, aligns = DecoderCore.apply(
                prenet_t, inputs, pinp, mask.float(), m_a, m_d, a.norm,
                ar.weight_ih, ar.weight_hh, ar.bias, *a.energy_weights(),
                dr.weight_ih, dr.weight_hh, dr.bias)
        else:
            dech_t, ctx_t, aligns = self._scan(prenet_t, inputs, pinp, mask, m_a, m_d)
        dec_out = self.projection(torch.cat([dech_t, ctx_t], -1))      # [T_r, B, OW]
        stop_in = torch.cat([dech_t, dec_out], -1)
        if self.cfg.separate_stopnet:
            stop_in = stop_in.detach()
        stops = self.stopnet(stop_in)[..., 0]
        frames = dec_out.transpose(0, 1)[..., : self.n_mels * r].reshape(B, T_mel, self.n_mels)
        return frames, aligns.transpose(0, 1), stops.transpose(0, 1)

    def _scan(self, prenet_t, inputs, pinp, mask, m_a, m_d):
        """The JAX package's `_step` for each decoder step in turn, under
        autograd: the attention LSTM, dropout on its output (m_a [T_r, B, H1]
        multipliers, or none), the attention (`forward`, state carried), the
        context cast back to the working dtype, the decoder LSTM and its
        dropout (m_d). The projection and stopnet, which do not feed the
        recurrence, run over all steps in `forward`. Returns (decoder
        hidden [T_r, B, H2], contexts [T_r, B, E], alignments [T_r, B, T_in]
        float32), as `DecoderCore`. The contexts weigh a float32 copy of
        the memory, made once (JAX promotes a bf16 memory at each step's
        context; the same values, one saved tensor)."""
        T_r, B, _ = prenet_t.shape
        dt = prenet_t.dtype
        a, ar, dr = self.attention, self.attention_rnn, self.decoder_rnn
        hc_a = (prenet_t.new_zeros(B, ar.hidden),) * 2
        hc_d = (prenet_t.new_zeros(B, dr.hidden),) * 2
        ctx = prenet_t.new_zeros(B, inputs.shape[-1])
        state = a.init_state(B, inputs.shape[1], inputs.device)
        inputs = inputs.float()
        dech, ctxs, aligns = [], [], []
        for t in range(T_r):
            hc_a = ar(torch.cat([prenet_t[t], ctx], -1), hc_a)
            query = hc_a[0] if m_a is None else hc_a[0] * m_a[t]
            state, ctx, align = a(query, inputs, pinp, state, mask, ctx)
            ctx = ctx.to(dt)
            hc_d = dr(torch.cat([query, ctx], -1), hc_d)
            dech.append(hc_d[0] if m_d is None else hc_d[0] * m_d[t])
            ctxs.append(ctx)
            aligns.append(align)
        return torch.stack(dech), torch.stack(ctxs), torch.stack(aligns)

    @torch.no_grad()
    def inference(self, inputs, input_lengths, max_steps: int, r: int,
                  seed: int = 0, dtype=torch.bfloat16, compute_dtype=None, traced=None):
        """inputs [B, T, E] encoder memory -> (frames [B, max_steps * r,
        n_mels], alignments [B, max_steps, T], stop probabilities
        [B, max_steps], lengths [B] in mel frames). With a compute_dtype
        the memory's key projection W_k m runs in it (the decode itself
        keeps its f32 state and `dtype` matrix inputs). traced (a
        `ServingWeights`; `seed` then an int64 tensor [1]) takes the key
        projection's copy and the decode's weights from it and decodes
        through the registered op."""
        return self._decode(inputs, input_lengths, max_steps, r, seed, dtype, compute_dtype,
                            traced=traced)

    @torch.no_grad()
    def inference_truncated(self, inputs, input_lengths, max_steps: int, r: int,
                            seed: int = 0, dtype=torch.bfloat16, compute_dtype=None,
                            stream=None):
        """`inference` from a previous text chunk's stream state ((h1, c1),
        (h2, c2), last frame), or from zeros without one; attention starts
        afresh on this chunk's memory (the JAX package's
        `inference_truncated_pallas`). Returns `inference`'s outputs and
        the stream state to pass on, frozen where every row stopped (see
        ops/taco2_decode.py)."""
        return self._decode(inputs, input_lengths, max_steps, r, seed, dtype, compute_dtype,
                            stream=stream, return_stream=True)

    def _decode(self, inputs, input_lengths, max_steps, r, seed, dtype, compute_dtype,
                traced=None, **stream):
        B = inputs.shape[0]
        mask = sequence_mask(input_lengths, inputs.shape[1])
        if isinstance(self.attention, GravesAttention):
            pinp = None                                         # no key projection
        elif compute_dtype is None:
            pinp = key_projection(self.attention.inputs, inputs)
        else:
            key_proj = (compute_copy(self.attention, "inputs", compute_dtype) if traced is None
                        else traced.cast("decoder.attention.inputs"))
            pinp = key_projection(key_proj, inputs.to(compute_dtype)).float()
        inputs = inputs.float()
        _, dropout = kernel_prenet(self.prenet, self.cfg.prenet_dropout)
        kw = dict(r=r, max_steps=max_steps, norm=self.attention.norm,
                  thresh=self.cfg.stop_threshold, prenet_dropout=dropout,
                  **self.attn_kernel_flags())
        if traced is not None:
            out, aligns, stops, lengths = traced.decode(inputs, pinp, mask, seed, **kw)
            stream_out = []
        else:
            out, aligns, stops, lengths, *stream_out = tacotron2_decode(
                self.decode_weights(dtype), inputs, pinp, mask, seed=seed, **kw, **stream)
        dec_out = out[..., : self.n_mels * r].transpose(0, 1) \
            .reshape(B, max_steps * r, self.n_mels)
        return (dec_out, aligns.transpose(0, 1), stops.transpose(0, 1), lengths * r,
                *stream_out)


class Tacotron2(nn.Module):
    SPEAKER_TABLE_DIM = 512   # the internal table's width (the reference's default)
    # the modules inference runs through `compute_copy` under a compute dtype
    COMPUTE_COPIES = ("embedding", "encoder", "speaker_embedding", "gst", "postnet",
                      "decoder.attention.inputs")

    def __init__(self, num_chars: int, cfg, n_mels: int = 80,
                 r_init: int | None = None, device=None, seed: int = 0,
                 num_speakers: int = 0, speaker_embedding_dim: int = 0,
                 use_gst: bool = False, gst_cfg=None):
        """Weights start seeded random (`seed`, drawn on the CPU from a
        torch.Generator); the model then moves to `device` (CUDA unless
        given). num_speakers > 0 conditions on speakers: external d-vectors
        of width speaker_embedding_dim, or with speaker_embedding_dim 0 a
        table of SPEAKER_TABLE_DIM-wide rows, one a speaker id. use_gst adds
        Global Style Tokens (gst_cfg: a GSTConfig) projected to
        encoder_dim."""
        super().__init__()
        self.cfg = cfg
        self.n_mels = n_mels
        self.r = cfg.r
        self.r_init = max(r_init or cfg.r, cfg.r)
        self.num_speakers = num_speakers
        self.use_external_speaker_embedding = num_speakers > 0 and speaker_embedding_dim > 0
        self.spk_dim = 0 if num_speakers == 0 else (speaker_embedding_dim
                                                    or self.SPEAKER_TABLE_DIM)
        self.embedding = Embedding(num_chars, cfg.embedding_dim)
        self.encoder = Encoder(cfg.encoder_dim)
        self.decoder = Decoder(cfg.encoder_dim + self.spk_dim, n_mels, self.r_init, cfg)
        if cfg.bidirectional_decoder:
            # a second decoder of the same widths on the time-reversed mels,
            # in training only (the reference's bidirectional_decoder)
            self.decoder_backward = Decoder(cfg.encoder_dim + self.spk_dim, n_mels,
                                            self.r_init, cfg)
        self.postnet = Postnet(n_mels, cfg.postnet_dim)
        if num_speakers > 0 and not self.use_external_speaker_embedding:
            self.speaker_embedding = Embedding(num_speakers, self.spk_dim)
        self.use_gst = use_gst
        if use_gst:
            self.gst = GST(n_mels, cfg.encoder_dim, gst_cfg)
        self._init_random(torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.embedding.weight.device

    def set_r(self, r: int) -> None:
        if r > self.r_init:
            raise ValueError(f"r={r} exceeds r_init={self.r_init}")
        self.r = r

    @torch.no_grad()
    def _init_random(self, generator: torch.Generator) -> None:
        """Seeded random weights with the JAX package's init families:
        xavier-uniform Linear/Conv weights (nonlinearity gains), zero
        biases, N(0, 0.3) embeddings, U(-1/sqrt(H), 1/sqrt(H)) LSTMs."""
        gain = {id(m.conv): GAINS[m.activation or "linear"]
                for m in self.modules() if isinstance(m, ConvBNBlock)}
        for mod in self.modules():
            if isinstance(mod, (Dense, Conv1d)):
                xavier_uniform_(mod.weight, gain.get(id(mod), 1.0), generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Embedding):
                mod.weight.normal_(0.0, 0.3, generator=generator)
            elif isinstance(mod, (LSTMCell, nn.LSTM)):
                s = 1.0 / math.sqrt(mod.hidden if isinstance(mod, LSTMCell)
                                    else mod.hidden_size)
                for name, p in mod.named_parameters():
                    if name.startswith("bias_hh"):
                        p.zero_()
                    else:
                        p.uniform_(-s, s, generator=generator)
        for mod in self.modules():
            if isinstance(mod, GravesAttention):
                mod.init_bias()
        if self.use_gst:
            self.gst.init_random_(generator)

    def forward(self, text, text_lengths, mels, mel_lengths=None, r: int | None = None,
                generator: torch.Generator | None = None, speaker_ids=None,
                speaker_embeddings=None) -> dict:
        """Teacher-forced pass (the JAX package's `Tacotron2.forward`): text
        [B, T] ids, text_lengths [B], mels [B, T_mel, n_mels] in the working
        dtype, mel_lengths [B] (masks the postnet's BatchNorm statistics).
        In training mode BatchNorm takes batch statistics and updates its
        running ones (the GST reference encoder's too); dropout is drawn
        from `generator` (none without one). The memory is conditioned as
        at inference (`_condition`): a GST model takes the teacher mels as
        its style, each row's read at its last real frame of mel_lengths;
        a speaker-conditioned model takes speaker_ids [B] (table) or
        speaker_embeddings [B, spk_dim] (d-vectors), so the decoder's
        memory is E = encoder_dim + spk_dim wide. Returns decoder_outputs /
        postnet_outputs [B, T_mel, n_mels], alignments [B, T_r, T_in]
        float32, stop_logits [B, T_r], and "state": the BatchNorm running
        statistics after the pass. A bidirectional-decoder model in training
        mode also runs `decoder_backward` on the padded mels flipped along
        time (as the reference flips them: a short row's reversed sequence
        starts with its padding) and returns its frames flipped back,
        decoder_backward_outputs [B, T_mel, n_mels], and its
        alignments_backward [B, T_r, T_in]; eval mode never runs it."""
        r = r or self.r
        enc_out = self.encoder(self.embedding(text), text_lengths, generator)
        enc_out = self._condition(enc_out, speaker_ids, speaker_embeddings, style_mel=mels,
                                  style_len=mel_lengths)
        dec_out, aligns, stops = self.decoder(enc_out, text_lengths, mels, r, generator)
        mel_mask = None if mel_lengths is None else sequence_mask(mel_lengths, dec_out.shape[1])
        out = {
            "decoder_outputs": dec_out,
            "postnet_outputs": dec_out + self.postnet(dec_out, mel_mask, generator),
            "alignments": aligns,
            "stop_logits": stops,
        }
        if self.cfg.bidirectional_decoder and self.training:
            dec_b, out["alignments_backward"], _ = self.decoder_backward(
                enc_out, text_lengths, mels.flip(1), r, generator)
            out["decoder_backward_outputs"] = dec_b.flip(1)
        out["state"] = {k: v.detach().clone() for k, v in self.named_buffers()}
        return out

    def _condition(self, enc_out, speaker_ids=None, speaker_embeddings=None, cast=None,
                   style_mel=None, style_len=None):
        """enc_out [B, T, C] -> [B, T, C + spk_dim]: for a GST model the
        style of style_mel [B or 1, T_style, n_mels] (through `cast("gst")`;
        with style_len [B], each row's read at its last real frame) added to
        every position first; then the speaker vector of each row
        (its row of the table, `cast("speaker_embedding")` where a
        compute-dtype copy is wanted, or its d-vector from
        speaker_embeddings [B, spk_dim], float32) cast to the memory's dtype
        and concatenated onto every position; enc_out itself for an
        unconditioned model."""
        return concat_speaker(self, add_style(self, enc_out, style_mel, cast, style_len),
                              speaker_ids, speaker_embeddings, cast)

    def serving_weights(self, compute_dtype=None, decode_dtype=torch.bfloat16) -> ServingWeights:
        """The `ServingWeights` a traced `inference` at these dtypes reads."""
        from ..ops.taco2_decode import pack_weights

        return ServingWeights(self, "taco2", self.COMPUTE_COPIES, compute_dtype, decode_dtype,
                              pack_weights)

    @torch.no_grad()
    def inference(self, text, text_lengths, max_decoder_steps: int | None = None,
                  r: int | None = None, seed: int = 0, decode_dtype=torch.bfloat16,
                  compute_dtype=None, speaker_ids=None, speaker_embeddings=None,
                  style_mel=None, traced: ServingWeights | None = None):
        """Free-running synthesis on the model's device. text [B, T] symbol
        ids, text_lengths [B]. Output lengths are in mel frames; frames past
        a row's length are zero. decode_dtype is the decode's working type
        (the kernel runs bf16; the plain version also takes float32).
        compute_dtype=torch.bfloat16 runs the embedding, encoder, the
        memory's key projection and the postnet in bf16 (the reference's
        `compute_dtype`): the decode's f32 frames are cast to bf16 before
        the postnet, and every output comes back float32. None runs them
        in float32. BatchNorm normalizes with its running statistics
        whatever the module's mode, as the reference's inference does
        (train=False). A speaker-conditioned model takes speaker_ids [B]
        (table) or speaker_embeddings [B, spk_dim] (d-vectors), a GST model
        style_mel [B or 1, T_style, n_mels]; under a compute_dtype the table,
        the d-vectors, the style mel and the GST are cast to it, as the
        reference casts them.

        traced: the route a traced program (`infer/export.py`) takes, with
        the same outputs: `seed` is an int64 tensor [1] on the model's
        device, the BiLSTM runs unpacked, the compute-dtype copies and the
        decode's weights come from `traced` (`serving_weights`), and the
        decode runs through its registered op."""
        return self._infer(text, text_lengths, max_decoder_steps, r, seed, decode_dtype,
                           compute_dtype, speaker_ids, speaker_embeddings, style_mel,
                           traced=traced)

    @torch.no_grad()
    def inference_truncated(self, text, text_lengths, max_decoder_steps: int | None = None,
                            r: int | None = None, seed: int = 0, decode_dtype=torch.bfloat16,
                            compute_dtype=None, speaker_ids=None, speaker_embeddings=None,
                            stream_state=None, style_mel=None):
        """Streaming synthesis of one text chunk (the JAX package's
        `Tacotron2.inference_truncated` on its kernel route): `inference`
        with the decoder's LSTM states and last frame carried in from the
        previous chunk's `stream_state` ((h1, c1), (h2, c2), frame), or
        from zeros with None, and attention restarted on this chunk's
        memory. Returns (`inference`'s outputs, the stream state to pass to
        the next chunk); with stream_state=None the outputs equal
        `inference`'s."""
        return self._infer(text, text_lengths, max_decoder_steps, r, seed, decode_dtype,
                           compute_dtype, speaker_ids, speaker_embeddings, style_mel,
                           truncated=True, stream_state=stream_state)

    def _infer(self, text, text_lengths, max_decoder_steps, r, seed, decode_dtype,
               compute_dtype, speaker_ids, speaker_embeddings, style_mel, truncated=False,
               stream_state=None, traced=None):
        r = r or self.r
        max_steps = max_decoder_steps or self.cfg.max_decoder_steps
        dev = self.device
        text = torch.as_tensor(text, dtype=torch.long, device=dev)
        text_lengths = torch.as_tensor(text_lengths, dtype=torch.long, device=dev)
        dt = compute_dtype
        cast = (lambda name: getattr(self, name)) if dt is None else \
            traced.cast if traced is not None else \
            (lambda name: compute_copy(self, name, dt))  # noqa: E731
        was_training = self.training
        self.eval()
        try:
            enc_out = cast("encoder")(cast("embedding")(text), text_lengths,
                                      unpacked=traced is not None)
            enc_out = self._condition(enc_out, speaker_ids, speaker_embeddings, cast, style_mel)
            args = (enc_out, text_lengths, max_steps, r, seed, decode_dtype, dt)
            dec_out, aligns, stops, lengths, *stream_out = (
                self.decoder.inference_truncated(*args, stream=stream_state) if truncated
                else self.decoder.inference(*args, traced=traced))
            if dt is not None:
                dec_out = dec_out.to(dt)
            post = dec_out + cast("postnet")(dec_out)
        finally:
            self.train(was_training)
        if dt is not None:
            dec_out, post = dec_out.float(), post.float()
        out = {
            "decoder_outputs": dec_out,
            "postnet_outputs": post,
            "alignments": aligns,
            "stop_probs": stops,
            "mel_lengths": lengths,
        }
        return (out, stream_out[0]) if truncated else out

