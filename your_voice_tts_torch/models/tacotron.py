"""Tacotron(1) (the JAX package's models/tacotron.py): embedding -> prenet ->
CBHG encoder (conv bank, max pool, projections, highways, BiGRU) -> GRU
decoder with a memory queue of the last frames, location-sensitive
attention, two residual GRUs and an r-frame mel projection with a stop
token -> PostCBHG -> a LINEAR spectrogram head, which Griffin-Lim inverts
directly.

The decode loop follows the reference's kernel route
(`TacotronDecoder.inference_pallas`): it runs on the decode kernel
(ops/taco1_decode.py), with the decoder prenet's dropout from the hash PRNG
seeded by `seed`, and a row that has stopped keeps advancing its state with
zeroed frames until the chunk's end. The encoder prenet's dropout stays on
at inference too, as in the reference; the reference draws it from a
threefry key, which torch cannot reproduce, so the port draws it from a
torch.Generator seeded by `seed` on the model's device, fresh per call.

Conditioning (the reference's `_encode`): a GST model adds the style of a
reference mel to the CBHG outputs, then a speaker vector (a row of the
model's own table, tacotron_width wide, or an external d-vector) is
concatenated onto every position, so the decode kernel sees
E = 2 * (tacotron_width // 2) + spk_dim.

Training (`forward`, the reference's `Tacotron.forward`) is teacher-forced:
the memory queue of every step is gathered from the target mels at once,
the prenet runs over all of them, and a Python loop of T_mel / r steps
runs under autograd over `ops.taco1_decode.decoder_step`, the step function
of the decode's plain version, on the module's parameters. The reference
trains Tacotron(1) through a scan of its step, with no kernel, so this is
plain PyTorch on the card too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..nn.core import GAINS, BatchNorm1d, Conv1d, Dense, Embedding, xavier_uniform_
from ..nn.rnn import GRUCell, run_rnn
from ..ops.prng import HashDraws
from ..ops.taco1_decode import _interleave_gru, decoder_step, prepare_weights, tacotron1_decode
from .attention import init_attn
from .common import (Prenet, ServingWeights, add_style, cached_decode_weights, compute_copy,
                     concat_speaker, kernel_prenet, sequence_mask)
from .gst import GST


class Highway(nn.Module):
    """relu(H x) * t + x * (1 - t), t = sigmoid(T x); T's bias starts at -1
    (toward carrying x)."""

    def __init__(self, dim: int):
        super().__init__()
        self.H = Dense(dim, dim)
        self.T = Dense(dim, dim)

    def forward(self, x):
        t = torch.sigmoid(self.T(x))
        return torch.relu(self.H(x)) * t + x * (1.0 - t)


class CBHG(nn.Module):
    """Conv bank (kernel sizes 1..K, "same" padding) -> BatchNorm + ReLU ->
    max pool of width 2, stride 1 ("SAME": one frame of -inf on the right)
    -> conv projections with BatchNorm (ReLU between) -> residual when the
    widths match -> highways -> BiGRU over the full padded length."""

    def __init__(self, in_dim: int, K: int = 16, bank_channels: int = 128,
                 projections: tuple[int, ...] = (128, 128), highway_dim: int = 128,
                 gru_dim: int = 128, num_highways: int = 4):
        super().__init__()
        self.bank = nn.ModuleList(Conv1d(in_dim, bank_channels, k) for k in range(1, K + 1))
        self.bank_bn = BatchNorm1d(bank_channels * K)
        dims = (bank_channels * K,) + tuple(projections)
        self.projs = nn.ModuleList(Conv1d(dims[i], dims[i + 1], 3)
                                   for i in range(len(projections)))
        self.proj_bns = nn.ModuleList(BatchNorm1d(d) for d in projections)
        self.pre_highway = (Dense(projections[-1], highway_dim, bias=False)
                            if projections[-1] != highway_dim else None)
        self.highways = nn.ModuleList(Highway(highway_dim) for _ in range(num_highways))
        self.gru = nn.GRU(highway_dim, gru_dim, batch_first=True, bidirectional=True)
        self.out_dim = 2 * gru_dim

    def forward(self, x, mask=None):
        """x [B, T, C] -> [B, T, 2 * gru_dim]; `mask` [B, T] keeps pad frames
        out of training-mode BatchNorm statistics."""
        h = torch.relu(self.bank_bn(torch.cat([conv(x) for conv in self.bank], -1), mask))
        h = torch.maximum(h, F.pad(h[:, 1:], (0, 0, 0, 1), value=-math.inf))
        for i, (conv, bn) in enumerate(zip(self.projs, self.proj_bns)):
            h = bn(conv(h), mask)
            if i + 1 < len(self.projs):
                h = torch.relu(h)
        if h.shape[-1] == x.shape[-1]:
            h = h + x
        if self.pre_highway is not None:
            h = self.pre_highway(h)
        for hw in self.highways:
            h = hw(h)
        # unpacked, as the reference passes no lengths: the backward
        # direction starts inside the padding, which reaches valid outputs
        return run_rnn(self.gru, h)[0]


class TacotronDecoder(nn.Module):
    """GRU decoder with a memory queue. r_init sizes the mel projection and
    the stopnet; the active r takes a prefix slice, and each step's r frames
    join the queue, which keeps the last memory_size frames."""

    def __init__(self, in_dim: int, n_mels: int, r_init: int, memory_size: int, cfg):
        super().__init__()
        w = cfg.tacotron_width
        self.n_mels, self.r_init, self.cfg = n_mels, r_init, cfg
        self.memory_size = memory_size if memory_size > 0 else r_init
        self.prenet = Prenet(n_mels * self.memory_size, cfg.prenet_type, cfg.prenet_dropout,
                             (w, w // 2))
        self.attention_rnn = GRUCell(w // 2 + in_dim, w)
        if cfg.attention_type == "graves" or any(
                getattr(cfg, f) for f in ("windowing", "use_forward_attn", "transition_agent",
                                          "forward_attn_mask")):
            # the JAX package decodes these through its scan, not a kernel
            raise NotImplementedError("Tacotron(1) with Graves attention or the location "
                                      "attention's options arrives with a later slice of "
                                      "the port")
        self.attention = init_attn(cfg, w, in_dim)
        self.project = Dense(w + in_dim, w)
        self.decoder_rnns = nn.ModuleList([GRUCell(w, w), GRUCell(w, w)])
        self.proj_mel = Dense(w, n_mels * r_init)
        self.stopnet = Dense(w + n_mels * r_init, 1)
        self._prepared: dict = {}

    def decode_weights(self, dtype) -> dict:
        """The decode kernel's weight layout in `dtype`, cached
        (`cached_decode_weights`)."""
        return cached_decode_weights(self, dtype, self._build_decode_weights)

    def _build_decode_weights(self, dtype) -> dict:
        prenet, _ = kernel_prenet(self.prenet, self.cfg.prenet_dropout)
        a = self.attention
        gru = lambda c: (c.weight_ih, c.weight_hh, c.bias_ih, c.bias_hh)  # noqa: E731
        return prepare_weights(
            prenet, gru(self.attention_rnn), a.query.weight,
            a.location_kernel() if a.location_attention else None, a.v.weight, a.v.bias,
            (self.project.weight, self.project.bias),
            [gru(c) for c in self.decoder_rnns],
            (self.proj_mel.weight, self.proj_mel.bias),
            (self.stopnet.weight, self.stopnet.bias), n_mels=self.n_mels, dtype=dtype)

    def step_weights(self) -> tuple[dict, torch.Tensor]:
        """(`decoder_step`'s weights, the energy bias) from the module's
        parameters, differentiably: the GRUs' gate rows interleaved as
        `prepare_weights` lays them, the location filter folded
        (`location_kernel`), in the parameters' dtype."""
        a = self.attention
        W = {}
        for pre, c in (("a_", self.attention_rnn), ("d1_", self.decoder_rnns[0]),
                       ("d2_", self.decoder_rnns[1])):
            for k, t in (("wx", c.weight_ih), ("bx", c.bias_ih), ("wh", c.weight_hh),
                         ("bh", c.bias_hh)):
                W[pre + k] = _interleave_gru(t)
        q = a.query.weight
        W["q_w"] = q
        W["u"] = (a.location_kernel() if a.location_attention
                  else q.new_zeros(2, 1, q.shape[0]))
        W["v_w"], W["pj_w"], W["pj_b"] = a.v.weight[0], self.project.weight, self.project.bias
        return W, a.v.bias[0]

    def forward(self, inputs, input_lengths, mels, r: int,
                generator: torch.Generator | None = None):
        """Teacher-forced decode (the reference's `TacotronDecoder.forward`).
        inputs [B, T_in, E] encoder memory; mels [B, T_mel, n_mels] with
        T_mel % r == 0. Before step t the memory queue holds the target
        frames [t r - memory, t r), zeros before the first: one
        index_select over the mels padded by `memory` frames on the left.
        The prenet (dropout 0.5 from `generator`; none without one) runs
        over every step's queue at once, then `decoder_step` a step, in the
        parameters' dtype (the alignment in float32). Returns (frames
        [B, T_mel, n_mels], alignments [B, T_r, T_in] float32, stop logits
        [B, T_r]); with separate_stopnet the stopnet's input is detached."""
        B, T_mel, _ = mels.shape
        if T_mel % r:
            raise ValueError(f"mel length {T_mel} is not a multiple of r={r}")
        T_r, M, dev = T_mel // r, self.memory_size, mels.device
        mask = sequence_mask(input_lengths, inputs.shape[1])
        a = self.attention
        pinp = a.preprocess_inputs(inputs)
        idx = ((torch.arange(T_r, device=dev) * r)[:, None]
               + torch.arange(M, device=dev)[None, :]).flatten()
        queues = F.pad(mels, (0, 0, M, 0)).index_select(1, idx).reshape(B, T_r,
                                                                        M * self.n_mels)
        prenet_t = self.prenet(queues, generator).transpose(0, 1)        # [T_r, B, P2]
        W, v_b = self.step_weights()
        dt = W["pj_w"].dtype
        rnd = lambda x: x.to(dt)  # noqa: E731
        maskadd = torch.where(mask, 0.0, -1e9).to(torch.float32)
        H, D, E, T = self.attention_rnn.hidden_size, self.project.weight.shape[0], \
            inputs.shape[2], inputs.shape[1]
        z = lambda n, t=dt: torch.zeros(B, n, device=dev, dtype=t)  # noqa: E731
        state = (z(H), z(D), z(D), z(E), z(T, torch.float32), z(T, torch.float32))
        outs, aligns, stops = [], [], []
        for t in range(T_r):
            state, xd = decoder_step(W, v_b, prenet_t[t], state, inputs, pinp, maskadd,
                                     a.norm, rnd)
            out = self.proj_mel(xd)
            stop_in = torch.cat([xd, out], -1)
            if self.cfg.separate_stopnet:
                stop_in = stop_in.detach()
            stops.append(self.stopnet(stop_in)[:, 0])
            outs.append(out[:, : self.n_mels * r])
            aligns.append(state[4])
        frames = torch.stack(outs, 1).reshape(B, T_mel, self.n_mels)
        return frames, torch.stack(aligns, 1), torch.stack(stops, 1)

    @torch.no_grad()
    def inference(self, inputs, input_lengths, max_steps: int, r: int, seed: int = 0,
                  dtype=torch.bfloat16, compute_dtype=None, traced=None):
        """inputs [B, T, E] encoder memory -> (frames [B, max_steps * r,
        n_mels], alignments [B, max_steps, T], stop probabilities
        [B, max_steps], lengths [B] in mel frames). With a compute_dtype
        the memory's key projection W_k m runs in it (the decode itself
        keeps its f32 state and `dtype` matrix inputs). traced: as
        `Decoder.inference`'s (models/tacotron2.py)."""
        B = inputs.shape[0]
        mask = sequence_mask(input_lengths, inputs.shape[1])
        if compute_dtype is None:
            pinp = self.attention.preprocess_inputs(inputs)
        else:
            key_proj = (compute_copy(self.attention, "inputs", compute_dtype) if traced is None
                        else traced.cast("decoder.attention.inputs"))
            pinp = key_proj(inputs.to(compute_dtype)).float()
            inputs = inputs.float()
        _, dropout = kernel_prenet(self.prenet, self.cfg.prenet_dropout)
        kw = dict(r=r, max_steps=max_steps, norm=self.attention.norm,
                  thresh=self.cfg.stop_threshold, prenet_dropout=dropout)
        if traced is not None:
            out, aligns, stops, lengths = traced.decode(inputs, pinp, mask, seed, **kw)
        else:
            out, aligns, stops, lengths = tacotron1_decode(
                self.decode_weights(dtype), inputs, pinp, mask, seed=seed, **kw)
        dec_out = out[..., : self.n_mels * r].transpose(0, 1) \
            .reshape(B, max_steps * r, self.n_mels)
        return dec_out, aligns.transpose(0, 1), stops.transpose(0, 1), lengths * r


class Tacotron(nn.Module):
    """Tacotron(1): mel decoder + PostCBHG linear-spectrogram head. Widths
    scale with cfg.tacotron_width (the reference's 256)."""

    output_type = "linear"
    # the modules inference runs through `compute_copy` under a compute dtype
    COMPUTE_COPIES = ("embedding", "enc_prenet", "encoder_cbhg", "gst", "speaker_embedding",
                      "post_cbhg", "last_linear", "decoder.attention.inputs")

    def __init__(self, num_chars: int, cfg, n_mels: int = 80, num_freq: int = 513,
                 r_init: int | None = None, device=None, seed: int = 0,
                 num_speakers: int = 0, speaker_embedding_dim: int = 0,
                 use_gst: bool = False, gst_cfg=None):
        """Weights start seeded random (`seed`, drawn on the CPU from a
        torch.Generator); the model then moves to `device` (CUDA unless
        given). num_speakers > 0 conditions on speakers: external d-vectors
        of width speaker_embedding_dim, or with speaker_embedding_dim 0 a
        table of tacotron_width-wide rows, one a speaker id. use_gst adds
        Global Style Tokens (gst_cfg: a GSTConfig) projected to the CBHG's
        output width."""
        super().__init__()
        self.cfg = cfg
        self.n_mels, self.num_freq = n_mels, num_freq
        self.r = cfg.r
        self.r_init = max(r_init or cfg.r, cfg.r)
        w, h = cfg.tacotron_width, cfg.tacotron_width // 2
        self.num_speakers = num_speakers
        self.use_external_speaker_embedding = num_speakers > 0 and speaker_embedding_dim > 0
        self.spk_dim = 0 if num_speakers == 0 else (speaker_embedding_dim or w)
        self.embedding = Embedding(num_chars, w)
        self.enc_prenet = Prenet(w, cfg.prenet_type, cfg.prenet_dropout, (w, h))
        self.encoder_cbhg = CBHG(h, bank_channels=h, projections=(h, h), highway_dim=h,
                                 gru_dim=h)
        self.use_gst = use_gst
        if use_gst:
            self.gst = GST(n_mels, self.encoder_cbhg.out_dim, gst_cfg)
        self.decoder = TacotronDecoder(self.encoder_cbhg.out_dim + self.spk_dim, n_mels,
                                       self.r_init, cfg.memory_size, cfg)
        self.post_cbhg = CBHG(n_mels, K=8, projections=(w, n_mels), highway_dim=h, gru_dim=h)
        self.last_linear = Dense(self.post_cbhg.out_dim, num_freq)
        if num_speakers > 0 and not self.use_external_speaker_embedding:
            self.speaker_embedding = Embedding(num_speakers, self.spk_dim)
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
        xavier-uniform Linear/Conv weights (gains: relu for the conv bank,
        the inner projections and the highways' H; tanh for the attention's
        query, inputs and location dense; linear elsewhere), zero biases but
        the highways' T at -1, N(0, 0.3) embeddings, U(-1/sqrt(H), 1/sqrt(H))
        GRUs (biases too)."""
        gain = {}
        for cbhg in (self.encoder_cbhg, self.post_cbhg):
            for conv in cbhg.bank:
                gain[id(conv)] = GAINS["relu"]
            for conv in cbhg.projs[:-1]:
                gain[id(conv)] = GAINS["relu"]
            for hw in cbhg.highways:
                gain[id(hw.H)] = GAINS["relu"]
        a = self.decoder.attention
        for lin in (a.query, a.inputs) + ((a.loc_dense,) if a.location_attention else ()):
            gain[id(lin)] = GAINS["tanh"]
        for mod in self.modules():
            if isinstance(mod, (Dense, Conv1d)):
                xavier_uniform_(mod.weight, gain.get(id(mod), 1.0), generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, Embedding):
                mod.weight.normal_(0.0, 0.3, generator=generator)
            elif isinstance(mod, (GRUCell, nn.GRU)):
                s = 1.0 / math.sqrt(mod.hidden_size)
                for p in mod.parameters():
                    p.uniform_(-s, s, generator=generator)
        for cbhg in (self.encoder_cbhg, self.post_cbhg):
            for hw in cbhg.highways:
                hw.T.bias.fill_(-1.0)
        if self.use_gst:
            self.gst.init_random_(generator)

    def _encode(self, text, speaker_ids=None, speaker_embeddings=None, style_mel=None,
                generator: torch.Generator | None = None, cast=None, style_len=None):
        """text [B, T] ids -> encoder memory [B, T, E]: embedding, prenet
        (dropout from `generator`), CBHG; then the style of style_mel added
        (GST; with style_len [B], each row's read at its last real frame)
        and the speaker vector concatenated (`add_style`,
        `concat_speaker`). cast(name) gives the module that runs (a
        compute-dtype copy, or the module itself without one)."""
        cast = cast or (lambda name: getattr(self, name))  # noqa: E731
        enc_out = cast("encoder_cbhg")(cast("enc_prenet")(cast("embedding")(text), generator))
        enc_out = add_style(self, enc_out, style_mel, cast, style_len)
        return concat_speaker(self, enc_out, speaker_ids, speaker_embeddings, cast)

    def forward(self, text, text_lengths, mels, mel_lengths=None, r: int | None = None,
                generator: torch.Generator | None = None, speaker_ids=None,
                speaker_embeddings=None) -> dict:
        """Teacher-forced pass (the reference's `Tacotron.forward`): text
        [B, T] ids, text_lengths [B], mels [B, T_mel, n_mels] in the working
        dtype, mel_lengths [B] (masks the PostCBHG's BatchNorm statistics;
        the encoder CBHG's take every frame, as in the reference). In
        training mode BatchNorm takes batch statistics and updates its
        running ones; dropout is drawn from `generator` (none without one).
        The memory is conditioned as at inference (`_encode`): a GST model
        takes the teacher mels as its style, a speaker-conditioned model
        speaker_ids [B] or speaker_embeddings [B, spk_dim]. Returns
        decoder_outputs (mel [B, T_mel, n_mels]), postnet_outputs (linear
        [B, T_mel, num_freq]), alignments [B, T_r, T_in] float32,
        stop_logits [B, T_r], and "state": the BatchNorm running statistics
        after the pass."""
        r = r or self.r
        enc_out = self._encode(text, speaker_ids, speaker_embeddings, style_mel=mels,
                               generator=generator, style_len=mel_lengths)
        dec_out, aligns, stops = self.decoder(enc_out, text_lengths, mels, r, generator)
        mel_mask = None if mel_lengths is None else sequence_mask(mel_lengths, dec_out.shape[1])
        return {
            "decoder_outputs": dec_out,
            "postnet_outputs": self.last_linear(self.post_cbhg(dec_out, mel_mask)),
            "alignments": aligns,
            "stop_logits": stops,
            "state": {k: v.detach().clone() for k, v in self.named_buffers()},
        }

    def serving_weights(self, compute_dtype=None, decode_dtype=torch.bfloat16) -> ServingWeights:
        """The `ServingWeights` a traced `inference` at these dtypes reads
        (the kernel's resident layout for this card's block count)."""
        from ..ops.taco1_decode import _blocks, pack_weights

        return ServingWeights(self, "taco1", self.COMPUTE_COPIES, compute_dtype, decode_dtype,
                              lambda w: pack_weights(w, _blocks(self.device)))

    @torch.no_grad()
    def inference(self, text, text_lengths, max_decoder_steps: int | None = None,
                  r: int | None = None, seed: int = 0, decode_dtype=torch.bfloat16,
                  compute_dtype=None, speaker_ids=None, speaker_embeddings=None,
                  style_mel=None, traced: ServingWeights | None = None):
        """Free-running synthesis on the model's device (the signature of
        `Tacotron2.inference`, compute_dtype included: bf16 runs the
        embedding, encoder prenet and CBHG, the key projection and the
        PostCBHG head in bf16, outputs float32). text [B, T] symbol ids, text_lengths [B].
        Returns decoder_outputs (mel [B, T_out, n_mels]), postnet_outputs
        (linear [B, T_out, num_freq]), alignments, stop_probs and mel_lengths
        (in frames; frames past a row's length decode from zeros). `seed`
        seeds both prenets' dropout. BatchNorm normalizes with its running
        statistics whatever the module's mode. A speaker-conditioned model
        takes speaker_ids [B] or speaker_embeddings [B, spk_dim], a GST
        model style_mel [B or 1, T_style, n_mels], as `Tacotron2.inference`
        does. traced: the route of a traced program, as
        `Tacotron2.inference`'s; the encoder prenet's dropout then draws from
        the hash PRNG on the seed tensor (`ops.prng.HashDraws`)."""
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
            gen = None
            if self.enc_prenet.dropout_enabled:
                gen = (HashDraws(seed) if traced is not None
                       else torch.Generator(device=dev).manual_seed(seed))
            enc_out = self._encode(text, speaker_ids, speaker_embeddings, style_mel, gen, cast)
            dec_out, aligns, stops, lengths = self.decoder.inference(
                enc_out, text_lengths, max_steps, r, seed=seed, dtype=decode_dtype,
                compute_dtype=dt, traced=traced)
            if dt is not None:
                dec_out = dec_out.to(dt)
            linear = cast("last_linear")(cast("post_cbhg")(dec_out))
        finally:
            self.train(was_training)
        if dt is not None:
            dec_out, linear = dec_out.float(), linear.float()
        return {
            "decoder_outputs": dec_out,
            "postnet_outputs": linear,
            "alignments": aligns,
            "stop_probs": stops,
            "mel_lengths": lengths,
        }
