"""Synthesizer, the serving facade (the JAX package's infer/synthesizer.py):
loads a Tacotron2 or Tacotron(1) checkpoint (and optionally a MelGAN, PWGAN
or WaveRNN vocoder, which serves Tacotron2's mels, and a speakers.json
that conditions the model on speakers), splits input into sentences,
synthesizes every sentence of every request in one batch a conditioning
mode, and joins each request's sentences with 0.25 s of silence; or
streams a text chunk by chunk (`tts_streaming`). Runs on CUDA unless given
another device."""

from __future__ import annotations

import dataclasses
import io
import re
import threading
import wave

import numpy as np
import torch

from .. import resolve_device
from ..audio import AudioProcessor
from ..config import Config, load_config
from ..models import setup_model
from ..text import phonemes, symbols
from ..train.checkpoint import load_checkpoint
from ..utils.speakers import load_speaker_mapping, parse_speakers
from .synthesis import synthesis_batch, text_to_seq

_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+|\n+")


def split_into_sentences(text: str) -> list[str]:
    parts = [s.strip() for s in _SENTENCE_RE.split(text)]
    return [s for s in parts if s]


def stream_pieces(text: str, chunk_chars: int = 120) -> list[str]:
    """The text chunks `tts_streaming` decodes one after another: its
    sentences, each longer than chunk_chars cut every chunk_chars
    characters."""
    pieces: list[str] = []
    for s in split_into_sentences(text) or [text]:
        while len(s) > chunk_chars:
            pieces.append(s[:chunk_chars])
            s = s[chunk_chars:]
        pieces.append(s)
    return pieces


class Synthesizer:
    def __init__(self, tts_config: str | Config, tts_checkpoint: str | None = None,
                 vocoder_config=None, vocoder_checkpoint: str | None = None,
                 rng_seed: int = 0, device=None, decode_dtype=torch.bfloat16,
                 speakers_json: str | None = None):
        """tts_checkpoint: a JAX-package `.npz` checkpoint; without one the
        model keeps seeded random weights. vocoder_config (a path or a
        VocoderConfig) adds a MelGAN, PWGAN or WaveRNN vocoder in place of
        Griffin-Lim, with the weights of vocoder_checkpoint. speakers_json
        (`utils/speakers.py`) conditions the model on its speakers: by id
        (the model's own table) or by their d-vectors. A phoneme config
        builds the model on the phoneme table, and a checkpoint's
        `g2p_backend` meta pins the G2P backend it was trained with.
        rng_seed seeds the
        Griffin-Lim phases and the vocoder's draws; decode_dtype is the
        decode's working type. `lock` serializes the device work of
        `tts_many` and of each `tts_streaming` chunk, which a server runs
        on different threads: they share the cached decode weights, the
        Griffin-Lim phase generator and the kernels' launch counters, and
        one cooperative decode launch must not race another."""
        self.cfg = load_config(tts_config) if isinstance(tts_config, str) else tts_config
        self.device = resolve_device(device)
        self.decode_dtype = decode_dtype
        self.lock = threading.Lock()
        self.ap = AudioProcessor(self.cfg.audio, self.device, seed=rng_seed)
        self.speaker_ids: dict[str, int] = {}
        self.speaker_embeddings = None
        spk_dim = 0
        if speakers_json:
            self.speaker_ids, self.speaker_embeddings = parse_speakers(
                load_speaker_mapping(speakers_json))
            if self.speaker_embeddings:
                spk_dim = len(next(iter(self.speaker_embeddings.values())))
        num_chars = len(phonemes) if self.cfg.data.use_phonemes else len(symbols)
        self.model = setup_model(num_chars, self.cfg, self.device,
                                 num_speakers=len(self.speaker_ids), speaker_embedding_dim=spk_dim)
        if tts_checkpoint:
            meta = load_checkpoint(self.model, tts_checkpoint)
            if meta.get("g2p_backend") and self.cfg.data.use_phonemes and \
                    self.cfg.data.g2p_backend != meta["g2p_backend"]:
                # the phoneme stream the model was trained on
                self.cfg = dataclasses.replace(self.cfg, data=dataclasses.replace(
                    self.cfg.data, g2p_backend=meta["g2p_backend"]))
            if "r" in meta:
                self.model.set_r(meta["r"])
        self.vocoder = None
        if vocoder_config is not None:
            self.load_vocoder(vocoder_config, vocoder_checkpoint, rng_seed)

    def load_vocoder(self, vocoder_config, checkpoint: str | None, rng_seed: int = 0) -> None:
        from ..vocoder.synthesizer import VocoderSynthesizer

        self.vocoder = VocoderSynthesizer(vocoder_config, checkpoint, tts_audio_cfg=self.cfg.audio,
                                          rng_seed=rng_seed, device=self.device)

    def _resolve_speaker(self, speaker):
        """speaker (name, id, numeric string or None) -> ("none", None),
        ("id", int) or ("dvec", d-vector); the JAX package's rules and
        messages. Without a speakers.json every speaker reads as none."""
        if speaker is None or not self.speaker_ids:
            return "none", None
        if isinstance(speaker, str) and speaker not in self.speaker_ids:
            try:  # HTTP query strings arrive as text: "2" means id 2
                speaker = int(speaker)
            except ValueError:
                raise ValueError(f"unknown speaker {speaker!r}; known: "
                                 f"{sorted(self.speaker_ids)}") from None
        if isinstance(speaker, str):
            sid = self.speaker_ids[speaker]
        else:
            sid = int(speaker)
            if not 0 <= sid < len(self.speaker_ids):
                raise ValueError(f"speaker id {sid} out of range "
                                 f"0..{len(self.speaker_ids) - 1}")
        if self.speaker_embeddings:
            name = speaker if isinstance(speaker, str) else sorted(self.speaker_embeddings)[sid]
            return "dvec", np.asarray(self.speaker_embeddings[name], np.float32)
        return "id", sid

    def tts(self, text: str, speaker=None, style_wav: np.ndarray | None = None) -> np.ndarray:
        """Text -> waveform (float32), in `speaker`'s voice where the model
        is conditioned (`_resolve_speaker`), in the style of style_wav (a
        waveform at the config's sample rate) for a GST model."""
        return self.tts_many([text], [speaker], style_wav=style_wav)[0]

    def tts_many(self, texts: list[str], speakers: list | None = None,
                 style_wav: np.ndarray | None = None) -> list[np.ndarray]:
        """Several independent requests in one device batch a conditioning
        mode (none, speaker id, d-vector): the sentences of every request
        of a mode ride a single `synthesis_batch`, then regroup per
        request. speakers: one a text (see `tts`), or None; style_wav
        styles every request (see `tts`)."""
        speakers = [None] * len(texts) if speakers is None else list(speakers)
        if len(speakers) != len(texts):
            raise ValueError(f"{len(texts)} texts but {len(speakers)} speakers")
        with self.lock:
            return self._tts_many(texts, speakers, style_wav)

    def _tts_many(self, texts: list[str], speakers: list, style_wav) -> list[np.ndarray]:
        sent_of_req: list[list[int]] = []
        flat: list[str] = []
        modes: list[tuple] = []
        for text, speaker in zip(texts, speakers):
            mode = self._resolve_speaker(speaker)
            sentences = split_into_sentences(text) or [text]
            sent_of_req.append(list(range(len(flat), len(flat) + len(sentences))))
            flat += sentences
            modes += [mode] * len(sentences)
        results: list = [None] * len(flat)
        for mode in ("none", "id", "dvec"):
            rows = [i for i, m in enumerate(modes) if m[0] == mode]
            if not rows:
                continue
            spk = {}
            if mode == "id":
                spk["speaker_ids"] = np.asarray([modes[i][1] for i in rows], np.int64)
            elif mode == "dvec":
                spk["d_vectors"] = np.stack([modes[i][1] for i in rows])
            got = synthesis_batch(self.model, [flat[i] for i in rows], self.cfg, self.ap,
                                  trim_silence=True, decode_dtype=self.decode_dtype,
                                  vocoder=self.vocoder.mel_to_wav if self.vocoder else None,
                                  style_wav=style_wav, **spk)
            for i, res in zip(rows, got):
                results[i] = res
        silence = np.zeros(int(0.25 * self.ap.sample_rate), np.float32)
        out = []
        for idxs in sent_of_req:
            pieces = []
            for j, i in enumerate(idxs):
                if j:
                    pieces.append(silence)
                pieces.append(np.asarray(results[i]["wav"], np.float32))
            out.append(np.concatenate(pieces))
        return out

    def tts_streaming(self, text: str, chunk_chars: int = 120, speaker=None):
        """Generator of waveform chunks, one a text piece (`stream_pieces`),
        each yielded as soon as it is decoded and vocoded: the decoder's
        LSTM states and last frame carry over from piece to piece through
        `Tacotron2.inference_truncated`, so a long text streams with memory
        bounded by the chunk. `speaker` conditions every piece (as in
        `tts`). As in the JAX package, streaming ignores
        `inference_compute_dtype`: the encoder and postnet run in float32,
        the decode in `decode_dtype` (bf16, the kernel's). Streaming
        bypasses the batching of `tts_many`; the lock is held for each
        piece's device work, never across a yield. A model without
        `inference_truncated` (Tacotron(1)) yields one `tts` waveform."""
        if not hasattr(self.model, "inference_truncated"):
            yield self.tts(text, speaker=speaker)
            return
        mode, val = self._resolve_speaker(speaker)
        spk = {}
        if mode == "id":
            spk["speaker_ids"] = np.asarray([val], np.int64)
        elif mode == "dvec":
            spk["speaker_embeddings"] = np.asarray(val, np.float32)[None]
        stream = None
        for piece in stream_pieces(text, chunk_chars):
            seq = text_to_seq(piece, self.cfg)
            with self.lock:
                out, stream = self.model.inference_truncated(
                    seq[None], [len(seq)], decode_dtype=self.decode_dtype, stream_state=stream,
                    **spk)
                n = int(out["mel_lengths"][0])
                mel = out["postnet_outputs"][0, :max(n, 1)].cpu().numpy()
                wav = (self.vocoder.mel_to_wav(mel.T) if self.vocoder is not None
                       else self.ap.inv_melspectrogram_batch([mel.T])[0])
            yield np.asarray(wav, np.float32)

    def encode_wav_bytes(self, wav: np.ndarray) -> bytes:
        """Float waveform -> 16-bit mono WAV container bytes."""
        if wav.size == 0:
            wav = np.zeros((1,), np.float32)
        norm = wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))
        buf = io.BytesIO()
        with wave.open(buf, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(self.ap.sample_rate)
            f.writeframes(norm.astype(np.int16).tobytes())
        return buf.getvalue()

    def tts_to_wav_bytes(self, text: str, **kw) -> bytes:
        """`tts(text, **kw)` (e.g. speaker=) as WAV container bytes."""
        return self.encode_wav_bytes(self.tts(text, **kw))
