"""Synthesizer, the serving facade (the JAX package's infer/synthesizer.py):
loads a Tacotron2 or Tacotron(1) checkpoint (and optionally a WaveRNN
vocoder, which serves Tacotron2's mels), splits
input into sentences, synthesizes every sentence of every request in one
batch, and joins each request's sentences with 0.25 s of silence. Runs on
CUDA unless given another device."""

from __future__ import annotations

import io
import re
import wave

import numpy as np
import torch

from .. import resolve_device
from ..audio import AudioProcessor
from ..config import Config, load_config
from ..models import setup_model
from ..text import symbols
from ..train.checkpoint import load_checkpoint
from .synthesis import synthesis_batch

_SENTENCE_RE = re.compile(r"(?<=[.!?])\s+|\n+")


def split_into_sentences(text: str) -> list[str]:
    parts = [s.strip() for s in _SENTENCE_RE.split(text)]
    return [s for s in parts if s]


class Synthesizer:
    def __init__(self, tts_config: str | Config, tts_checkpoint: str | None = None,
                 vocoder_config=None, vocoder_checkpoint: str | None = None,
                 rng_seed: int = 0, device=None, decode_dtype=torch.bfloat16):
        """tts_checkpoint: a JAX-package `.npz` checkpoint; without one the
        model keeps seeded random weights. vocoder_config (a path or a
        VocoderConfig) adds a WaveRNN vocoder in place of Griffin-Lim, with
        the weights of vocoder_checkpoint. rng_seed seeds the Griffin-Lim
        phases and the vocoder's draws; decode_dtype is the decode's working
        type."""
        self.cfg = load_config(tts_config) if isinstance(tts_config, str) else tts_config
        self.device = resolve_device(device)
        self.decode_dtype = decode_dtype
        self.ap = AudioProcessor(self.cfg.audio, self.device, seed=rng_seed)
        self.model = setup_model(len(symbols), self.cfg, self.device)
        if tts_checkpoint:
            meta = load_checkpoint(self.model, tts_checkpoint)
            if "r" in meta:
                self.model.set_r(meta["r"])
        self.vocoder = None
        if vocoder_config is not None:
            self.load_vocoder(vocoder_config, vocoder_checkpoint, rng_seed)

    def load_vocoder(self, vocoder_config, checkpoint: str | None, rng_seed: int = 0) -> None:
        from ..vocoder.synthesizer import VocoderSynthesizer

        self.vocoder = VocoderSynthesizer(vocoder_config, checkpoint, tts_audio_cfg=self.cfg.audio,
                                          rng_seed=rng_seed, device=self.device)

    def tts(self, text: str) -> np.ndarray:
        """Text -> waveform (float32)."""
        return self.tts_many([text])[0]

    def tts_many(self, texts: list[str]) -> list[np.ndarray]:
        """Several independent requests in ONE device batch: all sentences
        of all requests ride a single `synthesis_batch`, then regroup per
        request."""
        sent_of_req: list[list[int]] = []
        flat: list[str] = []
        for text in texts:
            sentences = split_into_sentences(text) or [text]
            sent_of_req.append(list(range(len(flat), len(flat) + len(sentences))))
            flat += sentences
        results = synthesis_batch(self.model, flat, self.cfg, self.ap, trim_silence=True,
                                  decode_dtype=self.decode_dtype,
                                  vocoder=self.vocoder.mel_to_wav if self.vocoder else None)
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

    def tts_to_wav_bytes(self, text: str) -> bytes:
        return self.encode_wav_bytes(self.tts(text))
