"""Vocoder inference facade (the JAX package's vocoder/synthesizer.py):
normalized mel [n_mels, T] -> waveform. Wired into the TTS Synthesizer by
`Synthesizer.load_vocoder`. Runs on CUDA unless given another device."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..train.checkpoint import load_checkpoint
from .config import VocoderConfig, load_vocoder_config
from .models.wavernn import WaveRNN


class VocoderSynthesizer:
    def __init__(self, config: str | VocoderConfig, checkpoint: str | None = None,
                 tts_audio_cfg=None, rng_seed: int = 0, device=None):
        """checkpoint: a JAX-package WaveRNN `.npz`; without one the model
        keeps seeded random weights. rng_seed seeds the generator that draws
        one sample-loop seed per `mel_to_wav` call."""
        self.cfg = load_vocoder_config(config)
        if tts_audio_cfg is not None and tts_audio_cfg.num_mels != self.cfg.audio.num_mels:
            raise ValueError("TTS and vocoder num_mels mismatch")
        if self.cfg.model in ("melgan", "pwgan"):
            raise NotImplementedError(
                f"the {self.cfg.model} vocoder comes with a later slice of the port "
                f"(ROADMAP.md section A, item 9); use model 'wavernn'")
        if self.cfg.model != "wavernn":
            raise ValueError(f"unknown vocoder model {self.cfg.model!r}")
        self.device = resolve_device(device)
        self._gen = torch.Generator().manual_seed(rng_seed)
        w = self.cfg.wavernn
        self.model = WaveRNN(self.cfg.audio.num_mels, w.bits, w.rnn_dims, w.fc_dims,
                             w.compute_dims, w.res_out_dims, w.num_res_blocks, w.pad,
                             w.upsample_factors, w.mode, num_mixtures=w.num_mixtures,
                             device=self.device)
        if checkpoint:
            load_checkpoint(self.model, checkpoint)

    def mel_to_wav(self, mel: np.ndarray, seed: int | None = None) -> np.ndarray:
        """mel [n_mels, T] (TTS layout) -> waveform float32 [T * hop]. The
        mel is edge-padded by `pad` frames each side (the conditioning's
        context). `seed` keys the sample loop; by default one is drawn from
        the synthesizer's generator per call."""
        if seed is None:
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=self._gen))
        w = self.cfg.wavernn
        mel = torch.as_tensor(np.asarray(mel, np.float32), device=self.device)
        mel_p = F.pad(mel[None], (w.pad, w.pad), mode="replicate")[0].T    # [T + 2 pad, n_mels]
        wav = self.model.generate(mel_p, seed, batched=w.batched, target=w.target,
                                  overlap=w.overlap)
        return wav.cpu().numpy().astype(np.float32)
