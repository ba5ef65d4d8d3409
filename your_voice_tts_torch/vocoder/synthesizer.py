"""Vocoder inference facade (the JAX package's vocoder/synthesizer.py):
normalized mel [n_mels, T] -> waveform, through MelGAN, Parallel WaveGAN or
WaveRNN. Wired into the TTS Synthesizer by `Synthesizer.load_vocoder`. Runs
on CUDA unless given another device."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..train.checkpoint import load_checkpoint, load_generator
from .config import VocoderConfig, load_vocoder_config
from .models.melgan import MelganGenerator
from .models.pwgan import ParallelWaveganGenerator
from .models.wavernn import WaveRNN


class VocoderSynthesizer:
    def __init__(self, config: str | VocoderConfig, checkpoint: str | None = None,
                 tts_audio_cfg=None, rng_seed: int = 0, device=None):
        """checkpoint: a JAX-package `.npz` (WaveRNN's whole model, MelGAN's
        and PWGAN's generator subtree of their GAN checkpoint); without one
        the model keeps seeded random weights. rng_seed seeds the generator
        that draws WaveRNN's sample-loop seed or PWGAN's input noise, once
        a `mel_to_wav` call."""
        self.cfg = load_vocoder_config(config)
        if tts_audio_cfg is not None and tts_audio_cfg.num_mels != self.cfg.audio.num_mels:
            raise ValueError("TTS and vocoder num_mels mismatch")
        if self.cfg.model not in ("melgan", "pwgan", "wavernn"):
            raise ValueError(f"unknown vocoder model {self.cfg.model!r}")
        self.device = resolve_device(device)
        self._gen = torch.Generator().manual_seed(rng_seed)
        n_mels = self.cfg.audio.num_mels
        if self.cfg.model == "melgan":
            m = self.cfg.melgan
            self.model = MelganGenerator(n_mels, m.upsample_factors, m.base_channels,
                                         m.num_res_blocks, m.kernel_size, device=self.device)
        elif self.cfg.model == "pwgan":
            m = self.cfg.pwgan
            self.model = ParallelWaveganGenerator(
                n_mels, m.num_layers, m.stacks, m.residual_channels, m.gate_channels,
                m.skip_channels, m.kernel_size, m.upsample_factors,
                aux_context_window=m.aux_context_window, device=self.device)
        else:
            w = self.cfg.wavernn
            self.model = WaveRNN(n_mels, w.bits, w.rnn_dims, w.fc_dims, w.compute_dims,
                                 w.res_out_dims, w.num_res_blocks, w.pad, w.upsample_factors,
                                 w.mode, num_mixtures=w.num_mixtures, device=self.device)
        if checkpoint:
            (load_checkpoint if self.cfg.model == "wavernn" else load_generator)(
                self.model, checkpoint)

    @torch.no_grad()
    def mel_to_wav(self, mel: np.ndarray, seed: int | None = None) -> np.ndarray:
        """mel [n_mels, T] (TTS layout) -> waveform float32 [T * hop].
        WaveRNN: the mel is edge-padded by `pad` frames each side (the
        conditioning's context) and `seed` keys the sample loop; PWGAN:
        `seed` seeds its noise. By default one seed is drawn from the
        synthesizer's generator a call; MelGAN draws nothing."""
        mel = torch.as_tensor(np.asarray(mel, np.float32), device=self.device)
        if self.cfg.model == "melgan":
            return self.model(mel.T[None])[0].cpu().numpy()
        if seed is None:
            seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=self._gen))
        if self.cfg.model == "pwgan":
            gen = torch.Generator().manual_seed(seed)
            return self.model(mel.T[None], generator=gen)[0].cpu().numpy()
        w = self.cfg.wavernn
        mel_p = F.pad(mel[None], (w.pad, w.pad), mode="replicate")[0].T    # [T + 2 pad, n_mels]
        wav = self.model.generate(mel_p, seed, batched=w.batched, target=w.target,
                                  overlap=w.overlap)
        return wav.cpu().numpy().astype(np.float32)
