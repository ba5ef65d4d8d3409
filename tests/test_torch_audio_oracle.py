"""The mel parity gate (BASELINE.json's north star: <= 1e-3 max abs) for the
port: `AudioProcessor.melspectrogram` on the CPU against the numpy oracle
`oracle/audio_ref.py` `AudioProcessorRef` (librosa's conventions, float64),
for the shipped Tacotron2 configs, on a speech-like signal, a sine sweep
and white noise at each config's sample rate, as tests/test_audio.py holds
the JAX package. The oracle is numpy, not part of the JAX package."""

import os

import numpy as np
import pytest

from oracle.audio_ref import AudioProcessorRef
from tests.fixtures import sine_sweep, speech_like, white_noise
from your_voice_tts_torch.audio import AudioProcessor
from your_voice_tts_torch.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("ljspeech_tacotron2.json", "ljspeech_tacotron2_b384.json", "smoke_synthetic.json")


def oracle_for(c) -> AudioProcessorRef:
    """The oracle with an AudioConfig's parameters (hop and window as the
    config resolves them)."""
    hop, win = c.resolved_hop_win()
    return AudioProcessorRef(
        sample_rate=c.sample_rate, num_mels=c.num_mels, fft_size=c.fft_size, hop_length=hop,
        win_length=win, preemphasis=c.preemphasis, ref_level_db=c.ref_level_db,
        min_level_db=c.min_level_db, power=c.power, signal_norm=c.signal_norm,
        symmetric_norm=c.symmetric_norm, max_norm=c.max_norm, clip_norm=c.clip_norm,
        mel_fmin=c.mel_fmin, mel_fmax=c.mel_fmax, spec_gain=c.spec_gain)


@pytest.mark.parametrize("make", [speech_like, sine_sweep, white_noise],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("config", CONFIGS)
def test_melspectrogram_meets_the_oracle_gate(config, make):
    c = load_config(os.path.join(ROOT, "configs", config)).audio
    kw = {"f1": 0.45 * c.sample_rate} if make is sine_sweep else {}
    y = make(sr=c.sample_rate, **kw)
    got = AudioProcessor(c, "cpu").melspectrogram(y)
    ref = oracle_for(c).melspectrogram(y.astype(np.float64))
    assert got.shape == ref.shape
    diff = float(np.max(np.abs(got - ref)))
    assert diff <= 1e-3, f"mel parity violated: max abs diff {diff}"
