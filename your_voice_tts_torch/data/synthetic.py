"""Synthetic corpus generator (the JAX package's data/synthetic.py, copied
whole so the port's tests and card runs make the same corpora).

With no LJSpeech on disk, tests and smoke training runs use a
deterministic generated corpus in the LJSpeech metadata layout: short
sentences paired with speech-like harmonic audio whose duration tracks
text length, one 'voice' (f0/formant profile) per synthetic speaker.
"""

from __future__ import annotations

import os
import wave

import numpy as np

_WORDS = (
    "the quick brown fox jumps over a lazy dog while seven wizards "
    "brew magic tonic under calm evening skies and little birds sing "
    "soft golden tunes about distant silver rivers").split()


def _sentence(rng: np.random.Generator, n_words: int) -> str:
    words = rng.choice(_WORDS, size=n_words, replace=True)
    s = " ".join(words)
    return s[0].upper() + s[1:] + "."


def _speech_wave(rng: np.random.Generator, sr: int, dur: float, f0: float) -> np.ndarray:
    t = np.arange(int(sr * dur)) / sr
    vib = f0 * (1.0 + 0.02 * np.sin(2 * np.pi * 4.5 * t))
    phase = 2 * np.pi * np.cumsum(vib) / sr
    x = np.zeros_like(t)
    for h in range(1, 10):
        amp = (1.0 / h) * (0.5 + 0.5 * np.sin(2 * np.pi * (0.6 + 0.11 * h) * t + h))
        x += amp * np.sin(h * phase)
    x += 0.01 * rng.standard_normal(len(t))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 2.2 * t - np.pi / 2)
    x = x * env * 0.25
    fade = np.minimum(1.0, np.minimum(t / 0.02, (dur - t) / 0.02))
    x = x * fade
    # trailing near-silence, like every real speech corpus: the stopnet keys
    # on end-of-utterance frames, and a clip that cuts off mid-tone gives it
    # nothing separable to learn (observed: stop probs plateau at the
    # constant-predictor level without this)
    tail = 0.002 * rng.standard_normal(int(sr * 0.15))
    return np.concatenate([x, tail]).astype(np.float32)


def make_synthetic_corpus(path: str, n_items: int = 32, sr: int = 22050,
                          n_speakers: int = 1, seed: int = 0,
                          min_words: int = 3, max_words: int = 9,
                          words_cycle: tuple | None = None,
                          f0_base: float = 110.0,
                          f0_ratio: float = 1.3) -> str:
    """Create metadata.csv + wavs/ under `path`; returns `path`.

    min_words (inclusive) / max_words (EXCLUSIVE, numpy integers
    convention) bound the sentence-length distribution — a model
    meant to stop correctly on long test sentences must see comparably long
    training clips (bench uses max_words=15).

    words_cycle: when given (e.g. ``(3, 8)``), item i gets exactly
    ``words_cycle[i % len]`` words with ONE fixed sentence text and a fixed
    duration per group — so a round-robin corpus shard is single-bucket
    (every batch the same static shape, no per-step retrace) while
    different shards still carry DIFFERENT shapes. Made for the multi-host
    test, where two tracing+compiling processes contend for one core and
    every extra bucket costs a full retrace in both."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(path, "wavs"), exist_ok=True)
    lines = []
    fixed_texts: dict = {}
    for i in range(n_items):
        if words_cycle is not None:
            n_words = int(words_cycle[i % len(words_cycle)])
            if n_words not in fixed_texts:
                fixed_texts[n_words] = _sentence(
                    np.random.default_rng(seed + n_words), n_words)
            text = fixed_texts[n_words]
            dur = 0.25 + 0.12 * n_words
        else:
            n_words = int(rng.integers(min_words, max_words))
            text = _sentence(rng, n_words)
            dur = 0.25 + 0.12 * n_words + float(rng.uniform(0, 0.1))
        speaker = i % n_speakers
        # per-speaker 'voice' = geometric f0 ladder. The 1.3 default keeps
        # the historical 4-speaker set (110/143/186/242 Hz); corpora with
        # more speakers should pass a smaller ratio so the top voice's 9
        # harmonics stay under Nyquist (8 speakers at sr=8000: ratio 1.165
        # puts speaker 7 at ~320 Hz, 9th harmonic 2.9 kHz < 4 kHz).
        f0 = f0_base * (f0_ratio ** speaker)
        wav = _speech_wave(rng, sr, dur, f0)
        name = f"SYN{speaker:02d}-{i:04d}"
        pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
        with wave.open(os.path.join(path, "wavs", name + ".wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sr)
            f.writeframes(pcm.tobytes())
        lines.append(f"{name}|{text}|{text}")
    with open(os.path.join(path, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path
