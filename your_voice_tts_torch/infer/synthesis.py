"""Synthesis (the JAX package's infer/synthesis.py): texts -> symbol ids
(graphemes, or phonemes where the config says so) -> one padded batch ->
model.inference (conditioned on speakers and, for a GST model, on the
style of a reference waveform) -> each row trimmed to its stop ->
waveforms, through one batched Griffin-Lim pass or, given a neural
vocoder, through the vocoder one row at a time. A linear-spectrogram model
(Tacotron(1)) always inverts through Griffin-Lim, vocoder or not, as the
reference does."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..audio import AudioProcessor
from ..config import Config
from ..text import default_g2p_backend, phoneme_to_sequence, text_to_sequence

TEXT_PAD = 8


def g2p_backend(cfg: Config):
    """The G2P backend of a phoneme config: `default_g2p_backend` for its
    language, lexicon and pinned backend, built once a (language, lexicon,
    pin) and kept (the reference builds one a call, parsing the lexicon
    each time; the ids are the same)."""
    d = cfg.data
    return _g2p_backend(d.phoneme_language, d.cmudict_path, d.g2p_backend)


@functools.lru_cache(maxsize=8)
def _g2p_backend(language: str, cmudict_path: str | None, prefer: str | None):
    return default_g2p_backend(language, cmudict_path, prefer=prefer)


def text_to_seq(text: str, cfg: Config) -> np.ndarray:
    """Cleaner + grapheme ids, or phoneme ids (bos ... eos around them with
    enable_eos_bos_chars) for a config with use_phonemes."""
    if cfg.data.use_phonemes:
        return phoneme_to_sequence(text, cfg.data.text_cleaner,
                                   language=cfg.data.phoneme_language,
                                   enable_eos_bos=cfg.data.enable_eos_bos_chars,
                                   backend=g2p_backend(cfg))
    return text_to_sequence(text, cfg.data.text_cleaner)


def _pad_texts(seqs: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    max_len = max(len(s) for s in seqs)
    bucket = -(-max_len // TEXT_PAD) * TEXT_PAD
    text = np.zeros((len(seqs), bucket), np.int64)
    lengths = np.zeros((len(seqs),), np.int64)
    for i, s in enumerate(seqs):
        text[i, : len(s)] = s
        lengths[i] = len(s)
    return text, lengths


def synthesis_batch(model, texts: list[str], cfg: Config, ap: AudioProcessor,
                    trim_silence: bool = False,
                    max_decoder_steps: int | None = None, seed: int = 0,
                    decode_dtype=torch.bfloat16, vocoder=None, speaker_ids=None,
                    d_vectors=None, style_wav: np.ndarray | None = None) -> list[dict]:
    """Batched synthesis; one result dict per text (wav, postnet spectrogram
    [F, T]: mel, or linear for Tacotron(1), alignment, stop tokens). `seed`
    seeds the prenets' dropout. `vocoder` (mel [n_mels, T] -> waveform, e.g.
    VocoderSynthesizer.mel_to_wav) replaces Griffin-Lim for a mel model; it
    runs once per row, in order. A speaker-conditioned model takes a
    speaker id a text (speaker_ids) or a d-vector a text (d_vectors
    [B, spk_dim]). A GST model takes the style of style_wav (a waveform at
    the config's sample rate): its mel [1, T, n_mels], one style that the
    model adds to every row (the GST runs once a batch, not once a row)."""
    text_arr, lengths = _pad_texts([text_to_seq(t, cfg) for t in texts])
    # the configured inference compute dtype (bf16: the encoder, key
    # projection and postnet in bf16, as the reference's serving path)
    compute_dtype = (torch.bfloat16 if cfg.model.inference_compute_dtype == "bfloat16"
                     else None)
    style_mel = None
    if style_wav is not None:
        style_mel = ap.melspectrogram(style_wav).T[None].astype(np.float32)
    spk = {k: v for k, v in (("speaker_ids", speaker_ids), ("speaker_embeddings", d_vectors),
                             ("style_mel", style_mel)) if v is not None}
    out = model.inference(text_arr, lengths, max_decoder_steps=max_decoder_steps,
                          seed=seed, decode_dtype=decode_dtype, compute_dtype=compute_dtype,
                          **spk)
    mels = out["postnet_outputs"].cpu().numpy()
    aligns = out["alignments"].cpu().numpy()
    stops = out["stop_probs"].cpu().numpy()
    mel_lens = out["mel_lengths"].cpu().numpy()
    results, specs = [], []
    for i, text in enumerate(texts):
        spec = mels[i, : max(int(mel_lens[i]), model.r)].T
        results.append({"text": text, "mel_postnet_spec": spec,
                        "alignment": aligns[i], "stop_tokens": stops[i]})
        specs.append(spec)
    if getattr(model, "output_type", "mel") == "linear":
        wavs = ap.inv_spectrogram_batch(specs)
    elif vocoder is not None:
        wavs = [np.asarray(vocoder(spec)) for spec in specs]
    else:
        wavs = ap.inv_melspectrogram_batch(specs)
    for res, wav in zip(results, wavs):
        res["wav"] = wav[: ap.find_endpoint(wav)] if trim_silence else wav
    return results


def synthesis(model, text: str, cfg: Config, ap: AudioProcessor,
              trim_silence: bool = False, seed: int = 0,
              decode_dtype=torch.bfloat16, style_wav: np.ndarray | None = None) -> dict:
    """Single-utterance synthesis."""
    return synthesis_batch(model, [text], cfg, ap, trim_silence=trim_silence,
                           seed=seed, decode_dtype=decode_dtype, style_wav=style_wav)[0]
