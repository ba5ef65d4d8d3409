"""Synthesis (the JAX package's infer/synthesis.py): texts -> symbol ids ->
one padded batch -> model.inference -> each row trimmed to its stop ->
waveforms, through one batched Griffin-Lim pass or, given a neural
vocoder, through the vocoder one row at a time. A linear-spectrogram model
(Tacotron(1)) always inverts through Griffin-Lim, vocoder or not, as the
reference does."""

from __future__ import annotations

import numpy as np
import torch

from ..audio import AudioProcessor
from ..config import Config
from ..text import text_to_sequence

TEXT_PAD = 8


def text_to_seq(text: str, cfg: Config) -> np.ndarray:
    """Cleaner + grapheme ids (the phoneme path comes with a later slice)."""
    if cfg.data.use_phonemes:
        raise NotImplementedError("the phoneme frontend arrives with a later "
                                  "slice of the port")
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
                    d_vectors=None) -> list[dict]:
    """Batched synthesis; one result dict per text (wav, postnet spectrogram
    [F, T]: mel, or linear for Tacotron(1), alignment, stop tokens). `seed`
    seeds the prenets' dropout. `vocoder` (mel [n_mels, T] -> waveform, e.g.
    VocoderSynthesizer.mel_to_wav) replaces Griffin-Lim for a mel model; it
    runs once per row, in order. A speaker-conditioned model takes a
    speaker id a text (speaker_ids) or a d-vector a text (d_vectors
    [B, spk_dim])."""
    text_arr, lengths = _pad_texts([text_to_seq(t, cfg) for t in texts])
    # the configured inference compute dtype (bf16: the encoder, key
    # projection and postnet in bf16, as the reference's serving path)
    compute_dtype = (torch.bfloat16 if cfg.model.inference_compute_dtype == "bfloat16"
                     else None)
    spk = {k: v for k, v in (("speaker_ids", speaker_ids), ("speaker_embeddings", d_vectors))
           if v is not None}
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
              decode_dtype=torch.bfloat16) -> dict:
    """Single-utterance synthesis."""
    return synthesis_batch(model, [text], cfg, ap, trim_silence=trim_silence,
                           seed=seed, decode_dtype=decode_dtype)[0]
