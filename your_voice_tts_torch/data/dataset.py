"""Bucketed TTS dataset (the JAX package's data/dataset.py).

Texts become grapheme ids, or phoneme ids through one G2P backend for the
whole dataset (`default_g2p_backend`, honouring a pinned
cfg.data.g2p_backend), whose class name the trainer writes into its
checkpoints. With a cache directory the phoneme ids are kept as .npy files
under phonemes/, keyed by the sha1 of (text, backend name, language,
EOS/BOS, cleaner), so a change of any of them misses the cache.

Mels are computed once, in batched calls through the AudioProcessor, and
cached in memory and, with a cache directory, as .npy files keyed by the
audio config and the wav path. A Tacotron(1) config also regresses the
linear spectrogram: the dataset computes and caches it beside the mel
(files named lin_..., the mel's mel_...) and batches carry it as "linear"
[B, T_mel, num_freq], padded like the mels. Batches are length-sorted (shuffled within
groups of batch_group_size batches), padded to a small set of shapes (text
to multiples of TEXT_PAD, mel frames to multiples of r * FRAME_PAD), and
short final batches to the full batch size with phantom rows whose
mel_len is 0, so every loss mask drops them. Stop targets come grouped by
r: [B, T_mel / r].
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os

import numpy as np

from ..text import default_g2p_backend, phoneme_to_sequence, text_to_sequence

_log = logging.getLogger(__name__)

TEXT_PAD = 8
FRAME_PAD = 8


def _bucket(n: int, q: int) -> int:
    return ((n + q - 1) // q) * q


class TTSDataset:
    _B_QUANTUM = 8  # batch-dim quantum of token batching

    def __init__(self, items: list[list[str]], cfg, ap, speakers: dict[str, int] | None = None,
                 speaker_embeddings: dict | None = None, cache_dir: str | None = None):
        """speakers: the speaker name -> id map (the trainer's, built over
        its train and eval items together), or None to number this
        dataset's own speakers in sorted order. speaker_embeddings: speaker
        name -> d-vector; with it every batch carries speaker_embeddings
        [B, D] float32."""
        self.cfg, self.ap, self.cache_dir = cfg, ap, cache_dir
        self.speaker_embeddings = speaker_embeddings
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        d = cfg.data
        self.g2p = (default_g2p_backend(d.phoneme_language, d.cmudict_path, prefer=d.g2p_backend)
                    if d.use_phonemes else None)
        self.g2p_backend_name = type(self.g2p).__name__ if self.g2p else None
        self._ph_cache = None
        if cache_dir and d.use_phonemes:
            self._ph_cache = os.path.join(cache_dir, "phonemes")
            os.makedirs(self._ph_cache, exist_ok=True)
        self.entries = []
        for text, wav_path, speaker in items:
            seq = (self._phoneme_seq(text) if d.use_phonemes
                   else text_to_sequence(text, d.text_cleaner))
            if d.min_seq_len <= len(seq) <= d.max_seq_len:
                self.entries.append({"text": text, "seq": seq, "wav": wav_path,
                                     "speaker": speaker})
        # how much of the corpus the lexicon covered
        self.g2p_oov_rate = getattr(self.g2p, "oov_rate", None)
        if self.g2p_oov_rate is not None:
            _log.info(
                f" > G2P ({self.g2p_backend_name}): {self.g2p.word_count} words, "
                f"{getattr(self.g2p, 'derived_count', 0)} derived, "
                f"OOV rate {self.g2p_oov_rate:.1%}")
        if speakers is None:
            speakers = {n: i for i, n in enumerate(sorted({e["speaker"] for e in self.entries}))}
        self.speakers = speakers
        self.need_linear = cfg.model.model == "Tacotron"
        self._compute_mels()
        self.entries.sort(key=lambda e: e["mel_len"])

    def _phoneme_seq(self, text: str) -> np.ndarray:
        d = self.cfg.data

        def seq():
            return phoneme_to_sequence(text, d.text_cleaner, language=d.phoneme_language,
                                       enable_eos_bos=d.enable_eos_bos_chars, backend=self.g2p)

        if self._ph_cache is None:
            return seq()
        key = hashlib.sha1(repr((text, self.g2p_backend_name, d.phoneme_language,
                                 d.enable_eos_bos_chars, d.text_cleaner)).encode()).hexdigest()
        fn = os.path.join(self._ph_cache, key + ".npy")
        if os.path.exists(fn):
            return np.load(fn)
        out = seq()
        np.save(fn, out)
        return out

    def _cache_path(self, wav_path: str, kind: str = "mel") -> str | None:
        """The cache file of a clip's "mel" or "lin" (linear) spectrogram."""
        if not self.cache_dir:
            return None
        blob = json.dumps(dataclasses.asdict(self.cfg.audio), sort_keys=True, default=str)
        cfg_hash = hashlib.md5(blob.encode()).hexdigest()[:8]
        h = hashlib.md5(wav_path.encode()).hexdigest()[:16]
        return os.path.join(self.cache_dir, f"{kind}_{cfg_hash}_{h}.npy")

    def _compute_mels(self) -> None:
        kinds = ("mel", "lin") if self.need_linear else ("mel",)
        pending = []
        for i, e in enumerate(self.entries):
            paths = [self._cache_path(e["wav"], k) for k in kinds]
            if all(p and os.path.exists(p) for p in paths):
                for k, p in zip(("mel", "linear"), paths):
                    e[k] = np.load(p)
                e["mel_len"] = e["mel"].shape[0]
            else:
                pending.append(i)
        if not pending:
            return
        wavs = self.ap.load_wav_batch([self.entries[i]["wav"] for i in pending])
        if self.cfg.audio.do_trim_silence:
            wavs = [self.ap.trim_silence(w) for w in wavs]
        specs = [self.ap.melspectrogram_batch(wavs)]
        if self.need_linear:
            specs.append(self.ap.spectrogram_batch(wavs))
        for j, i in enumerate(pending):
            e = self.entries[i]
            for k, key, sp in zip(kinds, ("mel", "linear"), specs):
                e[key] = sp[j]
                path = self._cache_path(e["wav"], k)
                if path:
                    np.save(path, sp[j])
            e["mel_len"] = e["mel"].shape[0]

    def __len__(self) -> int:
        return len(self.entries)

    def batches(self, batch_size: int, r: int, shuffle: bool = True, seed: int = 0,
                drop_last: bool = False):
        """Yield numpy batches: text [B, T_text], text_lengths, mel
        [B, T_mel, n_mels], mel_lengths, stop_targets [B, T_mel / r],
        speaker_ids, n_real (rows before padding), for Tacotron(1) linear
        [B, T_mel, num_freq], and with d-vectors speaker_embeddings [B, D]
        (zero on phantom rows)."""
        idxs = list(range(len(self.entries)))
        rng = np.random.default_rng(seed)
        bgs = self.cfg.data.batch_group_size * batch_size
        if shuffle and bgs > 0:
            for s in range(0, len(idxs), bgs):
                seg = idxs[s: s + bgs]
                rng.shuffle(seg)
                idxs[s: s + bgs] = seg
        tokens = self.cfg.data.tokens_per_batch
        if tokens:
            groups = self._token_batches(idxs, batch_size, r, tokens)
            if shuffle:
                rng.shuffle(groups)
            for b, b_shape in groups:
                yield self._collate([self.entries[i] for i in b], b_shape, r)
            return
        batches = [idxs[s: s + batch_size] for s in range(0, len(idxs), batch_size)]
        if drop_last and batches and len(batches[-1]) < batch_size:
            batches.pop()
        if shuffle:
            rng.shuffle(batches)
        for b in batches:
            yield self._collate([self.entries[i] for i in b], batch_size, r)

    def _token_batches(self, idxs, max_rows: int, r: int, tokens: int):
        """Greedy grouping over the index walk: each batch keeps
        B_shape * T_mel_bucket <= tokens, B_shape = rows rounded up to the
        quantum, at most max_rows; an over-budget utterance ships alone."""
        q = self._B_QUANTUM
        quant = lambda n: -(-n // q) * q  # noqa: E731
        out, cur, cur_mel = [], [], 0
        for i in idxs:
            m = _bucket(self.entries[i]["mel_len"], r * FRAME_PAD)
            cand = max(cur_mel, m)
            if cur and (quant(len(cur) + 1) * cand > tokens or len(cur) + 1 > max_rows):
                out.append((cur, quant(len(cur))))
                cur, cand = [], m
            cur.append(i)
            cur_mel = cand
        if cur:
            out.append((cur, quant(len(cur))))
        return out

    def _collate(self, entries, batch_size: int, r: int) -> dict[str, np.ndarray]:
        B = batch_size
        t_text = _bucket(max(len(e["seq"]) for e in entries), TEXT_PAD)
        t_mel = _bucket(max(e["mel_len"] for e in entries), r * FRAME_PAD)
        text = np.zeros((B, t_text), np.int32)
        text_len = np.ones((B,), np.int32)
        mel = np.zeros((B, t_mel, self.cfg.audio.num_mels), np.float32)
        mel_len = np.zeros((B,), np.int32)
        spk = np.zeros((B,), np.int32)
        for i, e in enumerate(entries):
            L, M = len(e["seq"]), e["mel_len"]
            text[i, :L], text_len[i] = e["seq"], L
            mel[i, :M], mel_len[i] = e["mel"], M
            if e["speaker"] not in self.speakers:
                raise KeyError(f"speaker {e['speaker']!r} missing from the speaker mapping: "
                               "refusing to alias it onto id 0 (rebuild the mapping to "
                               "include every corpus speaker)")
            spk[i] = self.speakers[e["speaker"]]
        dec_steps = (mel_len + r - 1) // r
        stop_targets = (np.arange(t_mel // r)[None, :] >= (dec_steps - 1)[:, None]
                        ).astype(np.float32)
        batch = {"text": text, "text_lengths": text_len, "mel": mel, "mel_lengths": mel_len,
                 "stop_targets": stop_targets, "speaker_ids": spk,
                 "n_real": np.int32(len(entries))}
        if self.need_linear:
            linear = np.zeros((B, t_mel, self.cfg.audio.num_freq), np.float32)
            for i, e in enumerate(entries):
                linear[i, : e["mel_len"]] = e["linear"]
            batch["linear"] = linear
        if self.speaker_embeddings is not None:
            dim = len(next(iter(self.speaker_embeddings.values())))
            emb = np.zeros((B, dim), np.float32)
            for i, e in enumerate(entries):
                emb[i] = self.speaker_embeddings[e["speaker"]]
            batch["speaker_embeddings"] = emb
        return batch
