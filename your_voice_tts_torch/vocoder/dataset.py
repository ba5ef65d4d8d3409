"""Vocoder training data (the JAX package's vocoder/dataset.py): aligned
(mel window, audio segment) pairs sampled from whole clips."""

from __future__ import annotations

import collections

import numpy as np

from ..audio import AudioProcessor


class GANDataset:
    """Random fixed-length audio segments with their aligned mel windows,
    for the GAN and WaveRNN trainers.

    seq_len must be a multiple of the hop. Clips load lazily into an LRU of
    `cache_clips` (wav, mel) pairs; a clip shorter than the segment plus
    its context is tiled; its mel [T, n_mels] is the processor's
    `melspectrogram`, computed once a load. For WaveRNN, `pad` extra
    conditioning frames are kept on each side."""

    def __init__(self, items: list, ap: AudioProcessor, seq_len: int = 8192, pad: int = 0,
                 cache_clips: int = 256):
        if seq_len % ap.hop_length:
            raise ValueError(f"seq_len {seq_len} is not a multiple of the hop {ap.hop_length}")
        self.ap = ap
        self.seq_len = seq_len
        self.pad = pad
        self.paths = [wav_path for _text, wav_path, _speaker in items]
        self.cache_clips = cache_clips
        self._cache: collections.OrderedDict[int, tuple] = collections.OrderedDict()

    def _clip(self, idx: int):
        if idx in self._cache:
            self._cache.move_to_end(idx)
            return self._cache[idx]
        wav = self.ap.load_wav(self.paths[idx])
        need = self.seq_len + 2 * (self.pad + 1) * self.ap.hop_length
        if len(wav) < need:
            wav = np.tile(wav, int(np.ceil(need / len(wav))))
        clip = (wav.astype(np.float32), self.ap.melspectrogram(wav).T.astype(np.float32))
        self._cache[idx] = clip
        if len(self._cache) > self.cache_clips:
            self._cache.popitem(last=False)
        return clip

    def __len__(self) -> int:
        return len(self.paths)

    def sample_batch(self, batch_size: int, rng: np.random.Generator):
        """(mel [B, seq_len / hop + 2 pad, n_mels], audio [B, seq_len]): for
        each row a clip (`rng.integers(len)`), then its start frame, drawn
        in the reference's order, so one seed gives both packages the same
        segments."""
        hop = self.ap.hop_length
        frames = self.seq_len // hop
        mels, audios = [], []
        for _ in range(batch_size):
            wav, mel = self._clip(int(rng.integers(len(self.paths))))
            max_start_f = mel.shape[0] - frames - 2 * self.pad - 1
            f0 = int(rng.integers(self.pad, max(self.pad + 1, max_start_f)))
            s0 = f0 * hop
            audios.append(wav[s0: s0 + self.seq_len])
            mels.append(mel[f0 - self.pad: f0 + frames + self.pad])
        return np.stack(mels), np.stack(audios)
