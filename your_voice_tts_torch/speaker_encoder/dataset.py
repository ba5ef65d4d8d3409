"""Speaker-encoder dataset (the JAX package's speaker_encoder/dataset.py):
random N-speaker x M-utterance batches of fixed-length mel windows."""

from __future__ import annotations

import numpy as np


class SpeakerEncoderDataset:
    def __init__(self, items: list[list[str]], ap, num_frames: int = 160, augment_wav_fn=None):
        """items: [text, wav_path, speaker] rows. augment_wav_fn: an optional
        wav -> [extra wavs] hook; each extra view is registered as another
        utterance of the same speaker, after the clip itself. A mel shorter
        than num_frames is tiled up to it. The mels are computed in
        batched calls through `ap`."""
        self.num_frames = num_frames
        wavs = ap.load_wav_batch([wav_path for _, wav_path, _ in items])
        views, owners = [], []
        for (_, _, speaker), wav in zip(items, wavs):
            for w in [wav] + (list(augment_wav_fn(wav)) if augment_wav_fn else []):
                views.append(np.asarray(w, np.float32))
                owners.append(speaker)
        self.by_speaker: dict[str, list[np.ndarray]] = {}
        for speaker, mel in zip(owners, ap.melspectrogram_batch(views)):
            if mel.shape[0] < num_frames:
                mel = np.tile(mel, (-(-num_frames // mel.shape[0]), 1))
            self.by_speaker.setdefault(speaker, []).append(mel.astype(np.float32))
        self.speakers = sorted(self.by_speaker)

    def sample_batch(self, num_speakers: int, num_utters: int,
                     rng: np.random.Generator) -> np.ndarray:
        """[N, M, num_frames, n_mels] mel windows: N speakers drawn without
        replacement, then for each of its M utterances a clip and a start,
        in the reference's order of draws from `rng`."""
        chosen = rng.choice(len(self.speakers), size=min(num_speakers, len(self.speakers)),
                            replace=False)
        out = []
        for si in chosen:
            clips = self.by_speaker[self.speakers[int(si)]]
            utts = []
            for _ in range(num_utters):
                mel = clips[int(rng.integers(len(clips)))]
                s = int(rng.integers(0, max(1, mel.shape[0] - self.num_frames + 1)))
                utts.append(mel[s: s + self.num_frames])
            out.append(np.stack(utts))
        return np.stack(out)
