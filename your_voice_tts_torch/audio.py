"""AudioProcessor, inverse half (the JAX package's audio.py): normalized mel
spectrograms -> waveforms through batched Griffin-Lim, plus `find_endpoint`
and `save_wav`. Numpy in, numpy out, spectrograms in the reference's
[F, T] layout at this boundary.

Batching follows the reference: mel lengths round up to FRAME_BUCKET frames,
the batch to a power of two (at most _INV_BATCH_CAP rows per launch), pad
frames and pad rows hold normalized silence, and the initial phase is one
[T, n_freq] pattern shared by every row, so a row's audio does not depend on
its batchmates. The phases come from the processor's own torch.Generator.
"""

from __future__ import annotations

import wave

import numpy as np
import torch

from .config import AudioConfig
from .ops import dsp
from .ops.filters import hann_window, inv_mel_basis, mel_basis
from .ops.griffin_lim import griffin_lim_wave, packed_constants

FRAME_BUCKET = 32    # mel frame counts padded to multiples of FRAME_BUCKET


class AudioProcessor:
    # max rows per batched Griffin-Lim launch
    _INV_BATCH_CAP = 128

    def __init__(self, config: AudioConfig, device="cpu", seed: int = 0):
        if config.stats_path:
            raise NotImplementedError(
                "mean/std mel statistics (audio.stats_path) arrive with a "
                "later slice of the port")
        self.cfg = config
        self.device = torch.device(device)
        self.sample_rate = config.sample_rate
        self.hop_length, self.win_length = config.resolved_hop_win()
        basis = mel_basis(config.sample_rate, config.fft_size, config.num_mels,
                          config.mel_fmin, config.mel_fmax).astype(np.float32)
        self.inv_mel_basis = torch.from_numpy(
            inv_mel_basis(basis.astype(np.float64)).astype(np.float32)).to(self.device)
        self.window = hann_window(self.win_length, config.fft_size).astype(np.float32)
        self.gl_consts = packed_constants(config.fft_size, self.hop_length,
                                          self.window, torch.bfloat16, self.device)
        self.generator = torch.Generator().manual_seed(seed)

    def _frame_bucket(self, n: int) -> int:
        return max(FRAME_BUCKET, -(-n // FRAME_BUCKET) * FRAME_BUCKET)

    def _silence_fill(self) -> float:
        """Normalized-silence value for pad frames: a 0.0 pad would
        denormalize to average speech energy and leak into real audio
        through the overlap-add."""
        c = self.cfg
        if c.signal_norm:
            return -c.max_norm if c.symmetric_norm else 0.0
        return c.min_level_db

    def inv_melspectrogram_batch(self, mels: list[np.ndarray]) -> list[np.ndarray]:
        """N normalized mels [num_mels, T_i] -> N waveforms of
        hop * (T_i - 1) samples, one Griffin-Lim launch per (frame bucket,
        batch bucket)."""
        out: list = [None] * len(mels)
        groups: dict[int, list[int]] = {}
        for i, S in enumerate(mels):
            groups.setdefault(self._frame_bucket(np.asarray(S).shape[1]), []).append(i)
        for tb, idxs in sorted(groups.items()):
            for lo in range(0, len(idxs), self._INV_BATCH_CAP):
                chunk = idxs[lo:lo + self._INV_BATCH_CAP]
                bb = 1 << (len(chunk) - 1).bit_length()
                n_bins = np.asarray(mels[chunk[0]]).shape[0]
                buf = np.full((bb, tb, n_bins), self._silence_fill(), np.float32)
                for j, i in enumerate(chunk):
                    S = np.asarray(mels[i], np.float32).T
                    buf[j, : S.shape[0]] = S
                wavs = self._inverse(torch.from_numpy(buf).to(self.device)).cpu().numpy()
                for j, i in enumerate(chunk):
                    t = np.asarray(mels[i]).shape[1]
                    out[i] = wavs[j, : self.hop_length * (t - 1)].astype(np.float32)
        return out

    def _inverse(self, mel_norm):
        """[B, T, n_mels] normalized mel -> [B, hop * (T - 1)] waveforms."""
        c = self.cfg
        D = dsp.denormalize_spec(mel_norm, c.min_level_db, c.max_norm,
                                 c.symmetric_norm, c.clip_norm, c.signal_norm)
        S = dsp.mel_to_linear(dsp.db_to_amp(D + c.ref_level_db, c.spec_gain),
                              self.inv_mel_basis)
        phase = torch.rand(S.shape[1:], generator=self.generator) * (2.0 * np.pi)
        y = griffin_lim_wave(S ** c.power, phase.to(self.device), self.gl_consts,
                             n_iters=c.griffin_lim_iters,
                             momentum=c.griffin_lim_momentum)
        return dsp.inv_preemphasis(y, c.preemphasis)

    def find_endpoint(self, wav: np.ndarray, threshold_db: float = -40.0,
                      min_silence_sec: float = 0.8) -> int:
        window_length = int(self.sample_rate * min_silence_sec)
        hop = window_length // 4
        threshold = 10.0 ** (threshold_db / self.cfg.spec_gain)
        for x in range(hop, len(wav) - window_length, hop):
            if np.max(np.abs(wav[x: x + window_length])) < threshold:
                return x + hop
        return len(wav)

    def save_wav(self, wav: np.ndarray, path: str, sr: int | None = None) -> None:
        """Peak-normalized 16-bit mono WAV."""
        wav_norm = wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))
        with wave.open(path, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(sr or self.sample_rate)
            f.writeframes(wav_norm.astype(np.int16).tobytes())
