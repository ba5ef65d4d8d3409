"""AudioProcessor (the JAX package's audio.py). Forward half: WAV loading
(`read_wav`, the port's own RIFF reader in numpy, and scipy's polyphase
resampler when the rate differs; a thread pool for batches),
silence trimming and normalized mel and linear spectrograms, one batched
call per length bucket, normalized by range or, with `stats_path`, by the
corpus statistics. Inverse half: normalized mel or linear spectrograms ->
waveforms through batched Griffin-Lim (`ops/griffin_lim.py
griffin_lim_batch`, which routes by the padded frame count), plus
`find_endpoint` and `save_wav`. Numpy in,
numpy out, spectrograms in the reference's [F, T] layout at this boundary
(`melspectrogram_batch` returns time-major [T, F], as the JAX package's).

Batching follows the reference: mel lengths round up to FRAME_BUCKET frames,
the batch to a power of two (at most _INV_BATCH_CAP rows per launch), pad
frames and pad rows hold normalized silence, and the initial phase is one
[T, n_freq] pattern shared by every row, so a row's audio does not depend on
its batchmates. The phases come from the processor's own torch.Generator.

`GriffinLimStage` is the same inverse as a module of a traced serving
program (`infer/export.py`): its constants are buffers, its phase is drawn
from a seed tensor and Griffin-Lim runs through the registered op.
"""

from __future__ import annotations

import os
import struct
import wave

import numpy as np
import torch
from torch import nn

from .config import AudioConfig
from .ops import dsp, prng
from .ops.filters import hann_window, inv_mel_basis, mel_basis
from .ops.griffin_lim import gl_constants, griffin_lim_batch

SIG_BUCKET = 128     # wav lengths padded to multiples of hop * SIG_BUCKET
FRAME_BUCKET = 32    # mel frame counts padded to multiples of FRAME_BUCKET


_PCM, _FLOAT, _EXTENSIBLE = 1, 3, 0xFFFE


def _wav_chunks(path: str) -> tuple[tuple[int, int, int, int], bytes]:
    """A RIFF/WAVE file's (format tag, channels, rate, bits) and its data
    chunk; WAVE_FORMAT_EXTENSIBLE reads as its sub-format's tag, other
    chunks (LIST, fact, bext) are skipped."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 12 or blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    fmt = data = None
    pos = 12
    while pos + 8 <= len(blob):
        cid, size = blob[pos:pos + 4], struct.unpack_from("<I", blob, pos + 4)[0]
        body = pos + 8
        if cid == b"fmt ":
            if size < 16:
                raise ValueError(f"{path}: fmt chunk of {size} bytes")
            tag, channels, rate = struct.unpack_from("<HHI", blob, body)
            bits = struct.unpack_from("<H", blob, body + 14)[0]
            if tag == _EXTENSIBLE and size >= 40:     # sub-format GUID's first field
                tag = struct.unpack_from("<H", blob, body + 24)[0]
            fmt = (tag, channels, rate, bits)
        elif cid == b"data":
            data = blob[body:body + size]
        pos = body + size + (size & 1)                # chunks pad to even sizes
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing {'fmt' if fmt is None else 'data'} chunk")
    return fmt, data


def wav_info(path: str) -> dict:
    """A WAV file's header as `read_wav` parses it: channels, bits a sample,
    sample_rate and n_frames (the whole frames of its data chunk)."""
    (_, channels, rate, bits), data = _wav_chunks(path)
    width = max(1, bits // 8) * max(1, channels)
    return {"channels": channels, "bits": bits, "sample_rate": rate,
            "n_frames": len(data) // width}


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file to (mono float32 [n], sample rate), the
    channel mean of each frame. Takes PCM 8-bit (unsigned, offset 128),
    16, 24 and 32-bit, IEEE float32 and float64, and WAVE_FORMAT_EXTENSIBLE
    with either sub-format; skips other chunks (LIST, fact, bext). Scales as
    the JAX package's native codec: PCM by 2^(bits - 1), floats as stored.
    A data chunk cut short by the end of the file decodes its whole frames."""
    (tag, channels, rate, bits), data = _wav_chunks(path)
    if channels <= 0 or rate <= 0:
        raise ValueError(f"{path}: {channels} channels at {rate} Hz")
    if not ((tag == _PCM and bits in (8, 16, 24, 32)) or (tag == _FLOAT and bits in (32, 64))):
        raise ValueError(f"{path}: unsupported WAV format {tag} with {bits}-bit samples")
    width = bits // 8
    n = len(data) // (width * channels) * channels
    raw = np.frombuffer(data, np.uint8, n * width)
    if tag == _FLOAT:
        x = raw.view("<f4" if bits == 32 else "<f8").astype(np.float32)
    elif bits == 8:
        x = (raw.astype(np.float32) - 128.0) / 128.0
    elif bits == 16:
        x = raw.view("<i2").astype(np.float32) / 32768.0
    elif bits == 24:
        b = raw.reshape(-1, 3).astype(np.int32)
        v = (b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)
        x = (v >> 8).astype(np.float32) / 8388608.0
    else:
        x = (raw.view("<i4").astype(np.float64) / 2147483648.0).astype(np.float32)
    if channels > 1:
        x = x.reshape(-1, channels).sum(axis=1, dtype=np.float32) * np.float32(1.0 / channels)
    return x, rate


class AudioProcessor:
    # max rows per batched Griffin-Lim launch
    _INV_BATCH_CAP = 128

    def __init__(self, config: AudioConfig, device="cpu", seed: int = 0):
        self.cfg = config
        self.device = torch.device(device)
        self.sample_rate = config.sample_rate
        self.hop_length, self.win_length = config.resolved_hop_win()
        basis = mel_basis(config.sample_rate, config.fft_size, config.num_mels,
                          config.mel_fmin, config.mel_fmax).astype(np.float32)
        self.inv_mel_basis = torch.from_numpy(
            inv_mel_basis(basis.astype(np.float64)).astype(np.float32)).to(self.device)
        self.window = hann_window(self.win_length, config.fft_size).astype(np.float32)
        self.mel_basis = torch.from_numpy(basis).to(self.device)
        self.window_t = torch.from_numpy(self.window).to(self.device)
        # corpus statistics (stats_path, a scale_stats.npy as
        # bin/compute_statistics.py writes it): per-bin (mean, std) of the
        # dB-minus-ref values, which replace the range normalization; a
        # "mel" and a "linear" pair (or None), on the host and on the device
        self.host_stats = {"mel": None, "linear": None}
        if config.stats_path:
            stats = np.load(config.stats_path, allow_pickle=True).item()
            for kind in ("mel", "linear") if "linear_mean" in stats else ("mel",):
                self.host_stats[kind] = (np.asarray(stats[kind + "_mean"], np.float32),
                                         np.asarray(stats[kind + "_std"], np.float32))
        self._device_stats = {
            kind: None if pair is None else tuple(torch.from_numpy(a).to(self.device)
                                                  for a in pair)
            for kind, pair in self.host_stats.items()}
        # both Griffin-Lim layouts' constants (packed for the whole-loop
        # routes, unpacked for the per-iteration route), built once
        self.gl_consts = gl_constants(config.fft_size, self.hop_length, self.window,
                                      torch.bfloat16, self.device)
        self.generator = torch.Generator().manual_seed(seed)

    def stats(self, kind: str, device=None):
        """The statistics of a "mel" or "linear" spectrogram as float32
        tensors (mean, std) on `device` (the processor's by default; the
        tensors made at construction, copied only to another device), or
        None where the processor has none."""
        pair = self._device_stats[kind]
        if pair is None:
            return None
        return tuple(a.to(device or self.device) for a in pair)

    # --- forward transforms ---------------------------------------------

    def _sig_bucket(self, n: int) -> int:
        q = self.hop_length * SIG_BUCKET
        return max(q, -(-n // q) * q)

    def _forward(self, kind: str, y, lengths):
        c = self.cfg
        kw = dict(window=self.window_t, n_fft=c.fft_size, hop=self.hop_length,
                  preemph=c.preemphasis, ref_level_db=c.ref_level_db,
                  min_level_db=c.min_level_db, spec_gain=c.spec_gain, max_norm=c.max_norm,
                  symmetric=c.symmetric_norm, clip=c.clip_norm, signal_norm=c.signal_norm,
                  stats=self.stats(kind))
        if kind == "mel":
            return dsp.melspectrogram(y, lengths, mel_basis=self.mel_basis, **kw)
        return dsp.spectrogram(y, lengths, **kw)

    def melspectrogram(self, y: np.ndarray) -> np.ndarray:
        """wav [T] -> normalized mel [num_mels, n_frames]."""
        return self.melspectrogram_batch([y])[0].T

    def spectrogram(self, y: np.ndarray) -> np.ndarray:
        """wav [T] -> normalized linear spectrogram [num_freq, n_frames]."""
        return self.spectrogram_batch([y])[0].T

    def melspectrogram_batch(self, wavs: list[np.ndarray]) -> list[np.ndarray]:
        """N wavs -> N time-major mels [n_frames_i, num_mels], n_frames_i =
        len // hop + 1: one batched call per length bucket (lengths round
        up to hop * SIG_BUCKET samples, the batch to a power of two, at
        most 64 rows; phantom rows are dropped)."""
        return self._forward_batch("mel", wavs)

    def spectrogram_batch(self, wavs: list[np.ndarray]) -> list[np.ndarray]:
        """N wavs -> N time-major linear spectrograms [n_frames_i,
        num_freq], batched as `melspectrogram_batch` (Tacotron(1)'s linear
        targets)."""
        return self._forward_batch("linear", wavs)

    def _forward_batch(self, kind: str, wavs: list[np.ndarray]) -> list[np.ndarray]:
        by_bucket: dict[int, list[int]] = {}
        for i, y in enumerate(wavs):
            by_bucket.setdefault(self._sig_bucket(len(y)), []).append(i)
        out: list = [None] * len(wavs)
        for lb, idxs in by_bucket.items():
            nb = 1
            while nb < min(len(idxs), 64):
                nb *= 2
            for s in range(0, len(idxs), nb):
                group = idxs[s: s + nb]
                buf = np.zeros((nb, lb), np.float32)
                lens = [self.hop_length] * nb
                for j, i in enumerate(group):
                    buf[j, : len(wavs[i])] = wavs[i]
                    lens[j] = len(wavs[i])
                y = torch.from_numpy(buf).to(self.device)
                specs = self._forward(kind, y, lens).cpu().numpy()
                for j, i in enumerate(group):
                    out[i] = specs[j, : lens[j] // self.hop_length + 1].astype(np.float32)
        return out

    def load_wav(self, path: str, sr: int | None = None) -> np.ndarray:
        """WAV (PCM 8/16/24/32-bit, IEEE float 32/64, plain or
        WAVE_FORMAT_EXTENSIBLE) -> mono float32 in [-1, 1] (the channel
        mean), resampled to the sample rate with scipy's resample_poly when
        it differs."""
        from math import gcd

        target_sr = sr or self.sample_rate
        x, file_sr = read_wav(path)
        if file_sr != target_sr:
            from scipy.signal import resample_poly

            g = gcd(file_sr, target_sr)
            x = resample_poly(x, target_sr // g, file_sr // g).astype(np.float32)
        if self.cfg.do_sound_norm:
            x = self.sound_norm(x)
        return x.astype(np.float32)

    def load_wav_batch(self, paths: list[str], sr: int | None = None) -> list[np.ndarray]:
        """`load_wav` over many files on a thread pool of up to 8 threads
        (numpy's decode and scipy's resampler release the GIL for most of
        their work)."""
        from concurrent.futures import ThreadPoolExecutor

        if len(paths) <= 1:
            return [self.load_wav(p, sr) for p in paths]
        with ThreadPoolExecutor(max_workers=min(len(paths), os.cpu_count() or 1, 8)) as pool:
            return list(pool.map(lambda p: self.load_wav(p, sr), paths))

    def sound_norm(self, x: np.ndarray) -> np.ndarray:
        return x / (np.abs(x).max() + 1e-8) * 0.9

    def trim_silence(self, wav: np.ndarray) -> np.ndarray:
        """librosa.effects.trim semantics (top_db = trim_db, win / hop
        framing), after a 10 ms margin off both ends."""
        margin = int(self.sample_rate * 0.01)
        if margin > 0:
            wav = wav[margin:-margin]
        yp = np.pad(wav, self.win_length // 2)
        n_frames = max(0, 1 + (len(yp) - self.win_length) // self.hop_length)
        if n_frames == 0:
            return wav
        idx = (np.arange(n_frames) * self.hop_length)[:, None] + np.arange(self.win_length)[None, :]
        rms = np.sqrt(np.mean(yp[idx] ** 2, axis=1))
        ref = max(float(np.max(rms)), 1e-10)
        db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
        keep = np.flatnonzero(db > -self.cfg.trim_db)
        if len(keep) == 0:
            return wav[:0]
        start = int(keep[0]) * self.hop_length
        end = min(len(wav), int(keep[-1] + 1) * self.hop_length)
        return wav[start:end]

    # --- inverse transforms ---------------------------------------------

    def _frame_bucket(self, n: int) -> int:
        return max(FRAME_BUCKET, -(-n // FRAME_BUCKET) * FRAME_BUCKET)

    def _silence_fill(self, kind: str = "mel"):
        """Normalized-silence value for pad frames of a "mel" or "linear"
        spectrogram: a 0.0 pad would denormalize to average speech energy
        and leak into real audio through the overlap-add. With statistics,
        a row of the spectrogram's bins ((min_level_db - mean) / std), else
        one float."""
        c = self.cfg
        pair = self.host_stats[kind]
        if c.signal_norm and pair is not None:
            mean, std = pair
            return ((c.min_level_db - mean) / np.maximum(std, 1e-8)).astype(np.float32)
        if c.signal_norm:
            return -c.max_norm if c.symmetric_norm else 0.0
        return c.min_level_db

    def _inverse_batch(self, kind: str, specs: list[np.ndarray]) -> list[np.ndarray]:
        """N normalized spectrograms [F, T_i] -> N waveforms of
        hop * (T_i - 1) samples, one Griffin-Lim launch per (frame bucket,
        batch bucket)."""
        out: list = [None] * len(specs)
        groups: dict[int, list[int]] = {}
        for i, S in enumerate(specs):
            groups.setdefault(self._frame_bucket(np.asarray(S).shape[1]), []).append(i)
        for tb, idxs in sorted(groups.items()):
            for lo in range(0, len(idxs), self._INV_BATCH_CAP):
                chunk = idxs[lo:lo + self._INV_BATCH_CAP]
                bb = 1 << (len(chunk) - 1).bit_length()
                n_bins = np.asarray(specs[chunk[0]]).shape[0]
                buf = np.empty((bb, tb, n_bins), np.float32)
                buf[:] = self._silence_fill(kind)
                for j, i in enumerate(chunk):
                    S = np.asarray(specs[i], np.float32).T
                    buf[j, : S.shape[0]] = S
                wavs = self._inverse(kind, torch.from_numpy(buf).to(self.device)).cpu().numpy()
                for j, i in enumerate(chunk):
                    t = np.asarray(specs[i]).shape[1]
                    out[i] = wavs[j, : self.hop_length * (t - 1)].astype(np.float32)
        return out

    def inv_melspectrogram_batch(self, mels: list[np.ndarray]) -> list[np.ndarray]:
        """N normalized mels [num_mels, T_i] -> N waveforms of
        hop * (T_i - 1) samples."""
        return self._inverse_batch("mel", mels)

    def inv_spectrogram_batch(self, specs: list[np.ndarray]) -> list[np.ndarray]:
        """N normalized linear spectrograms [num_freq, T_i] (Tacotron(1)'s
        head) -> N waveforms: the mel path without the pseudo-inverse."""
        return self._inverse_batch("linear", specs)

    def gl_magnitudes(self, kind: str, spec_norm):
        """[B, T, F] normalized mel or linear spectrogram -> the magnitudes
        Griffin-Lim inverts, [B, T, n_fft/2 + 1]: denormalize (with the
        statistics where the processor has them), dB -> amplitude (mel ->
        linear for a mel), ** power."""
        return dsp.gl_magnitudes(spec_norm, self.inv_mel_basis if kind == "mel" else None,
                                 stats=self.stats(kind, spec_norm.device),
                                 **gl_magnitude_args(self.cfg))

    def _inverse(self, kind: str, spec_norm):
        """[B, T, F] normalized mel or linear spectrogram -> [B, hop * (T - 1)]
        waveforms: `gl_magnitudes`, batched Griffin-Lim from one phase
        pattern shared by every row, de-emphasis."""
        c = self.cfg
        S = self.gl_magnitudes(kind, spec_norm)
        phase = torch.rand(S.shape[1:], generator=self.generator) * (2.0 * np.pi)
        y = griffin_lim_batch(S, phase.to(self.device), self.gl_consts,
                              n_iters=c.griffin_lim_iters, momentum=c.griffin_lim_momentum)
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


def gl_magnitude_args(c: AudioConfig) -> dict:
    """`dsp.gl_magnitudes`'s keyword arguments from an audio config."""
    return dict(min_level_db=c.min_level_db, max_norm=c.max_norm, symmetric=c.symmetric_norm,
                clip=c.clip_norm, signal_norm=c.signal_norm, ref_level_db=c.ref_level_db,
                spec_gain=c.spec_gain, power=c.power)


class GriffinLimStage(nn.Module):
    """`AudioProcessor`'s inverse (`_inverse`) as a module of a traced
    serving program: normalized spectrograms [B, T, F] (`kind` "mel", or
    "linear" for Tacotron(1)'s head) and a seed tensor (int64 [1]) ->
    waveforms [B, hop * (T - 1)]. `dsp.gl_magnitudes`, then Griffin-Lim
    through the registered op (`ops/library.py`, which routes by the frame
    count as `griffin_lim_batch` does) from the phase `ops.prng.gl_phase`
    draws from the seed, every row sharing it, then de-emphasis. The window,
    the mel pseudo-inverse and the statistics (where the processor has
    them) are buffers, so an exported program carries them."""

    def __init__(self, ap: AudioProcessor, kind: str):
        from .ops import library  # noqa: F401  (registers the op)

        super().__init__()
        if kind not in ("mel", "linear"):
            raise ValueError(f"kind must be mel or linear, got {kind!r}")
        c = ap.cfg
        self.register_buffer("window", ap.window_t.clone())
        self.register_buffer("inv_mel_basis", ap.inv_mel_basis.clone() if kind == "mel"
                             else None)
        stats = ap.stats(kind)
        self.register_buffer("stats_mean", None if stats is None else stats[0])
        self.register_buffer("stats_std", None if stats is None else stats[1])
        self.magnitude_args = gl_magnitude_args(c)
        self.n_fft, self.hop = c.fft_size, ap.hop_length
        self.n_iters, self.momentum = c.griffin_lim_iters, c.griffin_lim_momentum
        self.preemphasis = c.preemphasis

    def forward(self, spec_norm, seed):
        stats = None if self.stats_mean is None else (self.stats_mean, self.stats_std)
        S = dsp.gl_magnitudes(spec_norm, self.inv_mel_basis, stats=stats, **self.magnitude_args)
        phase = prng.gl_phase(S.shape[1], S.shape[2], seed)
        y = torch.ops.yvt.griffin_lim(S, phase, self.window, self.n_fft, self.hop,
                                      self.n_iters, float(self.momentum))
        return dsp.inv_preemphasis(y, self.preemphasis)
