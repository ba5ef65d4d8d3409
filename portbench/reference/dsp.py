"""The audio half of the plain reference: the mel filterbank and its
pseudo-inverse, the Griffin-Lim magnitudes of a normalized mel, fast
Griffin-Lim (FGLA) written out with the DFT as products whose operands a
precision mode rounds, the spectral convergence that judges a waveform
against its magnitudes, silence trimming and the 16-bit WAV container.

Written from the recipe's definitions (librosa's Slaney mel scale, a
periodic Hann window, range normalization, FGLA with momentum) in numpy
and plain torch; nothing here comes from the program under test."""

from __future__ import annotations

import io
import wave

import numpy as np
import torch

from .precision import rounder

# --------------------------------------------------------------- filterbank


def hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f * 3.0 / 200.0
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * 200.0 / 3.0
    log = 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """[n_mels, n_fft / 2 + 1] Slaney-normalized triangles (librosa's
    htk=False, norm="slaney")."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    ramps = pts[:, None] - freqs[None, :]
    lower = -ramps[:-2] / np.diff(pts)[:-1, None]
    upper = ramps[2:] / np.diff(pts)[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    return w * (2.0 / (pts[2:] - pts[:-2]))[:, None]


def hann(n_fft: int, win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    out = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    out[off:off + win_length] = w
    return out


class Audio:
    """The audio group of a configuration, with its constants on `device`."""

    def __init__(self, audio: dict, device="cpu"):
        a = audio
        self.sr, self.n_fft, self.hop = a["sample_rate"], a["fft_size"], a["hop_length"]
        self.n_mels, self.power = a["num_mels"], a["power"]
        self.min_db, self.ref_db = a["min_level_db"], a["ref_level_db"]
        self.max_norm = a["max_norm"]
        self.gain, self.preemph = a.get("spec_gain", 20.0), a["preemphasis"]
        self.iters, self.momentum = a["griffin_lim_iters"], a["griffin_lim_momentum"]
        if not (a["signal_norm"] and a["symmetric_norm"] and a["clip_norm"]):
            raise ValueError("the reference takes symmetric, clipped range normalization")
        basis = mel_basis(self.sr, self.n_fft, self.n_mels, a["mel_fmin"], a["mel_fmax"])
        self.device = torch.device(device)
        self.inv_basis = torch.tensor(np.linalg.pinv(basis), dtype=torch.float32,
                                      device=self.device)
        self.window = torch.tensor(hann(self.n_fft, a.get("win_length") or self.n_fft),
                                   dtype=torch.float32, device=self.device)
        k = np.arange(self.n_fft // 2 + 1)
        n = np.arange(self.n_fft)
        ang = 2.0 * np.pi * np.outer(n, k) / self.n_fft
        # rfft as products: X = x @ (C - iS); irfft: x = Re @ Ci - Im @ Si
        self.C = torch.tensor(np.cos(ang), dtype=torch.float32, device=self.device)
        self.S = torch.tensor(np.sin(ang), dtype=torch.float32, device=self.device)
        wk = np.full(k.shape, 2.0)
        wk[0] = wk[-1] = 1.0
        self.Ci = torch.tensor((np.cos(ang) * wk).T / self.n_fft, dtype=torch.float32,
                               device=self.device)
        self.Si = torch.tensor((np.sin(ang) * wk).T / self.n_fft, dtype=torch.float32,
                               device=self.device)

    def magnitudes(self, mel_norm):
        """Normalized mels [B, T, n_mels] -> linear magnitudes ** power
        [B, T, n_fft / 2 + 1]."""
        m = mel_norm.float().clamp(-self.max_norm, self.max_norm)
        db = (m + self.max_norm) / (2.0 * self.max_norm) * (-self.min_db) + self.min_db
        amp = torch.pow(10.0, (db + self.ref_db) / self.gain)
        return torch.clamp(amp @ self.inv_basis.T, min=1e-10) ** self.power

    # ---------------------------------------------------------- Griffin-Lim

    def _frames(self, x, T: int):
        """Signals [B, (T - 1) hop + n_fft] -> windowed frames [B, T, n_fft]."""
        return x.unfold(-1, self.n_fft, self.hop)[:, :T] * self.window

    def _ola(self, frames):
        """Windowed frames [B, T, n_fft] -> overlap-added, divided by the
        overlap-added squared window: [B, (T - 1) hop + n_fft]."""
        B, T, N = frames.shape
        L = (T - 1) * self.hop + N
        fold = lambda f: torch.nn.functional.fold(  # noqa: E731
            f.transpose(1, 2), (1, L), (1, N), stride=(1, self.hop))[:, 0, 0]
        wsum = fold((self.window ** 2).expand(1, T, N))
        return fold(frames * self.window) / wsum.clamp_min(1e-8)

    def griffin_lim(self, mag, phase, mode: str = "f32"):
        """FGLA: magnitudes [B, T, F], initial phase [T, F] or [B, T, F] ->
        the whole overlap-added signal [B, (T - 1) hop + n_fft]. Each iteration
        projects onto consistent spectra (STFT of the inverse STFT), steps
        by the momentum from the previous projection, and takes the
        target magnitudes with the stepped phase."""
        rnd = rounder(mode)
        C, S, Ci, Si = (rnd(m) for m in (self.C, self.S, self.Ci, self.Si))
        T = mag.shape[1]

        def inverse(re, im):
            return self._ola(rnd(re) @ Ci - rnd(im) @ Si)

        def forward(x):
            f = rnd(self._frames(x, T))
            return f @ C, -(f @ S)

        re, im = mag * torch.cos(phase), mag * torch.sin(phase)
        pre, pim = re, im
        for _ in range(self.iters):
            gre, gim = forward(inverse(re, im))
            tre = gre + self.momentum * (gre - pre)
            tim = gim + self.momentum * (gim - pim)
            inv = torch.rsqrt(torch.clamp(tre * tre + tim * tim, min=1e-30))
            re, im = mag * tre * inv, mag * tim * inv
            pre, pim = gre, gim
        return inverse(re, im)

    def wave_of(self, full, T: int):
        """The served span of an overlap-added signal: [n_fft / 2,
        n_fft / 2 + (T - 1) hop)."""
        h = self.n_fft // 2
        return full[..., h:h + (T - 1) * self.hop]

    def spectral_convergence(self, y, mag) -> float:
        """|| mag - |STFT(y)| || / || mag || over the frames that lie whole
        inside y: y [L] is a served span (`wave_of`) of magnitudes
        mag [T, F]; its frame j is the whole signal's frame j + n_fft / (2 hop)."""
        off = self.n_fft // (2 * self.hop)
        n = min((y.shape[-1] - self.n_fft) // self.hop + 1, mag.shape[0] - 2 * off)
        f = y[None].unfold(-1, self.n_fft, self.hop)[:, :n] * self.window
        got = torch.sqrt((f @ self.C) ** 2 + (f @ self.S) ** 2)[0]
        want = mag[off:off + n]
        return float(torch.linalg.norm(want - got) / torch.linalg.norm(want))

    def preemphasis(self, wav):
        """x[n] - coef x[n - 1]: undoes the served waveform's de-emphasis."""
        return wav - self.preemph * torch.nn.functional.pad(wav[..., :-1], (1, 0))

    # ---------------------------------------------------------- the endpoint

    def endpoint(self, wav: np.ndarray, threshold_db: float = -40.0,
                 min_silence_sec: float = 0.8) -> int:
        """The first sample after which min_silence_sec stays below
        threshold_db (scanned in quarter windows), else the length."""
        win = int(self.sr * min_silence_sec)
        hop = win // 4
        threshold = 10.0 ** (threshold_db / self.gain)
        for x in range(hop, len(wav) - win, hop):
            if np.max(np.abs(wav[x:x + win])) < threshold:
                return x + hop
        return len(wav)

    def wav_bytes(self, wav: np.ndarray) -> bytes:
        """Peak-normalized 16-bit mono WAV container."""
        if wav.size == 0:
            wav = np.zeros((1,), np.float32)
        pcm = (wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))).astype(np.int16)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(self.sr)
            f.writeframes(pcm.tobytes())
        return buf.getvalue()
