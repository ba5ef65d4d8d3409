"""Filterbank / window constants (host-side numpy; computed once at setup).

Slaney-scale mel filterbank and periodic Hann window matching the librosa
conventions the reference's AudioProcessor relies on (reference:
utils/audio.py `_build_mel_basis`, librosa.filters.mel with htk=False,
norm='slaney'). The port's copy of the JAX package's ops/filters.py.
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0          # linear region: mels per Hz below the break
_MIN_LOG_HZ = 1000.0         # linear/log break frequency
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    lin = f / _F_SP
    log = _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, log, lin)


def mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    lin = m * _F_SP
    log = _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL))
    return np.where(m >= _MIN_LOG_MEL, log, lin)


def mel_basis(sample_rate: int, n_fft: int, n_mels: int,
              fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] Slaney-normalized triangular filterbank."""
    fmax = sample_rate / 2.0 if fmax is None else fmax
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    pts_hz = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(pts_hz)
    ramps = pts_hz[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney area normalization: each triangle integrates to ~constant energy.
    w *= (2.0 / (pts_hz[2:] - pts_hz[:-2]))[:, None]
    return w


def inv_mel_basis(basis: np.ndarray) -> np.ndarray:
    """Pseudo-inverse used by the reference's _mel_to_linear."""
    return np.linalg.pinv(basis)


def hann_window(win_length: int, n_fft: int | None = None) -> np.ndarray:
    """Periodic Hann of win_length, optionally zero-padded (centered) to n_fft."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    if n_fft is None or n_fft == win_length:
        return w
    out = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    out[off: off + win_length] = w
    return out
