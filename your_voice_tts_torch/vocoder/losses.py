"""Vocoder losses (the JAX package's vocoder/losses.py): the multi-resolution
STFT loss, the LSGAN adversarial losses and feature matching.

The STFT frames a segment as the reference does for these resolutions (no
n_fft is a multiple of its hop, so it takes `_mirror_indices`): center=True
reflect padding over the segment's own length, the index gather of
ops/dsp.py `mirror_indices` (whose clamp also covers a segment shorter
than n_fft / 2, e.g. 512 samples at n_fft 2048), a Hann window of `win`
centred in n_fft. Every row of a batch has the same length, so each
resolution's frame indices and window are built once per (length, device)
and kept, not once per row and step.
"""

from __future__ import annotations

import functools

import torch

from ..ops.dsp import mirror_indices
from ..ops.filters import hann_window

# (n_fft, hop, win): the reference's multi-resolution settings
DEFAULT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


@functools.lru_cache(maxsize=64)
def _framing(length: int, n_fft: int, hop: int, win: int, device: torch.device):
    """(frame indices [length // hop + 1, n_fft], window [n_fft]) on device."""
    return (mirror_indices(length, length, n_fft, hop).to(device),
            torch.from_numpy(hann_window(win, n_fft)).float().to(device))


def stft_magnitude(y, n_fft: int, hop: int, win: int):
    """y [B, L] -> |STFT| [B, L // hop + 1, n_fft // 2 + 1], floored at
    1e-7."""
    idx, window = _framing(y.shape[-1], n_fft, hop, win, y.device)
    frames = y[:, idx] * window.to(y.dtype)
    return torch.fft.rfft(frames, dim=-1).abs().clamp_min(1e-7)


def stft_loss(y_hat, y, n_fft: int, hop: int, win: int):
    """(spectral convergence, log-magnitude L1) at one resolution: the
    convergence is one Frobenius norm over the whole batch,
    ||m - m_hat|| / max(||m||, 1e-7), as the reference computes it."""
    m_hat, m = stft_magnitude(y_hat, n_fft, hop, win), stft_magnitude(y, n_fft, hop, win)
    sc = torch.linalg.vector_norm(m - m_hat) / torch.linalg.vector_norm(m).clamp_min(1e-7)
    return sc, (torch.log(m) - torch.log(m_hat)).abs().mean()


def multi_scale_stft_loss(y_hat, y, resolutions=DEFAULT_RESOLUTIONS):
    """The mean over the resolutions of spectral convergence + log-magnitude
    L1."""
    total = 0.0
    for n_fft, hop, win in resolutions:
        sc, mag = stft_loss(y_hat, y, n_fft, hop, win)
        total = total + sc + mag
    return total / len(resolutions)


def gen_adv_loss(fake_scores: list):
    """LSGAN, the generator's side: the mean over scales of mean((D(fake) - 1)^2)."""
    return sum(((s - 1.0) ** 2).mean() for s in fake_scores) / len(fake_scores)


def disc_adv_loss(real_scores: list, fake_scores: list):
    """LSGAN, the discriminator's side: the mean over scales of
    mean((D(real) - 1)^2) + mean(D(fake)^2)."""
    return sum(((r - 1.0) ** 2).mean() + (f ** 2).mean()
               for r, f in zip(real_scores, fake_scores)) / len(real_scores)


def feature_match_loss(fake_feats: list, real_feats: list):
    """The mean over every feature map of every scale of mean |fake -
    real|, the real maps detached."""
    terms = [(a - b.detach()).abs().mean() for ff, rf in zip(fake_feats, real_feats)
             for a, b in zip(ff, rf)]
    return sum(terms) / max(len(terms), 1)
