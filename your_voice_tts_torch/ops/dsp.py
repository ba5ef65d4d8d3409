"""Inverse DSP (the inverse half of the JAX package's ops/dsp.py): mel ->
linear magnitudes, dB maps, istft, a per-utterance Griffin-Lim on
torch.fft, and the de-emphasis IIR. Spectrograms are time-major
[..., T, F]. Plain torch ops; the batched Griffin-Lim kernel is in
ops/griffin_lim.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .griffin_lim import banded_ola, ola_wsum_inv


def denormalize_spec(S, min_level_db: float, max_norm: float,
                     symmetric: bool, clip: bool, signal_norm: bool = True):
    """Inverse of the range normalization."""
    if not signal_norm:
        return S
    if symmetric:
        if clip:
            S = S.clamp(-max_norm, max_norm)
        S = (S + max_norm) / (2.0 * max_norm)
    else:
        if clip:
            S = S.clamp(0.0, max_norm)
        S = S / max_norm
    return S * (-min_level_db) + min_level_db


def db_to_amp(x, spec_gain: float = 20.0):
    return torch.pow(10.0, x / spec_gain)


def mel_to_linear(M, inv_basis):
    """Time-major mel [..., T, n_mels] -> linear magnitude [..., T, n_freq]
    (pseudo-inverse basis, floored at 1e-10)."""
    return torch.clamp(M @ inv_basis.T, min=1e-10)


def istft(D, n_fft: int, hop: int, window):
    """Inverse STFT (librosa semantics, center padding removed): complex
    [..., T, n_freq] -> [..., hop * (T - 1)]."""
    T = D.shape[-2]
    lead = D.shape[:-2]
    frames = torch.fft.irfft(D, n=n_fft, dim=-1) * window         # [..., T, N]
    total = n_fft + hop * (T - 1)
    fold = lambda x: F.fold(x.reshape(-1, T, n_fft).transpose(1, 2),  # noqa: E731
                            (1, total), (1, n_fft), stride=(1, hop)).reshape(-1, total)
    y = fold(frames)
    wsum = fold((window ** 2).expand(1, T, n_fft))[0]
    y = torch.where(wsum > 1e-11, y / wsum.clamp_min(1e-11), y)
    pad = n_fft // 2
    return y[:, pad: total - pad].reshape(*lead, hop * (T - 1))


def griffin_lim(S_mag, init_phase, *, n_iters: int, n_fft: int, hop: int,
                window, momentum: float = 0.0):
    """Per-utterance FGLA on torch.fft (the JAX package's `griffin_lim`,
    fast route): magnitudes [T, n_freq] and initial phase [T, n_freq] ->
    waveform [hop * (T - 1)]. Each projection is irfft -> window -> banded
    OLA -> interior window-square normalization -> window -> rfft; the
    extrapolated projection's unit phase re-imposes the magnitudes."""
    wsi = torch.from_numpy(ola_wsum_inv(window.cpu().numpy(), n_fft, hop)).to(S_mag.device)
    a = torch.polar(torch.ones_like(S_mag), init_phase)
    prev = S_mag * a
    for _ in range(n_iters):
        xw = torch.fft.irfft(S_mag * a, n=n_fft, dim=-1) * window
        G = torch.fft.rfft(banded_ola(xw, n_fft, hop) * wsi * window, dim=-1)
        t = G + momentum * (G - prev)
        a = t / t.abs().clamp_min(1e-16)
        prev = G
    return istft(S_mag * a, n_fft, hop, window)


def inv_preemphasis(y, coef: float, block: int = 256):
    """De-emphasis IIR y[n] = x[n] + coef * y[n - 1] along the last axis as a
    blocked scan: a Toeplitz matrix product solves every block from a zero
    state, and the carries between blocks (a recurrence with coefficient
    coef^block over the block ends) are solved the same way, so no step
    runs per sample or per block."""
    if coef == 0.0:
        return y
    L = y.shape[-1]
    nb = -(-L // block)
    x = F.pad(y, (0, nb * block - L)).reshape(*y.shape[:-1], nb, block)
    dev, dt = y.device, y.dtype
    i = torch.arange(block, device=dev)
    lag = i[None, :] - i[:, None]                                 # j - i
    toe = torch.where(lag >= 0, coef ** lag.clamp_min(0).to(torch.float64), 0.0).to(dt)
    local = x @ toe                                              # zero-state blocks
    k = torch.arange(nb, device=dev)
    blag = k[None, :] - k[:, None]
    step = coef ** block
    toe_b = torch.where(blag >= 0, step ** blag.clamp_min(0).to(torch.float64), 0.0).to(dt)
    carry = local[..., -1] @ toe_b                                # y at each block end
    prev = F.pad(carry[..., :-1], (1, 0))                         # y before each block
    decay = (coef ** (i + 1).to(torch.float64)).to(dt)
    out = local + prev[..., None] * decay
    return out.reshape(*y.shape[:-1], nb * block)[..., :L]
