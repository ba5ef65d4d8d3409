"""DSP (the JAX package's ops/dsp.py). Forward half: pre-emphasis, framing
with librosa's center=True reflect padding, STFT, dB map, range
normalization and the normalized mel spectrogram. Inverse half: mel ->
linear magnitudes, dB maps, istft, a per-utterance Griffin-Lim on
torch.fft, and the de-emphasis IIR. Spectrograms are time-major
[..., T, F]. Plain torch ops; the batched Griffin-Lim kernel is in
ops/griffin_lim.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .griffin_lim import banded_ola, ola_wsum_inv


def preemphasis(y, coef: float):
    """y[n] - coef * y[n - 1] (y[0] passes through), along the last axis."""
    if coef == 0.0:
        return y
    return y - coef * F.pad(y[..., :-1], (1, 0))


def mirror_indices(length: int, l_max: int, n_fft: int, hop: int):
    """[l_max // hop + 1, n_fft] positions into a signal buffer of l_max
    samples implementing center=True reflect padding for a clip of `length`
    samples (the JAX package's `_mirror_indices`; its banded framing is the
    same gather for clips of at least n_fft / 2 samples). Frames past the
    clip's own count read mirrored or clamped samples the caller drops."""
    t = torch.arange(l_max // hop + 1)[:, None]
    p = (t * hop + torch.arange(n_fft)[None, :] - n_fft // 2).abs()
    p = torch.where(p >= length, 2 * length - 2 - p, p)
    return p.clamp(0, l_max - 1)


def frame_signal(y, lengths, n_fft: int, hop: int, window):
    """Signals [B, L_max] with true lengths `lengths` (B ints) -> windowed
    frames [B, L_max // hop + 1, n_fft]."""
    idx = torch.stack([mirror_indices(int(n), y.shape[-1], n_fft, hop) for n in lengths])
    rows = torch.arange(y.shape[0])[:, None, None]
    return y[rows.to(y.device), idx.to(y.device)] * window


def stft(y, lengths, n_fft: int, hop: int, window):
    """Complex STFT, time-major [B, L_max // hop + 1, n_fft // 2 + 1]."""
    return torch.fft.rfft(frame_signal(y, lengths, n_fft, hop, window), dim=-1)


def amp_to_db(x, spec_gain: float = 20.0, min_level_db: float = -100.0):
    min_level = torch.exp(min_level_db / 20.0 * torch.log(torch.tensor(10.0)))
    return spec_gain * torch.log10(torch.maximum(min_level.to(x.device), x))


def normalize_spec(S, min_level_db: float, max_norm: float, symmetric: bool, clip: bool,
                   signal_norm: bool = True):
    """Range normalization of dB-minus-ref values."""
    if not signal_norm:
        return S
    S_norm = (S - min_level_db) / (-min_level_db)
    if symmetric:
        S_norm = 2.0 * max_norm * S_norm - max_norm
        return S_norm.clamp(-max_norm, max_norm) if clip else S_norm
    S_norm = max_norm * S_norm
    return S_norm.clamp(0.0, max_norm) if clip else S_norm


def melspectrogram(y, lengths, *, mel_basis, window, n_fft: int, hop: int,
                   preemph: float, ref_level_db: float, min_level_db: float,
                   spec_gain: float, max_norm: float, symmetric: bool, clip: bool,
                   signal_norm: bool = True):
    """Normalized mel spectrograms of signals [B, L_max] (true lengths
    `lengths`), time-major [B, L_max // hop + 1, n_mels]: pre-emphasis ->
    |STFT| -> mel product (float32) -> dB - ref -> normalize."""
    mag = stft(preemphasis(y, preemph), lengths, n_fft, hop, window).abs()
    S = amp_to_db(mag @ mel_basis.T, spec_gain, min_level_db) - ref_level_db
    return normalize_spec(S, min_level_db, max_norm, symmetric, clip, signal_norm)


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


def gl_magnitudes(spec_norm, inv_basis, *, min_level_db: float, max_norm: float,
                  symmetric: bool, clip: bool, signal_norm: bool, ref_level_db: float,
                  spec_gain: float, power: float):
    """[B, T, F] normalized spectrogram -> the magnitudes Griffin-Lim
    inverts, [B, T, n_fft/2 + 1]: denormalize, dB -> amplitude, mel ->
    linear through the pseudo-inverse basis `inv_basis` [n_freq, n_mels]
    (None for a linear spectrogram), ** power."""
    D = denormalize_spec(spec_norm, min_level_db, max_norm, symmetric, clip, signal_norm)
    S = db_to_amp(D + ref_level_db, spec_gain)
    if inv_basis is not None:
        S = mel_to_linear(S, inv_basis)
    return S ** power


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
