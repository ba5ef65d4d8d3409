"""The port's Griffin-Lim (plain PyTorch version of the CUDA wave kernel) and
inverse DSP against the JAX package: the Pallas wave kernel run in
interpret mode from the same injected phase, the XLA istft and de-emphasis,
and the reconstruction quality gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from your_voice_tts_tpu.ops import dsp as jdsp
from your_voice_tts_tpu.ops.filters import hann_window
from your_voice_tts_tpu.ops.pallas.griffin_lim import griffin_lim_pallas_wave
from your_voice_tts_torch.audio import AudioProcessor
from your_voice_tts_torch.config import AudioConfig
from your_voice_tts_torch.ops import dsp
from your_voice_tts_torch.ops.griffin_lim import griffin_lim_wave, packed_constants

torch.set_num_threads(1)


def mag_and_phase(B, T, n_fft, seed=0):
    rng = np.random.default_rng(seed)
    Kf = n_fft // 2 + 1
    mag = (np.abs(rng.standard_normal((B, T, Kf))) + 0.1).astype(np.float32)
    ph = (rng.uniform(size=(B, T, Kf)) * 2 * np.pi).astype(np.float32)
    return mag, ph


# float32 loop state: the two sides differ only in summation order; 2e-4
# is the Pallas wave-vs-istft tolerance (tests/test_pallas_kernels.py:175)
@pytest.mark.parametrize("n_fft,hop,B,T,iters,momentum", [
    (256, 64, 2, 24, 3, 0.0),
    (256, 64, 2, 24, 3, 0.95),
    (1024, 256, 1, 16, 2, 0.95),     # the serving alignment
])
def test_gl_plain_matches_pallas_wave(n_fft, hop, B, T, iters, momentum):
    mag, ph = mag_and_phase(B, T, n_fft)
    w = hann_window(n_fft, n_fft).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = griffin_lim_pallas_wave(
            jnp.asarray(mag), 0, n_iters=iters, n_fft=n_fft, hop=hop,
            window=jnp.asarray(w), dtype=jnp.float32, init_phase=jnp.asarray(ph),
            momentum=momentum)
    got = griffin_lim_wave(torch.from_numpy(mag), torch.from_numpy(ph),
                           packed_constants(n_fft, hop, w, torch.float32),
                           n_iters=iters, momentum=momentum)
    assert got.shape == (B, hop * (T - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


def test_packed_loop_matches_fft_griffin_lim():
    """The packed layout with folded constants is the textbook Griffin-Lim:
    it agrees with the per-utterance torch.fft version (float32). Momentum
    0: with momentum the packed loop keeps the Nyquist bin real where the
    fft version carries its initial imaginary part into the extrapolation."""
    n_fft, hop = 256, 64
    mag, ph = mag_and_phase(1, 20, n_fft, seed=1)
    w = hann_window(n_fft, n_fft).astype(np.float32)
    packed = griffin_lim_wave(torch.from_numpy(mag), torch.from_numpy(ph[0]),
                              packed_constants(n_fft, hop, w, torch.float32),
                              n_iters=4)
    fft = dsp.griffin_lim(torch.from_numpy(mag[0]), torch.from_numpy(ph[0]), n_iters=4,
                          n_fft=n_fft, hop=hop, window=torch.from_numpy(w))
    np.testing.assert_allclose(packed[0].numpy(), fft.numpy(), atol=1e-4)


def test_istft_matches_jax():
    n_fft, hop = 256, 64
    rng = np.random.default_rng(2)
    D = (rng.standard_normal((10, 129)) + 1j * rng.standard_normal((10, 129))).astype(np.complex64)
    w = hann_window(n_fft, n_fft).astype(np.float32)
    ref = jdsp.istft(jnp.asarray(D), n_fft, hop, jnp.asarray(w))
    got = dsp.istft(torch.from_numpy(D), n_fft, hop, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_inv_preemphasis_matches_jax():
    """Blocked Toeplitz scan vs the reference's associative scan; the IIR
    gains up to 1/(1 - 0.98) = 50x, so f32 rounding reaches ~1e-5."""
    y = np.random.default_rng(3).standard_normal((2, 3001)).astype(np.float32)
    ref = jdsp.inv_preemphasis(jnp.asarray(y), 0.98)
    got = dsp.inv_preemphasis(torch.from_numpy(y), 0.98)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-5)


def test_mel_to_linear_chain_matches_jax():
    cfg = AudioConfig(num_mels=20, fft_size=256, sample_rate=8000, hop_length=64,
                      win_length=256, mel_fmax=None)
    ap = AudioProcessor(cfg)
    from your_voice_tts_tpu.audio import AudioProcessor as JaxAP
    from your_voice_tts_tpu.config import AudioConfig as JaxAudioConfig
    jap = JaxAP(JaxAudioConfig(num_mels=20, fft_size=256, sample_rate=8000,
                               hop_length=64, win_length=256, mel_fmax=None))
    mel = np.random.default_rng(4).uniform(-4, 4, (3, 17, 20)).astype(np.float32)
    D = jdsp.denormalize_spec(jnp.asarray(mel), cfg.min_level_db, cfg.max_norm,
                              cfg.symmetric_norm, cfg.clip_norm)
    ref = jdsp.mel_to_linear(jdsp.db_to_amp(D + cfg.ref_level_db, cfg.spec_gain),
                             jnp.asarray(jap.inv_mel_basis))
    Dt = dsp.denormalize_spec(torch.from_numpy(mel), cfg.min_level_db, cfg.max_norm,
                              cfg.symmetric_norm, cfg.clip_norm)
    got = dsp.mel_to_linear(dsp.db_to_amp(Dt + cfg.ref_level_db, cfg.spec_gain),
                            ap.inv_mel_basis)
    # the pseudo-inverse sums terms of both signs: small outputs carry the
    # large terms' f32 rounding
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_gl_reconstruction_gate():
    """|STFT(GL(S))| approaches S (err/sig <= 0.25, the JAX package's gate)
    with the serving loop state (bf16) and a shared random initial phase."""
    n_fft, hop, T = 256, 64, 40
    n = hop * (T + 3)
    t = np.arange(n) / 8000.0
    wav = np.stack([
        0.6 * np.sin(2 * np.pi * 440.0 * t) + 0.2 * np.sin(2 * np.pi * 1313.0 * t),
        0.5 * np.sin(2 * np.pi * 220.0 * t) * np.linspace(0.2, 1.0, n),
    ]).astype(np.float32)
    w = hann_window(n_fft, n_fft).astype(np.float32)
    stft = jax.vmap(lambda y, L: jdsp.stft(y, L, n_fft, hop, jnp.asarray(w)), (0, None))
    S = np.abs(np.asarray(stft(jnp.asarray(wav), jnp.int32(n))))[:, :T]
    phase = torch.rand((T, n_fft // 2 + 1), generator=torch.Generator().manual_seed(0)) * 2 * np.pi
    y = griffin_lim_wave(torch.from_numpy(S), phase, packed_constants(n_fft, hop, w),
                         n_iters=30)
    assert y.shape == (2, hop * (T - 1)) and torch.isfinite(y).all()
    S2 = np.abs(np.asarray(stft(jnp.asarray(y.numpy()), jnp.int32(y.shape[1]))))[:, :T]
    err = float(np.linalg.norm(S2 - S) / np.linalg.norm(S))
    assert err <= 0.25, f"GL reconstruction err/sig {err:.3f} > 0.25"


def test_inverse_batch_is_batch_invariant():
    """A row's audio does not depend on its batchmates: silence-padded
    frames and rows, and one shared phase pattern per launch."""
    cfg = AudioConfig(num_mels=20, fft_size=256, sample_rate=8000, hop_length=64,
                      win_length=256, mel_fmax=None, griffin_lim_iters=3)
    rng = np.random.default_rng(5)
    a = rng.uniform(-4, 0, (20, 30)).astype(np.float32)
    b = rng.uniform(-4, 0, (20, 25)).astype(np.float32)
    solo = AudioProcessor(cfg, seed=1).inv_melspectrogram_batch([a])
    pair = AudioProcessor(cfg, seed=1).inv_melspectrogram_batch([a, b])
    assert solo[0].shape == (64 * 29,) and pair[1].shape == (64 * 24,)
    np.testing.assert_allclose(solo[0], pair[0], atol=1e-6)
