"""The port's three Griffin-Lim routes against the JAX package: the plain
versions of the full-loop kernel (kernel 3) and the per-iteration kernel
(kernel 4) against their Pallas kernels run in interpret mode from the same
injected phase, the router's choice of route, and `inv_spectrogram_batch`
against the JAX chain on the same route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from your_voice_tts_tpu.ops import dsp as jdsp
from your_voice_tts_tpu.ops.filters import hann_window
from your_voice_tts_tpu.ops.pallas.griffin_lim import (gl_iteration_pallas,
                                                       griffin_lim_pallas_batch,
                                                       griffin_lim_pallas_full,
                                                       ola_wsum_inv)
from your_voice_tts_torch import audio as port_audio
from your_voice_tts_torch.audio import AudioProcessor
from your_voice_tts_torch.config import AudioConfig
from your_voice_tts_torch.ops import griffin_lim as gl
from your_voice_tts_torch.ops.griffin_lim import (GL_MAX_TILE, gl_constants, gl_iteration,
                                                  gl_route, griffin_lim_batch,
                                                  griffin_lim_full, packed_constants,
                                                  unpacked_constants)

torch.set_num_threads(1)


def mag_and_phase(B, T, n_fft, seed=0):
    rng = np.random.default_rng(seed)
    Kf = n_fft // 2 + 1
    mag = (np.abs(rng.standard_normal((B, T, Kf))) + 0.1).astype(np.float32)
    ph = (rng.uniform(size=(T, Kf)) * 2 * np.pi).astype(np.float32)
    return mag, ph


def window(n_fft, win_length=None):
    return hann_window(win_length or n_fft, n_fft).astype(np.float32)


# float32 loop state on both sides: they differ only in summation order;
# 2e-4 is the Pallas wave-vs-istft tolerance (tests/test_pallas_kernels.py:175),
# as for the wave route (tests/test_torch_griffin_lim.py); n_fft 2048 sums
# 8x more terms per product, so its rounding is ~3x larger (5e-4)
@pytest.mark.parametrize("n_fft,win,hop,B,T,iters,momentum,tol", [
    (256, 256, 64, 2, 24, 3, 0.0, 2e-4),
    (256, 256, 64, 2, 24, 3, 0.95, 2e-4),
    (2048, 1102, 275, 1, 12, 2, 0.0, 5e-4),     # a 12.5 ms hop at 22.05 kHz
    (2048, 1102, 275, 1, 12, 2, 0.95, 5e-4),
])
def test_full_plain_matches_pallas_full(n_fft, win, hop, B, T, iters, momentum, tol):
    mag, ph = mag_and_phase(B, T, n_fft)
    w = window(n_fft, win)
    with pltpu.force_tpu_interpret_mode():
        ref = griffin_lim_pallas_full(
            jnp.asarray(mag), 0, n_iters=iters, n_fft=n_fft, hop=hop, window=jnp.asarray(w),
            dtype=jnp.float32, init_phase=jnp.broadcast_to(jnp.asarray(ph), mag.shape),
            momentum=momentum)
    got = griffin_lim_full(torch.from_numpy(mag), torch.from_numpy(ph),
                           packed_constants(n_fft, hop, w, torch.float32),
                           n_iters=iters, momentum=momentum)
    assert got.dtype == torch.complex64 and got.shape == mag.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol)


@pytest.mark.parametrize("n_fft,hop,dtype,tol", [
    (256, 64, "float32", 1e-4),
    (256, 64, "bfloat16", 2e-3),
    (512, 128, "float32", 1e-4),
])
def test_iteration_plain_matches_pallas_iteration(n_fft, hop, dtype, tol):
    """One plain iteration from the same (Fr, Fi): float32 differs by sum
    order only; bf16 rounds the same inputs on both sides, so only a rare
    one-ulp flip of a rounded value separates them."""
    B, T = 2, 16
    mag, ph = mag_and_phase(B, T, n_fft, seed=1)
    Fr, Fi = mag * np.cos(ph), mag * np.sin(ph)
    w = window(n_fft)
    Kf = n_fft // 2 + 1
    ref = gl_iteration_pallas(
        jnp.asarray(Fr.reshape(B * T, Kf)), jnp.asarray(Fi.reshape(B * T, Kf)),
        jnp.asarray(mag.reshape(B * T, Kf)), jnp.asarray(w),
        jnp.asarray(ola_wsum_inv(w, n_fft, hop)), n_fft, hop, tile=T, interpret=True,
        dtype=getattr(jnp, dtype))
    got = gl_iteration(torch.from_numpy(Fr), torch.from_numpy(Fi), torch.from_numpy(mag),
                       unpacked_constants(n_fft, hop, w, getattr(torch, dtype)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.reshape(B * T, Kf).numpy(), np.asarray(b), atol=tol)


def test_iteration_loop_matches_pallas_batch():
    """Three iterations from one shared phase: the port's loop of
    `gl_iteration` against `griffin_lim_pallas_batch` (bf16 products, as the
    reference's loop runs them); the returned angles agree."""
    n_fft, hop, B, T, iters = 256, 64, 2, 21, 3
    mag, ph = mag_and_phase(B, T, n_fft, seed=2)
    w = window(n_fft)
    ref = griffin_lim_pallas_batch(jnp.asarray(mag), jax.random.PRNGKey(0), n_iters=iters,
                                   n_fft=n_fft, hop=hop, window=jnp.asarray(w),
                                   interpret=True, init_phase=jnp.asarray(ph))
    m, p = torch.from_numpy(mag), torch.from_numpy(ph)
    Fr, Fi = gl_iteration(m * torch.cos(p), m * torch.sin(p), m,
                          unpacked_constants(n_fft, hop, w), n_iters=iters)
    ang = torch.complex(Fr, Fi) / m.clamp_min(1e-16)
    np.testing.assert_allclose(ang.numpy(), np.asarray(ref), atol=5e-3)


@pytest.mark.parametrize("T,n_fft,hop,route", [
    (512, 1024, 256, "wave"),            # the Tacotron2 main path
    (GL_MAX_TILE, 1024, 256, "wave"),
    (512, 256, 64, "full"),              # the smoke config
    (512, 2048, 275, "full"),            # a 12.5 ms hop
    (1056, 1024, 256, "iteration"),      # Tacotron(1) at r = 7
    (1056, 256, 64, "iteration"),
])
def test_router_picks_the_reference_route(T, n_fft, hop, route):
    assert gl_route(T, n_fft, hop) == route


@pytest.mark.parametrize("B,T,n_fft,hop,route", [
    (2, 64, 512, 128, "wave"),
    (1, 64, 256, 64, "full"),
    (3, 64, 256, 64, "full"),
    (1, 1056, 256, 64, "iteration"),     # one row over the cap: plain GL too
    (2, 1056, 256, 64, "iteration"),
])
def test_griffin_lim_batch_runs_the_route(monkeypatch, B, T, n_fft, hop, route):
    """Every B, one row included, takes the route of its frame count; the
    waveform has hop * (T - 1) samples."""
    called = []
    for name in ("griffin_lim_wave", "griffin_lim_full", "gl_iteration"):
        fn = getattr(gl, name)
        monkeypatch.setattr(gl, name, lambda *a, _n=name, _f=fn, **k: called.append(_n)
                            or _f(*a, **k))
    mag, ph = mag_and_phase(B, T, n_fft, seed=3)
    y = griffin_lim_batch(torch.from_numpy(mag), torch.from_numpy(ph),
                          gl_constants(n_fft, hop, window(n_fft)), n_iters=1, momentum=0.9)
    expect = {"wave": "griffin_lim_wave", "full": "griffin_lim_full",
              "iteration": "gl_iteration"}[route]
    assert called == [expect] and y.shape == (B, hop * (T - 1))


def test_iteration_route_ignores_momentum():
    n_fft, hop = 256, 64
    mag, ph = mag_and_phase(1, 1040, n_fft, seed=4)
    c = gl_constants(n_fft, hop, window(n_fft))
    a, b = (griffin_lim_batch(torch.from_numpy(mag), torch.from_numpy(ph), c, n_iters=2,
                              momentum=m) for m in (0.0, 0.95))
    assert torch.equal(a, b)


def jax_ap(**kw):
    from your_voice_tts_tpu.audio import AudioProcessor as JaxAP
    from your_voice_tts_tpu.config import AudioConfig as JaxAudioConfig
    return JaxAP(JaxAudioConfig(**kw))


@pytest.mark.parametrize("n_frames,route", [(45, "full"), (1030, "iteration")])
def test_inv_spectrogram_batch_matches_jax_chain(n_frames, route):
    """Normalized linear specs -> wav, the JAX chain composed from its pieces
    with the port's shared phase injected (denormalize, dB -> amplitude,
    ** power, the route's Pallas kernel in interpret mode + istft,
    de-emphasis); the port pads rows and frames with normalized silence as
    the reference does."""
    kw = dict(num_mels=20, fft_size=256, sample_rate=8000, hop_length=64, win_length=256,
              mel_fmax=None, griffin_lim_iters=2)
    cfg = AudioConfig(**kw)
    rng = np.random.default_rng(6)
    specs = [rng.uniform(-4, 0, (129, n)).astype(np.float32) for n in (n_frames, n_frames - 5)]
    got = AudioProcessor(cfg, seed=3).inv_spectrogram_batch(specs)
    tb = port_audio.AudioProcessor(cfg)._frame_bucket(n_frames)
    assert gl_route(tb, 256, 64) == route
    phase = (torch.rand((tb, 129), generator=torch.Generator().manual_seed(3))
             * (2.0 * np.pi)).numpy()
    buf = np.full((2, tb, 129), -cfg.max_norm, np.float32)
    for j, S in enumerate(specs):
        buf[j, : S.shape[1]] = S.T
    jap = jax_ap(**kw)
    w = jnp.asarray(jap.window)
    D = jdsp.denormalize_spec(jnp.asarray(buf), cfg.min_level_db, cfg.max_norm,
                              cfg.symmetric_norm, cfg.clip_norm)
    S = jdsp.db_to_amp(D + cfg.ref_level_db, cfg.spec_gain) ** cfg.power
    if route == "full":
        with pltpu.force_tpu_interpret_mode():
            F_ = griffin_lim_pallas_full(S, 0, n_iters=2, n_fft=256, hop=64, window=w,
                                         init_phase=jnp.broadcast_to(phase, S.shape),
                                         momentum=cfg.griffin_lim_momentum)
    else:
        F_ = S * griffin_lim_pallas_batch(S, None, n_iters=2, n_fft=256, hop=64, window=w,
                                          interpret=True, init_phase=jnp.asarray(phase))
    y = jax.vmap(lambda f: jdsp.istft(f, 256, 64, w))(F_)
    ref = np.asarray(jdsp.inv_preemphasis(y, cfg.preemphasis))
    for j, (S_, g) in enumerate(zip(specs, got)):
        n = 64 * (S_.shape[1] - 1)
        assert g.shape == (n,)
        # bf16 loop state on both sides; the de-emphasis IIR gains up to 50x
        np.testing.assert_allclose(g, ref[j, :n], atol=2e-2 * np.abs(ref[j, :n]).max())
