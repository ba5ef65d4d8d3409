"""The port's Parallel WaveGAN generator against the JAX package on the CPU:
the generator with the noise injected on both sides (torch cannot
reproduce `jax.random.normal`), with and without the mel context window;
a GAN checkpoint written by the JAX package's own save, restored into the
port strictly; and the vocoder facade's noise draws. Float32, 1e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from your_voice_tts_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from your_voice_tts_tpu.vocoder.models.pwgan import ParallelWaveganDiscriminator
from your_voice_tts_tpu.vocoder.models.pwgan import ParallelWaveganGenerator as JaxPWGAN
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax
from your_voice_tts_torch.vocoder.models.pwgan import ParallelWaveganGenerator
from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

torch.set_num_threads(1)

# a narrow generator: 6 layers in 2 stacks (dilations 1, 2, 4), hop 8
NARROW = dict(num_layers=6, stacks=2, residual_ch=16, gate_ch=32, skip_ch=16,
              kernel_size=3, upsample_factors=(2, 4))


def jax_params(jm, seed):
    """The JAX init with every bias and every upsample filter perturbed from
    a seed (the init's zero biases and averaging filters hide layouts)."""
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), params)


@pytest.mark.parametrize("aux_context_window", [0, 2])
def test_pwgan_generator_matches_jax(aux_context_window):
    jm = JaxPWGAN(20, aux_context_window=aux_context_window, **NARROW)
    params = jax_params(jm, 5 + aux_context_window)
    port = ParallelWaveganGenerator(20, aux_context_window=aux_context_window, device="cpu",
                                    **NARROW)
    port.load_state_dict(params_from_jax(params, {}, jax_layouts(port)), strict=True)
    rng = np.random.default_rng(aux_context_window)
    mel = rng.standard_normal((2, 9, 20)).astype(np.float32)
    noise = rng.standard_normal((2, 9 * 8)).astype(np.float32)
    ref = np.asarray(jm(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(mel),
                        noise=jnp.asarray(noise)))
    with torch.no_grad():
        got = port(torch.from_numpy(mel), noise=torch.from_numpy(noise)).numpy()
    assert got.shape == ref.shape == (2, 72)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.fixture(scope="module")
def gan_checkpoint(tmp_path_factory):
    """A PWGAN vocoder config (the smoke audio group, hop 64) and a GAN
    checkpoint {'g': generator, 'd': discriminator} written by the JAX
    package's save_checkpoint, with perturbed weights."""
    d = tmp_path_factory.mktemp("pwgan")
    cfg = {"model": "pwgan",
           "audio": {"num_mels": 20, "fft_size": 256, "sample_rate": 8000, "hop_length": 64,
                     "win_length": 256},
           "pwgan": {"num_layers": 6, "stacks": 2, "residual_channels": 16,
                     "gate_channels": 32, "skip_channels": 16, "upsample_factors": [4, 4, 4],
                     "aux_context_window": 2}}
    with open(d / "pwgan.json", "w") as f:
        json.dump(cfg, f)
    jm = JaxPWGAN(20, num_layers=6, stacks=2, residual_ch=16, gate_ch=32, skip_ch=16,
                  upsample_factors=(4, 4, 4), aux_context_window=2)
    g = jax_params(jm, 9)
    disc = ParallelWaveganDiscriminator(num_layers=4, channels=8)
    ckpt = jax_save_checkpoint(str(d / "gan.npz"), params={"g": g, "d": disc.init(
        jax.random.PRNGKey(2))}, model_state={}, opt_state=None, step=3, epoch=0, r=1,
        extra={"vocoder_model": "pwgan"})
    return str(d / "pwgan.json"), ckpt, jm, g


def test_jax_saved_gan_checkpoint_restores_strictly(gan_checkpoint):
    """Every generator leaf lands in the port (and nothing of 'd'); the
    restored generator's output equals the JAX one's on the same noise."""
    cfg, ckpt, jm, g = gan_checkpoint
    port = VocoderSynthesizer(cfg, ckpt, device="cpu")
    assert torch.equal(port.model.aux_conv.weight,
                       torch.from_numpy(g["aux_conv"]["w"].transpose(2, 1, 0).copy()))
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((1, 6, 20)).astype(np.float32)
    noise = rng.standard_normal((1, 6 * 64)).astype(np.float32)
    ref = np.asarray(jm(jax.tree_util.tree_map(jnp.asarray, g), jnp.asarray(mel),
                        noise=jnp.asarray(noise)))
    with torch.no_grad():
        got = port.model(torch.from_numpy(mel), noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_mel_to_wav_draws_noise_a_call(gan_checkpoint):
    """Two calls draw different noise; a seed gives the same wav; a second
    synthesizer with the same rng_seed draws the same sequence."""
    cfg, ckpt, _, _ = gan_checkpoint
    mel = np.random.default_rng(3).standard_normal((20, 6)).astype(np.float32)
    a, b = VocoderSynthesizer(cfg, ckpt, device="cpu"), VocoderSynthesizer(cfg, ckpt,
                                                                            device="cpu")
    first, second = a.mel_to_wav(mel), a.mel_to_wav(mel)
    assert first.shape == second.shape == (6 * 64,) and first.dtype == np.float32
    assert np.isfinite(first).all() and not np.allclose(first, second)
    np.testing.assert_array_equal(b.mel_to_wav(mel), first)
    np.testing.assert_array_equal(a.mel_to_wav(mel, seed=4), a.mel_to_wav(mel, seed=4))
