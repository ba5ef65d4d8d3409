"""The port's MelGAN generator and its layers against the JAX package on
the CPU: the transposed conv and the reflect-padded dilated conv, a narrow
generator through params_from_jax, and the trained asset
(assets/bench_trained_melgan.npz with configs/melgan_smoke.json) through
both packages' VocoderSynthesizer.mel_to_wav. Inputs come from numpy
seeds; float32 throughout, so the outputs differ by sum order only (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from your_voice_tts_tpu.nn.core import Conv1d as JaxConv1d
from your_voice_tts_tpu.nn.core import ConvTranspose1d as JaxConvTranspose1d
from your_voice_tts_tpu.vocoder.models.melgan import MelganGenerator as JaxMelgan
from your_voice_tts_tpu.vocoder.synthesizer import VocoderSynthesizer as JaxVocoder
from your_voice_tts_torch.nn.core import Conv1d, ConvTranspose1d
from your_voice_tts_torch.train.checkpoint import jax_layouts, params_from_jax
from your_voice_tts_torch.vocoder.models.melgan import MelganGenerator
from your_voice_tts_torch.vocoder.synthesizer import VocoderSynthesizer

torch.set_num_threads(1)

MELGAN_CFG, MELGAN_CKPT = "configs/melgan_smoke.json", "assets/bench_trained_melgan.npz"


def load_into(module: nn.Module, params: dict) -> nn.Module:
    module.load_state_dict(params_from_jax(params, {}, jax_layouts(module)), strict=True)
    return module


def run_layer(jax_layer, port_layer, x):
    """The JAX layer's seeded weights in the port's layer; both outputs."""
    p = jax_layer.init(jax.random.PRNGKey(3))
    p["b"] = jnp.asarray(np.random.default_rng(4).standard_normal(p["b"].shape), jnp.float32)
    port = load_into(nn.ModuleDict({"layer": port_layer}), {"layer": p})["layer"]
    ref = np.asarray(jax_layer(p, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    return got, ref


@pytest.mark.parametrize("stride", [2, 3, 4, 8])
def test_conv_transpose_matches_jax(stride):
    """[B, T, C] -> [B, T * stride, C'] for even and odd strides: the JAX
    [k, in, out] flipped weight carried into torch's [in, out, k]."""
    x = np.random.default_rng(stride).standard_normal((2, 7, 6)).astype(np.float32)
    got, ref = run_layer(JaxConvTranspose1d(6, 5, 2 * stride, stride),
                         ConvTranspose1d(6, 5, 2 * stride, stride), x)
    assert got.shape == ref.shape == (2, 7 * stride, 5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("k,dilation,pad_mode", [(3, 1, "reflect"), (3, 3, "reflect"),
                                                 (3, 9, "reflect"), (7, 1, "reflect"),
                                                 (4, 2, "reflect"), (3, 4, "zeros")])
def test_dilated_conv_matches_jax(k, dilation, pad_mode):
    """"same" padding of dilation x (k - 1), split as the JAX layer splits
    it (the odd one on the right), mirrored or zero-filled."""
    x = np.random.default_rng(k * dilation).standard_normal((2, 23, 5)).astype(np.float32)
    got, ref = run_layer(JaxConv1d(5, 4, k, dilation=dilation, pad_mode=pad_mode),
                         Conv1d(5, 4, k, dilation=dilation, pad_mode=pad_mode), x)
    assert got.shape == ref.shape == (2, 23, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_melgan_generator_matches_jax():
    """A narrow generator (20 mels, factors 4, 3, 2: an odd stride, base 32,
    3 residual blocks a stage: dilations 1, 3, 9) with the JAX init's
    weights and seeded biases."""
    factors = (4, 3, 2)
    jm = JaxMelgan(20, factors, base_channels=32, num_res_blocks=3)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32) if a.ndim == 1 else a,
        params)
    port = load_into(MelganGenerator(20, factors, 32, 3, device="cpu"), params)
    mel = rng.standard_normal((2, 11, 20)).astype(np.float32)
    ref = np.asarray(jm(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(mel)))
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
    assert port.hop == 24 and got.shape == ref.shape == (2, 11 * 24)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.fixture(scope="module")
def smoke_mel():
    """A normalized mel [20, T] of one synthetic clip at the smoke config's
    audio settings (the port's AudioProcessor)."""
    import tempfile

    from your_voice_tts_torch.audio import AudioProcessor
    from your_voice_tts_torch.data.synthetic import make_synthetic_corpus
    from your_voice_tts_torch.vocoder.config import load_vocoder_config

    ap = AudioProcessor(load_vocoder_config(MELGAN_CFG).audio)
    with tempfile.TemporaryDirectory() as tmp:
        make_synthetic_corpus(tmp, n_items=1, sr=8000, seed=11)
        import glob

        wav = ap.load_wav(glob.glob(f"{tmp}/wavs/*.wav")[0])
    return ap.melspectrogram(wav)


def test_trained_melgan_asset_matches_jax(smoke_mel):
    """The trained asset's generator subtree (its discriminator and optimizer
    state are left out) through both packages' mel_to_wav, on one smoke
    mel: 1e-5 (float32)."""
    port = VocoderSynthesizer(MELGAN_CFG, MELGAN_CKPT, device="cpu")
    ref = np.asarray(JaxVocoder(MELGAN_CFG, MELGAN_CKPT).mel_to_wav(smoke_mel))
    got = port.mel_to_wav(smoke_mel)
    assert got.dtype == np.float32 and got.shape == ref.shape == (smoke_mel.shape[1] * 64,)
    assert np.abs(got).max() > 1e-2                     # trained weights make a signal
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_melgan_checkpoint_loads_strictly(tmp_path):
    """A generator subtree missing a leaf does not load."""
    from your_voice_tts_torch.train.checkpoint import load_generator

    with np.load(MELGAN_CKPT) as z:
        blobs = {k: z[k] for k in z.files if not k.endswith("['conv_out']['b']")}
    np.savez(tmp_path / "cut.npz", **blobs)
    port = VocoderSynthesizer(MELGAN_CFG, device="cpu")
    with pytest.raises(RuntimeError, match="conv_out.bias"):
        load_generator(port.model, str(tmp_path / "cut.npz"))
